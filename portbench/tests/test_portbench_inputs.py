"""Where a run keeps the seed's inputs: in memory, not on disk."""

import os

import pytest
import torch

from portbench import run, spec
from portbench.tests.helpers import tiny_config


def test_inputs_stay_off_disk(tmp_path):
    """The seed's input pair lives in memory files that the namelist names
    by path: under TMPDIR a run leaves only its namelist and varlists, and
    closing the run frees the files."""
    r = run.Run("tiny", tiny_config(), spec.traffic("hourly_cold"), 2**40,
                0.0, False, torch.device("cpu"), str(tmp_path / "cache"))
    try:
        r.setup(warmup=False)
        with open(r.nml) as f:
            nml = f.read()
        assert nml.count("/proc/self/fd/") == 2
        on_disk = sum(os.path.getsize(os.path.join(d, n))
                      for d, _, names in os.walk(r.work) for n in names)
        assert on_disk < 10_000 < r.info["input_bytes_in_memory"]
        fds = list(r._fds)
    finally:
        r.close()
    for fd in fds:
        with pytest.raises(OSError):
            os.fstat(fd)
