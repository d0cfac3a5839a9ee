"""Fixtures of the benchmark's tests. Run from the root of the repository:
``python -m pytest portbench/tests`` (on the card, ``-m cuda`` runs the
tests that need it)."""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Inputs under the test's own TMPDIR; the program's module globals
    that a run patches (the sink, the Timings hook) restored after."""
    from mpassit_tpu_torch.io import wrf_writer
    from mpassit_tpu_torch.run import pipeline

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    monkeypatch.setattr(wrf_writer, "NetCDF4File", wrf_writer.NetCDF4File)
    monkeypatch.setattr(pipeline, "run_pipeline", pipeline.run_pipeline)
    for k in ("MPASSIT_PLATFORM", "MPASSIT_ELL_KERNEL",
              "MPASSIT_GATHER_KERNEL"):
        monkeypatch.delenv(k, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skips without a CUDA device (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
