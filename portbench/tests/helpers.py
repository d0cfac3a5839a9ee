"""Helpers of the benchmark's tests: a whole run of the harness at the
test size of ``data/tiny_lambert.json``, on the CPU (where the program
runs its kernels' plain versions) unless a device is given."""

from __future__ import annotations

import os

import torch

from portbench import check, run, spec

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = os.path.join(HERE, "data", "tiny_lambert.json")


def tiny_config() -> dict:
    return spec.load_json(TINY)


def tiny_run(tmp, mix=None, seconds=0.3, trace=False, device="cpu",
             seed=2**33 + 17, cfg=None):
    """Set-up, window and check of one run at the test size; returns
    (the Run, its compared numbers). The Run's inputs are deleted."""
    mix = mix or spec.traffic("hourly_cached")
    r = run.Run("tiny", cfg or tiny_config(), mix, seed, seconds, trace,
                torch.device(device), os.path.join(str(tmp), "cache"))
    try:
        r.setup()
        r.window(0.0)
        numbers = r.judge()
    finally:
        r.close()
    return r, numbers


def passes(numbers) -> bool:
    return check.verdict(numbers)
