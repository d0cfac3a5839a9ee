"""Time the ELL-built one-hot kernels (ell_split_apply_v1, _v2 at CC 128
and 256) on random operands at the smoke run's shape and the
kernel-variants tool's.

    python mpassit_tpu_torch/tools/split_probe.py [--root DIR] [--seed N]
        [--reps N] [--cases smoke,w80] [--probe 0,1,2,3]

Cases (34 x 57 tiles, the shipped CONUS namelist's grid, Cp = 512, K = 3):
``smoke`` has W = 40, the slab width of the bilinear operator of
chip_smoke.py's 655,362-cell mesh; ``w80`` has W = 80, that of the
kernel-variants tool's 2.6M-cell problem. loc is uniform over the slab
rows with a third of the points' last entry a duplicate of their first and
a fifth of the entries w = 0 pads at row 0, as the tests build them.

Each case prints one JSON line per kernel: the median time by CUDA events
over ``--reps`` launches after a warm-up, the plan's tensor-core TFLOP/s,
the max difference from the plain v1 relative to max|plain|, whether the
output equals v1's bit for bit; then one line for torch.sparse.mm over a
CSR of the same loc/w (the library yardstick; f32 products, not
split_bf16) and one for the store-only write wall (ops/write_wall.py) at
the same output shape.
``--root`` imports mpassit_tpu_torch from another checkout (an older tree,
to compare two versions in one call): the wrappers' signatures are the
same. ``--probe`` times, after the kernels as they are (0), diagnostic
builds of csrc/ell_split_apply.cu (ELL_SPLIT_PROBE): 1 without the output
stores, 2 without the products, 3 without the slab loads; their outputs
are not the function and are not checked. Needs a CUDA device; exits 1
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CASES = {"smoke": (34, 57, 40, 512, 3), "w80": (34, 57, 80, 512, 3)}


def _operands(torch, np, rng, dev, n_tiles, W, Cp, K):
    loc = rng.integers(0, W, (n_tiles, K, 1024)).astype(np.int32)
    w = rng.random((n_tiles, K, 1024), dtype=np.float32)
    loc[:, -1, :1024 // 3] = loc[:, 0, :1024 // 3]
    pad = rng.random((n_tiles, K, 1024)) < 0.2
    loc[pad], w[pad] = 0, 0.0
    slab = rng.standard_normal((n_tiles, W, Cp), dtype=np.float32)
    return [torch.from_numpy(a).to(dev) for a in (loc, w, slab)]


def _time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    ts.sort()
    return ts[len(ts) // 2]


def _csr(torch, loc, w, W):
    """The operator as a (n_tiles * 1024, n_tiles * W) CSR matrix."""
    import warnings

    n_tiles = loc.shape[0]
    dev = loc.device
    r = (torch.arange(n_tiles, device=dev).view(-1, 1, 1) * 1024
         + torch.arange(1024, device=dev).view(1, 1, -1)).expand_as(loc)
    c = torch.arange(n_tiles, device=dev).view(-1, 1, 1) * W + loc.long()
    with warnings.catch_warnings():     # sparse CSR is "beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(
            torch.stack([r.reshape(-1), c.reshape(-1)]), w.reshape(-1),
            (n_tiles * 1024, n_tiles * W)).coalesce().to_sparse_csr()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--probe", default="0")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("split_probe: needs a CUDA device", file=sys.stderr)
        return 1
    from mpassit_tpu_torch.ops import _build
    from mpassit_tpu_torch.ops import variant_kernels as vk

    flags = list(_build.NVCC_FLAGS)
    for probe in map(int, args.probe.split(",")):
        _build.NVCC_FLAGS = flags + [f"-DELL_SPLIT_PROBE={probe}"] * (
            probe > 0)
        vk._lib = None
        vk.build()
        for line in vk.BUILD_INFO["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas ell_split_apply.cu:", line.strip(),
                      flush=True)
        _cases(args, vk, np, torch, root, probe)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    return 0


def _cases(args, vk, np, torch, root, probe):
    plan_of = getattr(vk, "ell_split_plan", None)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    for name in args.cases.split(","):
        nty, ntx, W, Cp, K = CASES[name]
        loc, w, slab = _operands(torch, np, rng, dev, nty * ntx, W, Cp, K)
        nt = dict(nty=nty, ntx=ntx)
        ref = vk.ell_split_apply_v1_plain(loc, w, slab, **nt)
        scale = float(ref.abs().max())
        calls = {"v1": lambda: vk.ell_split_apply_v1(loc, w, slab, **nt)}
        for cc in vk.V2_CC:
            calls[f"v2_cc{cc}"] = (lambda cc=cc: vk.ell_split_apply_v2(
                loc, w, slab, CC=cc, **nt))
        v1 = None
        for kernel, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            v1 = got if v1 is None else v1
            rec = {"case": name, "kernel": kernel, "probe": probe,
                   "W": W, "K": K, "Cp": Cp,
                   "max_rel_err": float((got - ref).abs().max()) / scale,
                   "equal_to_v1": bool(torch.equal(got, v1)),
                   "ms": _time_ms(torch, call, args.reps), "root": root}
            if plan_of is not None:
                plan = plan_of(nty * ntx, W, Cp, K, kernel[:2],
                               int(kernel[5:]) if "cc" in kernel else 128)
                rec.update(smem=plan.smem, grid=plan.grid,
                           tflops=plan.flop / rec["ms"] / 1e9)
            print(json.dumps(rec), flush=True)
            if got is not v1:
                del got
        del v1, ref
        if probe == 0:
            from mpassit_tpu_torch.ops.write_wall import write_wall

            A = _csr(torch, loc, w, W)
            B = slab.view(-1, Cp)
            row = slab[:1, :1]
            for kernel, fn in (
                    ("torch.sparse.mm", lambda: torch.sparse.mm(A, B)),
                    ("write_wall", lambda: write_wall(row, **nt))):
                print(json.dumps({"case": name, "kernel": kernel,
                                  "ms": _time_ms(torch, fn, args.reps)}),
                      flush=True)
            del A, B
        del loc, w, slab
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
