"""Time the ELL apply kernels (packed_apply, packed_gather_apply) on random
operands at the smoke run's shapes, under each launch geometry.

    python mpassit_tpu_torch/tools/ell_probe.py [--root DIR] [--seed N]
        [--reps N] [--cases pack,edge1]

Cases (the shapes of chip_smoke.py's main path on the shipped CONUS
namelist, 34 x 57 tiles): ``pack`` is the packed bilinear+nearest+conserve
operator (W = 40, Cp = 1024, ranges 992/16/16 columns, K 3/1/4, the
(0, 55, 55) rotation window); ``edge1`` the EDGE1 restagger (W = 1096,
Cp = 128, K = 4). The gather kernel reads the same rows through chunk
starts, W8 = 8 * ceil(W / 8) (the mesh's chunked layout is wider:
W8 = 160 and 1320 in the smoke run). ``pack_norot`` and ``pack_k1`` are the pack without its window and with
one K = 1 method, ``pack_w160`` the pack over 160 rows. The loc values are uniform over the slab rows
and the gather's chunk starts uniform over the source, a worst case for
the caches next to the mesh's operators.

Each case prints one JSON line per kernel and geometry: the median time
by CUDA events over ``--reps`` launches after a warm-up, and whether the
output equals the plain version's bit for bit. The geometries are
ell_plan's own choice and, where the package has ``STAGE_MAX``, the
choice with staging turned off (``unstaged``, 64-column blocks), with
unstaged 128-column blocks (``unstaged_bw128``), with staged 256-column
blocks where they fit (``bw256``) and with staged 64-column blocks
(``bw64``). ``--root`` imports mpassit_tpu_torch from
another checkout (an older tree, to compare two versions in one call): the
wrappers' signatures are the same.
Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _operands(torch, rng, np, dev, nty, ntx, W, Cp, Ks, n_src):
    n_tiles = nty * ntx
    NC = -(-W // 8)
    W8 = 8 * NC

    def t(a):
        return torch.from_numpy(a).to(dev)

    src = t(rng.standard_normal((n_src + 8, Cp), dtype=np.float32))
    ch = t(rng.integers(0, n_src // 8 + 1, (n_tiles, NC)).astype(np.int32))
    rows = (ch.long()[:, :, None] * 8
            + torch.arange(8, device=dev)).reshape(n_tiles, W8)
    slab = src[rows]
    locs = [t(rng.integers(0, W8, (n_tiles, K, 1024)).astype(np.int32))
            for K in Ks]
    ws = [t(rng.random((n_tiles, K, 1024), dtype=np.float32)) for K in Ks]
    al = rng.uniform(-0.5, 0.5, (n_tiles, 32, 32))
    return (slab, src, ch, locs, ws, t(np.cos(al).astype(np.float32)),
            t(np.sin(al).astype(np.float32)), W8)


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


CASES = {
    # name: (nty, ntx, W, Cp, ranges, Ks, rotate, n_src)
    "pack": (34, 57, 40, 1024, ((0, 992), (992, 1008), (1008, 1024)),
             (3, 1, 4), ((0, 55, 55),), 655_362),
    "edge1": (34, 57, 1096, 128, ((0, 128),), (4,), (), 1060 * 1800),
    # the pack without its rotation window, and one method with K = 1:
    # what the window and the K-sum cost
    "pack_norot": (34, 57, 40, 1024, ((0, 992), (992, 1008), (1008, 1024)),
                   (3, 1, 4), (), 655_362),
    "pack_k1": (34, 57, 40, 1024, ((0, 1024),), (1,), (), 655_362),
    # the pack over 160 rows, the width of its chunked gather layout
    "pack_w160": (34, 57, 160, 1024, ((0, 992), (992, 1008), (1008, 1024)),
                  (3, 1, 4), ((0, 55, 55),), 655_362),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ell_probe: needs a CUDA device", file=sys.stderr)
        return 1
    from mpassit_tpu_torch.ops import gather_kernel as gk
    from mpassit_tpu_torch.ops import packed_kernel as pk


    dev = torch.device("cuda", 0)
    for m in (pk, gk):
        m.build()
        for line in m.BUILD_INFO["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {os.path.basename(m.SOURCE)}:", line.strip())
    stage_max = getattr(pk, "STAGE_MAX", None)
    rng = np.random.default_rng(args.seed)
    for name in args.cases.split(","):
        nty, ntx, W, Cp, ranges, Ks, rotate, n_src = CASES[name]
        slab, src, ch, locs, ws, cosa, sina, W8 = _operands(
            torch, rng, np, dev, nty, ntx, W, Cp, Ks, n_src)
        kw = dict(ranges=ranges, nty=nty, ntx=ntx, rotate=rotate,
                  cosa=cosa, sina=sina)
        calls = {
            "packed_apply": (lambda: pk.packed_apply(slab, locs, ws, **kw),
                             lambda: pk.packed_apply_plain(slab, locs, ws,
                                                           **kw), W8),
            "packed_gather_apply": (
                lambda: gk.packed_gather_apply(src, ch, locs, ws, W8=W8,
                                               **kw),
                lambda: gk.packed_gather_apply_plain(src, ch, locs, ws,
                                                     W8=W8, **kw), W8),
        }
        ref = None
        for kernel, (call, plain, rows) in calls.items():
            geoms = [("plan", {})]
            if stage_max is not None:
                geoms += [("unstaged", {"STAGE_MAX": 0}),
                          ("unstaged_bw128", {"STAGE_MAX": 0,
                                              "UNSTAGED_COLS": 128}),
                          ("bw256", {"BLOCK_COLS": (256, 128)}),
                          ("bw64", {"BLOCK_COLS": (64,)})]
            for geom, knobs in geoms:
                if stage_max is not None:
                    saved = {k: getattr(pk, k) for k in knobs}
                    for k, val in knobs.items():
                        setattr(pk, k, val)
                    plan = pk.ell_plan(nty * ntx, rows, Cp, ranges, rotate)
                    info = {"BW": plan.BW, "stage": plan.stage,
                            "smem": plan.smem,
                            "min_blocks": getattr(plan, "min_blocks", None)}
                else:
                    info = {}
                got = call()
                torch.cuda.synchronize()
                if ref is None:
                    ref = plain()
                    torch.cuda.synchronize()
                equal = bool(torch.equal(got, ref))
                del got
                ms = _time_ms(torch, call, args.reps)
                print(json.dumps({"case": name, "kernel": kernel,
                                  "geometry": geom, **info, "ms": ms,
                                  "equal_to_plain": equal, "root": root}),
                      flush=True)
                if stage_max is not None:
                    for k, val in saved.items():
                        setattr(pk, k, val)
        del slab, src, ch, locs, ws, ref
        torch.cuda.empty_cache()
    print(subprocess_smi(), flush=True)
    return 0


def subprocess_smi():
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
