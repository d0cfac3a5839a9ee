"""What only a cell's first run in a checkout makes, made in a process of
its own:

    python3 -m portbench.prepare --workload <cell> --seed <n>

``run.py`` starts it, and waits for it, before its own set-up when the
cell's marker (``.portbench_cache/prepared/<cell>.json``) is missing. It
does a run's set-up with its warm-up hour and nothing else: the mesh and
the grid file (``.portbench_cache/mesh``), the weight cache of a mix that
keeps one, and the program's kernel builds. Its inputs are freed after.
The run that started it then makes none of these, so its peak resident
memory comes from its own hours, which are like the window's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import run, spec


def prepare(workload: str, cfg: dict, mix: dict, seed: int, device,
            cache: str, marker: str) -> None:
    r = run.Run(workload, cfg, mix, seed, 0.0, False, device, cache)
    try:
        r.setup()
    finally:
        r.close()
    os.makedirs(os.path.dirname(marker), exist_ok=True)
    with open(marker + ".tmp", "w") as f:
        json.dump({"workload": workload, "config": cfg["name"]}, f)
    os.replace(marker + ".tmp", marker)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("prepare: needs a CUDA device", file=sys.stderr)
        return 3
    w = spec.cell(spec.benchmark(), args.workload)
    prepare(args.workload, spec.config(w["config"]), spec.traffic(
        w["traffic"]), args.seed, torch.device("cuda", 0), run.cache_root(),
        run.prepare_marker(args.workload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
