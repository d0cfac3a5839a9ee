"""The readings that ``check.LIMITS`` is set from, for one cell, in one
process: the program on each of ``--seeds`` and the control on each of
``--control-seeds``, one hour each at the cell's own sizes.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,...
        --control-seeds 7,8,9

The control is the program's own lower-precision path: the one-hot route
(``MPASSIT_ELL_KERNEL=0``) with ``apply_precision = "split_bf16"``. For each
program seed the same outputs rounded to bfloat16 are read too. One JSON
line per reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import sys

import numpy as np

from . import check, run, spec

CONTROL = {"namelist": {"apply_precision": "split_bf16"},
           "env": {"MPASSIT_ELL_KERNEL": "0"}}


def control_mix(mix: dict) -> dict:
    m = copy.deepcopy(mix)
    for k, v in CONTROL.items():
        m[k] = dict(m.get(k, {}), **v)
    return m


def bf16_reading(r: run.Run) -> float:
    """rel_err of the run's outputs rounded to bfloat16."""
    import torch

    hours = copy.deepcopy(r.recorder.hours)
    for hour in hours:
        for var in hour["vars"].values():
            if var["values"].dtype == np.float32:
                var["values"] = torch.from_numpy(var["values"]).to(
                    torch.bfloat16).float().numpy()
    return check.compare(r.ref.expected(r.points), hours, r.rcs)["rel_err"]


def reading(w: dict, mix: dict, seed: int, side: str, device) -> dict:
    r = run.Run(w["name"], spec.config(w["config"]), mix, seed, 0.0, False,
                device, run.cache_root(), w["chips"])
    try:
        r.setup(warmup=False)
        r.window(0.0)
        n = r.judge()
        out = {"side": side, "seed": seed, "rel_err": n["rel_err"],
               "schema_faults": n["schema_faults"],
               "worst": [[e, v] for e, v in n["worst"][:3]],
               "faults": n["faults"][:3], "hour_s": r.hours[0]["wall_s"],
               "check_s": r.info["check_s"]}
        if side == "program":
            out["bf16_rounded"] = bf16_reading(r)
        return out
    finally:
        r.close()
        gc.collect()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    w = spec.cell(spec.benchmark(), args.workload)
    mix = spec.traffic(w["traffic"])
    dev = torch.device("cuda", 0)
    plan = ([(int(s), "program", mix) for s in args.seeds.split(",") if s]
            + [(int(s), "control", control_mix(mix))
               for s in args.control_seeds.split(",") if s])
    for seed, side, m in plan:
        print(json.dumps(reading(w, m, seed, side, dev), default=float),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
