"""The comparison that decides ``correct``.

Two numbers, each with its limit (``LIMITS``, set in ``PERF.md`` from the
readings of sound runs and of the control):

- ``rel_err``: over every hour of the window, every variable of the file,
  every level and every sampled point, the largest |program - reference|
  over the variable's scale (``reference/expected.Expect``);
- ``schema_faults``: variables missing, extra, of another shape or dtype,
  levels never written, fill values not where the file keeps them, a
  wrong ``Times``, writes the sink could not place, and hours whose run
  failed. It has to be 0.
"""

from __future__ import annotations

import numpy as np

#: rel_err's limit: above the largest of sound runs, below the control's
#: least (PERF.md, "What decides correct")
LIMITS = {"rel_err": 4.0e-6, "schema_faults": 0}
#: rel_err where nothing could be compared or a value is not finite (a
#: number JSON can carry)
NOTHING = 1e30


def compare(expect: dict, hours: list, rcs: list) -> dict:
    """{"rel_err", "schema_faults", "worst": [(err, var) ...], "faults":
    [...]} of the recorded ``hours`` against ``expect``. ``rcs`` are the
    exit codes of every hour run, whether or not it reached the writer
    (the sink records an hour when the writer opens its file)."""
    faults = [f"hour {k}: the run exited with {rc}"
              for k, rc in enumerate(rcs) if rc != 0]
    worst = {}
    if not hours:
        faults.append("no hour finished in the window")
    elif len(hours) != len(rcs):
        faults.append(f"{len(rcs)} hours ran, {len(hours)} reached the "
                      "writer")
    for h, hour in enumerate(hours):
        faults += [f"hour {h}: {f}" for f in hour["faults"]]
        got = hour["vars"]
        for name in sorted(set(got) - set(expect)):
            faults.append(f"hour {h}: {name} is not in the file")
        for name, ex in expect.items():
            var = got.get(name)
            if var is None:
                faults.append(f"hour {h}: {name} missing")
                continue
            if name == "Times":
                s = b"".join(np.asarray(var["values"]).reshape(-1)).decode(
                    "ascii", "replace")
                if s != ex:
                    faults.append(f"hour {h}: Times {s!r} != {ex!r}")
                continue
            if not var["levels"].all():
                faults.append(f"hour {h}: {name} levels "
                              f"{np.nonzero(~var['levels'])[0].tolist()} "
                              "never written")
                continue
            vals = np.asarray(var["values"], np.float64)
            if var["where"] != (None if ex.where == "whole" else ex.where):
                faults.append(f"hour {h}: {name} on {var['where']} points")
                continue
            want = ex.values
            if ex.where == "whole":
                vals = vals.reshape(-1)
                want = want.reshape(-1)
            if vals.shape != want.shape:
                faults.append(f"hour {h}: {name} shape {vals.shape} != "
                              f"{want.shape}")
                continue
            if var["dtype"].kind not in "fi":
                faults.append(f"hour {h}: {name} dtype {var['dtype']}")
                continue
            if ex.fill is not None:
                bad = ex.fill & (vals != np.float32(want))
                if bad.any():
                    faults.append(f"hour {h}: {name} fill values differ at "
                                  f"{int(bad.sum())} points")
                live = ~ex.fill
                vals, want = vals[live], want[live]
            err = (float(np.abs(vals - want).max()) / ex.scale
                   if vals.size else 0.0)
            if not np.isfinite(err):
                err = NOTHING
            worst[name] = max(worst.get(name, 0.0), err)
    ranked = sorted(((e, n) for n, e in worst.items()), reverse=True)
    return {"rel_err": ranked[0][0] if ranked else NOTHING,
            "schema_faults": len(faults), "worst": ranked[:5],
            "faults": faults[:20]}


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
