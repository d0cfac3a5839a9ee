"""Compare an output NetCDF of the port against a REAL MPASSIT output file,
var for var — the one-command parity check for when an output of the
Fortran/ESMF reference becomes available (see DESIGN.md "Parity-risk
register").

Usage:
    python -m mpassit_tpu_torch.tools.diff_against_reference \
        REFERENCE.nc OURS.nc [--rtol 1e-5] [--atol 1e-4] [--skip VAR ...]
        [--json out.json] [--mask-unmapped]

Counterpart of ``tools/diff_against_reference.py``, with its flags, report
and exit codes; it reads both files through the port's ``open_dataset``
(NetCDF4 through h5py where it is importable, else through the port's own
HDF5 reader, ``io/hdf5.py``; classic CDF-1/2/5 through the port's
parser), so it runs where h5py is not installed. Without h5py it reads the
NetCDF4 files netCDF-C writes, as the Fortran MPASSIT writes its output
(``nf90_create(NF90_NETCDF4)``): superblock 2, dense links and
attributes (fractal heaps, v2 B-trees), chunked data under a v1 B-tree
through deflate, shuffle and Fletcher32; and what h5py writes by default
(symbol-table groups, v1 object headers). It refuses, naming them, layout
4's fixed-array, extensible-array and v2-B-tree chunk indexes and any
other filter.

Exit code 0 when every shared variable agrees within tolerance; 1
otherwise. Variables listed in KNOWN_DEVIATIONS are compared but reported
separately (see the register): disagreements there are bounded and
documented, not bugs.

The reference writes unmapped target points as whatever garbage the
uninitialized ESMF field held (quirk Q5, unmappedaction=IGNORE,
the reference's interp.F90:127); we write zeros. --mask-unmapped treats
points where OURS == 0 AND REF != 0 beyond tolerance as potentially
unmapped and reports them in a separate count instead of failing, with the
caveat printed loudly.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# Deviations with documented, test-pinned bounds (DESIGN.md register).
KNOWN_DEVIATIONS = {
    "U": "restagger boundary SLACK clip (register row R3)",
    "V": "restagger boundary SLACK clip (register row R3)",
    "SNOW": "conservative boundary fracarea cells (register row R4)",
    "SNOWH": "conservative boundary fracarea cells (register row R4)",
    "MAPFAC_M": "lat-lon target mapfac=1 (register row R5; LC/PS/Merc exact)",
    "MAPFAC_U": "lat-lon target mapfac=1 (register row R5)",
    "MAPFAC_V": "lat-lon target mapfac=1 (register row R5)",
}


def compare(ref_path, ours_path, rtol, atol, skip, mask_unmapped):
    from ..io.nc4 import open_dataset

    report = {"match": [], "deviation": [], "fail": [], "missing": [],
              "extra": [], "unmapped_suspect": {}}
    with open_dataset(ref_path) as fr, open_dataset(ours_path) as fo:
        rv, ov = set(fr.var_names()), set(fo.var_names())
        report["missing"] = sorted(rv - ov)
        report["extra"] = sorted(ov - rv)
        for name in sorted(rv & ov):
            if name in skip:
                continue
            a = fr.read_var(name)
            b = fo.read_var(name)
            if a.shape != b.shape:
                report["fail"].append(
                    {"var": name, "why": f"shape {b.shape} != {a.shape}"})
                continue
            if a.dtype.kind not in "fc":
                ok = bool((a == b).all())
                (report["match"] if ok else report["fail"]).append(
                    {"var": name, "why": "exact" if ok else "integer/char "
                     "mismatch"})
                continue
            a64, b64 = a.astype(np.float64), b.astype(np.float64)
            bad = ~np.isclose(b64, a64, rtol=rtol, atol=atol)
            if mask_unmapped:
                suspect = bad & (b64 == 0.0)
                n_sus = int(suspect.sum())
                if n_sus:
                    report["unmapped_suspect"][name] = n_sus
                bad &= ~suspect
            n_bad = int(bad.sum())
            entry = {
                "var": name,
                "n_bad": n_bad,
                "n_total": int(a64.size),
                "max_abs": float(np.abs(b64 - a64).max()),
                "max_rel": float((np.abs(b64 - a64)
                                  / (np.abs(a64) + atol)).max()),
            }
            if n_bad == 0:
                report["match"].append(entry)
            elif name in KNOWN_DEVIATIONS:
                entry["register"] = KNOWN_DEVIATIONS[name]
                report["deviation"].append(entry)
            else:
                report["fail"].append(entry)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("reference")
    ap.add_argument("ours")
    ap.add_argument("--rtol", type=float, default=1e-5)
    ap.add_argument("--atol", type=float, default=1e-4)
    ap.add_argument("--skip", nargs="*", default=["Times"])
    ap.add_argument("--mask-unmapped", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    rep = compare(args.reference, args.ours, args.rtol, args.atol,
                  set(args.skip), args.mask_unmapped)
    print(f"match:     {len(rep['match'])} vars")
    for e in rep["deviation"]:
        print(f"DEVIATION  {e['var']}: {e['n_bad']}/{e['n_total']} pts, "
              f"max_abs={e['max_abs']:.3g} — {e['register']}")
    for e in rep["fail"]:
        why = e.get("why") or (f"{e['n_bad']}/{e['n_total']} pts, "
                               f"max_abs={e['max_abs']:.3g} "
                               f"max_rel={e['max_rel']:.3g}")
        print(f"FAIL       {e['var']}: {why}")
    if rep["missing"]:
        print(f"missing from ours: {rep['missing']}")
    if rep["extra"]:
        print(f"extra in ours:     {rep['extra']}")
    if rep["unmapped_suspect"]:
        print("unmapped-suspect points (ours==0, ref!=0 — quirk Q5 garbage "
              f"in the reference is EXPECTED there): {rep['unmapped_suspect']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=1)
    return 1 if (rep["fail"] or rep["missing"]) else 0


if __name__ == "__main__":
    sys.exit(main())
