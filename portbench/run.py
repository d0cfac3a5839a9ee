"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration and a traffic mix. Set-up makes the configuration's mesh and
its grid file once (kept in ``.portbench_cache/`` in the checkout), the
seed's diag and history files (in memory, ``inputs.memory_file``: a run
writes nothing of them to disk), the namelist (under ``TMPDIR``), and
installs the output sink (``sink.py``); then it runs one
warm-up hour. The window drives the program's CLI entry,
``mpassit_tpu_torch.run.pipeline.main([namelist])``, one forecast hour
after another in this process, on the same input pair, and ends with the
first hour that finishes at or after ``--seconds`` of the hours' own wall
clock; between hours, outside that clock, the harness collects the
previous hour's garbage, as a new process per hour would start clean.
With ``--trace 1`` torch.profiler records the window, and the per-layer
metrics are read from it. Then the window's outputs are compared with the
reference (``check.py``), and the last line of standard output is the
result.

What only a cell's first run in a checkout makes (the mesh, the grid
file, the weight cache of a mix that keeps one, the kernel builds) is made
before set-up by ``prepare.py``, in a process of its own, so that this
process's peak resident memory comes from hours like the window's.

Exit codes: 0 with a result; 2 bad arguments; 3 no CUDA device, or fewer
than the cell asks for; 4 jax, jaxlib, flax or the JAX package loaded in
this process after the window, the check or the metrics; 1 anything
else. Only exit 0 prints a result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from . import check, inputs, problem, spec  # noqa: E402
from .reference.expected import Reference, samples  # noqa: E402
from .trace import Trace, load_events  # noqa: E402

#: HBM bandwidth of one NVIDIA H100 SXM (data sheet), bytes/s
PEAK_BYTES_S = 3.35e12
#: the points compared each hour
N_MASS, N_STAG = 4096, 1024
FORBIDDEN = ("jax", "jaxlib", "flax", "mpassit_tpu")
HOUR_SPAN = "portbench.hour"


def cache_root() -> str:
    return os.path.join(spec.ROOT, ".portbench_cache")


def _nml_value(v) -> str:
    if isinstance(v, bool):
        return ".true." if v else ".false."
    if isinstance(v, str):
        return f'"{v}"'
    return repr(v)


def namelist_text(keys: dict) -> str:
    return ("&config\n" + "".join(f" {k} = {_nml_value(v)}\n"
                                  for k, v in keys.items()) + "/\n")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _peak_rss() -> int:
    """The process's peak resident memory in bytes (``ru_maxrss``, which
    Linux gives in KiB). Children are not counted."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _usage() -> tuple:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return time.perf_counter(), ru.ru_utime, ru.ru_stime


def _usage_delta(a: tuple, b: tuple) -> dict:
    """An hour's wall, user CPU and system CPU seconds (the look at slow
    runs: the same work, and more CPU seconds for it, in a slow one)."""
    return {k: y - x for k, x, y in zip(("wall_s", "utime_s", "stime_s"),
                                        a, b)}


class Run:
    """One run: ``setup``, ``window``, ``judge``, then ``metrics``.
    ``device`` is the torch device the program runs on (the CPU only in
    the tests); ``cache`` the directory of the benchmark's caches
    (``.portbench_cache`` in the checkout)."""

    def __init__(self, workload: str, cfg: dict, mix: dict, seed: int,
                 seconds: float, trace: bool, device, cache: str,
                 chips: int = 1):
        self.workload, self.cfg, self.mix = workload, cfg, mix
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.chips = device, chips
        self.mesh_cache = os.path.join(cache, "mesh")
        self.cache = os.path.join(cache, cfg["name"])
        self.work = None
        self._fds = []
        self._restore = []
        self.hours, self.rcs = [], []
        self.info = {}

    # -- set-up -----------------------------------------------------------
    def setup(self, warmup: bool = True):
        import torch

        from mpassit_tpu_torch.io import wrf_writer
        from mpassit_tpu_torch.run import pipeline

        from . import sink

        cfg, mix = self.cfg, self.mix
        m = cfg["mesh"]
        self.mesh = inputs.cached_mesh(self.mesh_cache, m)
        grid_file = inputs.cached_grid_file(self.mesh_cache, m, self.mesh)
        self.work = tempfile.mkdtemp(prefix="portbench-")
        varlists = {k: [list(p) for p in v]
                    for k, v in cfg["varlists"].items()}
        for k, extra in mix.get("varlist_extra", {}).items():
            varlists[k] = varlists[k] + [list(p) for p in extra]
        self.cfg = cfg = dict(cfg, varlists=varlists)
        self.fields = inputs.make_fields(varlists, m["nz"], m["nsoil"],
                                         self.seed)
        written, data = 0, {}
        for name, fl, diag in (("diag", self.fields[0], True),
                               ("hist", self.fields[1], False)):
            fd, data[name] = inputs.memory_file(name + ".nc")
            self._fds.append(fd)
            written += inputs.write_data_file(
                data[name], self.mesh, m["nz"], fl,
                inputs.file_attrs(cfg["inputs"], diag),
                cfg["inputs"]["valid_time"])
        self.info["input_bytes_in_memory"] = written
        parm = os.path.join(self.work, "parm")
        os.makedirs(parm)
        for k, pairs in varlists.items():
            with open(os.path.join(parm, k), "w") as f:
                f.write("".join(f"{a} {b}\n" for a, b in pairs))
        wcache = ""
        if mix["weights_cache"] == "checkout":
            wcache = os.path.join(self.cache, "weights")
        keys = {"grid_file_input_grid": grid_file,
                "diag_file_input_grid": data["diag"],
                "hist_file_input_grid": data["hist"],
                "output_file": os.path.join(self.work, "mpassit_out.nc"),
                **cfg["namelist"], "varlist_dir": parm,
                "weights_cache_dir": wcache, **mix.get("namelist", {})}
        self.nml = os.path.join(self.work, "namelist.input")
        with open(self.nml, "w") as f:
            f.write(namelist_text(keys))
        self._set_env({"MPASSIT_PLATFORM": self.device.type,
                       **mix.get("env", {})})

        jm = cfg["namelist"]["ny"] - 1, cfg["namelist"]["nx"] - 1
        self.points = samples(self.seed, jm[0], jm[1], N_MASS, N_STAG)
        self.recorder = sink.Recorder(self.points)
        run, nc4 = pipeline.run_pipeline, wrf_writer.NetCDF4File

        def unpatch():
            pipeline.run_pipeline = run
            wrf_writer.NetCDF4File = nc4
        self._restore.append(unpatch)
        sink.install(wrf_writer, self.recorder)
        self.timings = []

        def observed(c, device, dtype=None):
            art = run(c, device, dtype)
            self.timings.append((dict(art.timings.stages),
                                 dict(art.timings.counts)))
            return art
        pipeline.run_pipeline = observed
        self.pipeline, self.torch = pipeline, torch

        self.info["peak_host_before_warmup"] = _peak_rss()
        if warmup:
            rc = self._hour()
            if rc != 0:
                raise RuntimeError(f"the warm-up hour exited with {rc}")
            self.recorder.hours.clear()
            self.timings.clear()
            self._collect()

    def _set_env(self, env: dict):
        old = {k: os.environ.get(k) for k in env}

        def restore():
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        self._restore.append(restore)
        os.environ.update(env)

    def _hour(self) -> int:
        with self.torch.profiler.record_function(HOUR_SPAN):
            return self.pipeline.main([self.nml])

    def _collect(self):
        """Collect the last hour's garbage, outside any hour's clock and
        span, and keep the seconds it took."""
        t = time.perf_counter()
        gc.collect()
        self.info.setdefault("gc_s", []).append(time.perf_counter() - t)

    # -- the window -------------------------------------------------------
    def window(self, t_start_process: float):
        torch = self.torch
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        prof = None
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if cuda:
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        self.setup_s = time.perf_counter() - t_start_process
        walls, usage = [], []
        while True:
            if walls:
                self._collect()
            a = _usage()
            self.rcs.append(self._hour())
            b = _usage()
            walls.append(b[0] - a[0])
            usage.append(_usage_delta(a, b))
            if sum(walls) >= self.seconds:
                break
        self.window_s = sum(walls)
        self.info["hour_usage"] = usage
        # the process's peak: its set-up holds less than an hour does
        # (``peak_host_before_warmup``), and its warm-up hour is an hour
        # like the window's
        self.peak_host = _peak_rss()
        self.peak_device = (torch.cuda.max_memory_allocated()
                            if cuda else 0)
        self.hours = [{"wall_s": w, "stages": s, "counts": c}
                      for w, (s, c) in zip(walls, self.timings)]
        self.tr = None
        if prof is not None:
            prof.__exit__(None, None, None)
            path = os.path.join(self.work, "trace.json")
            prof.export_chrome_trace(path)
            self.info["trace_bytes"] = os.path.getsize(path)
            events = load_events(path)
            os.unlink(path)
            hours = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e.get("ph") == "X"
                     and e.get("name") == HOUR_SPAN]
            self.tr = Trace(events, hours)
            del events, prof

    # -- correct ----------------------------------------------------------
    def judge(self) -> dict:
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()
        t = time.perf_counter()
        self.ref = Reference(self.cfg, self.mesh, self.fields, self.cache)
        expect = self.ref.expected(self.points)
        numbers = check.compare(expect, self.recorder.hours, self.rcs)
        self.info["check_s"] = time.perf_counter() - t
        return numbers

    # -- metrics ------------------------------------------------------------
    def context(self) -> dict:
        """What the metric readers are given. ``stage_mean(names)`` and
        ``count_mean(names)``: over the window's hours, the mean of the
        seconds of the program's spans, or of its counters, of those names
        summed; None where an hour records none of them."""
        g = self.ref.grid
        mesh = self.mesh
        cached = {}

        def apply_bytes():
            if "b" not in cached:
                nnz = self.conserve_nnz()
                cached["b"] = problem.apply_bytes(
                    self.cfg, g, len(mesh["lat_cell"]),
                    len(mesh["lat_vertex"]), nnz)
            return cached["b"]

        def mean_of(key):
            def mean(names):
                hs = self.hours
                if not hs or not all(any(n in h[key] for n in names)
                                     for h in hs):
                    return None
                return sum(sum(h[key].get(n, 0) for n in names)
                           for h in hs) / len(hs)
            return mean

        return {"hours": self.hours, "window_s": self.window_s,
                "setup_s": self.setup_s, "peak_host_bytes": self.peak_host,
                "peak_device_bytes": self.peak_device, "trace": self.tr,
                "fetch_bytes": problem.fetch_bytes(self.cfg, g.ny, g.nx),
                "apply_bytes": apply_bytes, "peak_bytes_s": PEAK_BYTES_S,
                "stage_mean": mean_of("stages"),
                "count_mean": mean_of("counts")}

    def conserve_nnz(self) -> int:
        """The reference's count of (target cell, source cell) overlaps
        over the whole grid, kept in the cache directory."""
        path = os.path.join(self.cache, "conserve_overlaps.json")
        g = self.ref.grid
        key = g.cache_key("overlaps")
        if os.path.exists(path):
            with open(path) as f:
                got = json.load(f)
            if got.get("key") == key:
                return got["overlaps"]
        import numpy as np

        n = 0
        rows = np.arange(g.ny)
        step = max(1, 200_000 // g.nx)
        for lo in range(0, g.ny, step):
            jj, ii = np.meshgrid(rows[lo:lo + step], np.arange(g.nx),
                                 indexing="ij")
            pt, _, _ = self.ref.conservative_at(jj.reshape(-1),
                                                ii.reshape(-1))
            n += len(pt)
        with open(path + ".tmp", "w") as f:
            json.dump({"key": key, "overlaps": n}, f)
        os.replace(path + ".tmp", path)
        return n

    def metrics(self, bench: dict, kind: str) -> dict:
        ctx = self.context()
        out = {}
        for m in spec.metrics_of(bench, self.workload, kind):
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out

    def close(self):
        """Free the inputs, delete the work directory; put back what
        ``setup`` changed in the program's modules and the environment."""
        while self._fds:
            os.close(self._fds.pop())
        if self.work:
            shutil.rmtree(self.work, ignore_errors=True)
            self.work = None
        while self._restore:
            self._restore.pop()()


def result_line(run: Run, numbers: dict, metrics: dict) -> dict:
    torch = run.torch
    failed = sum(1 for rc in run.rcs if rc != 0)
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(0)
                       if run.device.type == "cuda" else "cpu"),
              "count": run.chips, "memory_peak_bytes": run.peak_device}
    line = {"correct": check.verdict(numbers), "attempted": len(run.rcs),
            "failed": failed, "metrics": metrics, "device": device}
    if run.tr is not None:
        device["busy_s"] = run.tr.busy_s()
        device["window_s"] = run.tr.window_s()
        line["breakdown"] = run.tr.breakdown()
    line["compared"] = {k: {"value": numbers[k], "limit": lim}
                        for k, lim in check.LIMITS.items()}
    return line


def _forbidden_exit() -> bool:
    bad = forbidden_modules()
    if bad:
        print(f"portbench: {', '.join(bad)} loaded in the process",
              file=sys.stderr)
    return bool(bad)


def prepare_marker(workload: str) -> str:
    return os.path.join(cache_root(), "prepared", workload + ".json")


def ensure_prepared(workload: str, seed: int) -> int:
    """Make, in a process of its own (``prepare.py``), what only the
    cell's first run in this checkout makes; 0 once it is made."""
    if os.path.exists(prepare_marker(workload)):
        return 0
    return subprocess.run(
        [sys.executable, "-m", "portbench.prepare", "--workload", workload,
         "--seed", str(seed)], cwd=spec.ROOT, stdin=subprocess.DEVNULL,
        stdout=sys.stderr).returncode


def drive(run: Run, bench: dict, trace: bool) -> int:
    """Set-up, window, check and metrics of ``run``; prints the result
    line and returns 0, or returns 4 without a result where jax, jaxlib,
    flax or the JAX package is loaded after the window."""
    try:
        run.setup()
        run.window(_T0)
        if _forbidden_exit():
            return 4
        numbers = run.judge()
        kind = "per_layer" if trace else "end_to_end"
        metrics = run.metrics(bench, kind)
        line = result_line(run, numbers, metrics)
    finally:
        run.close()
    if _forbidden_exit():
        return 4
    info = dict(run.info, hours=[h["wall_s"] for h in run.hours],
                stages=[h["stages"] for h in run.hours],
                counts=[h["counts"] for h in run.hours],
                worst=numbers["worst"], faults=numbers["faults"])
    print("portbench: " + json.dumps(info, default=str), file=sys.stderr)
    for k, lim in check.LIMITS.items():
        print(f"compared {k} {numbers[k]!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    w = spec.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"portbench: the cell needs {w['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    rc = ensure_prepared(args.workload, args.seed)
    if rc != 0:
        print(f"portbench: preparing the cell exited with {rc}",
              file=sys.stderr)
        return 1
    run = Run(args.workload, spec.config(w["config"]), spec.traffic(
        w["traffic"]), args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), cache_root(), w["chips"])
    return drive(run, bench, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
