"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: by the imports of every source
under portbench/, and by ``sys.modules`` after a whole run in a process
of its own."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from portbench import run, spec
from portbench.tests.helpers import tiny_config

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def _sources(base):
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module"):
            for a in node.args[:1]:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    yield a.value.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources(PKG)),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax(path):
    assert not set(_top_level_imports(path)) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(_sources(os.path.join(PKG,
                                                              "reference"))),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_reference_imports_nothing_of_the_program(path):
    mods = set(_top_level_imports(path))
    assert not mods & {"mpassit_tpu_torch", "mpassit_tpu", "torch"}, mods
    # importlib: ``grid.py`` loads a kind's file of ``targets/``, which
    # this test reads as it reads every other file here
    assert mods <= {"__future__", "math", "os", "datetime", "hashlib", "numpy",
                    "scipy", "importlib"}, mods


def test_run_loads_no_jax(tmp_path):
    """A whole run at the test size, in a fresh process: afterwards no
    module of jax, jaxlib, flax or mpassit_tpu is loaded."""
    code = (
        "import sys, torch\n"
        "from portbench import run\n"
        "from portbench.tests.helpers import tiny_run\n"
        f"r, n = tiny_run({str(tmp_path)!r}, seconds=0.1)\n"
        "print('FORBIDDEN', run.forbidden_modules())\n"
        "print('RAN', len(r.rcs))\n")
    env = dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout and "RAN" in out.stdout


def test_jax_loaded_by_a_metric_gives_no_result(tmp_path, monkeypatch,
                                                capsys):
    """A metric reader, run after the window and the check, that loads a
    module named ``jax``: the run exits 4 and prints no result."""
    stubs, metrics = tmp_path / "stubs", tmp_path / "metrics"
    stubs.mkdir()
    metrics.mkdir()
    (stubs / "jax.py").write_text("LOADED = True\n")
    (metrics / "loads_jax.py").write_text(
        "import jax\n\n\ndef read(ctx):\n    return 1.0\n")
    monkeypatch.syspath_prepend(str(stubs))
    monkeypatch.setattr(spec, "METRICS", str(metrics))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    bench = {"end_to_end": [{"name": "loads_jax", "unit": "s",
                             "better": "lower", "bound": 0.25,
                             "source": "host_clock"}], "per_layer": []}
    r = run.Run("tiny", tiny_config(), spec.traffic("hourly_cached"), 3,
                0.1, False, torch.device("cpu"), str(tmp_path / "cache"))
    try:
        rc = run.drive(r, bench, False)
    finally:
        sys.modules.pop("jax", None)
    out = capsys.readouterr()
    assert rc == 4
    assert out.out == ""
    assert "jax loaded in the process" in out.err


def test_prepare_makes_what_the_first_run_makes(tmp_path, monkeypatch):
    """``prepare`` makes the mesh, the grid file and the weight cache and
    leaves its marker; a run on the same cache makes none of them again;
    ``ensure_prepared`` starts no process once the marker is there."""
    from portbench import prepare
    from portbench.tests.helpers import tiny_run

    cache = tmp_path / "cache"
    marker = cache / "prepared" / "tiny.json"
    prepare.prepare("tiny", tiny_config(), spec.traffic("hourly_cached"), 9,
                    torch.device("cpu"), str(cache), str(marker))
    assert marker.exists()
    made = {p: p.stat().st_mtime_ns for p in cache.rglob("*")
            if p.is_file() and p != marker}
    assert any(p.suffix == ".npz" for p in made)
    assert any("weights" in p.parts for p in made)
    tiny_run(tmp_path, seed=10)
    assert {p: p.stat().st_mtime_ns for p in made} == made
    monkeypatch.setattr(run, "cache_root", lambda: str(cache))
    monkeypatch.setattr(run, "prepare_marker", lambda w: str(marker))
    monkeypatch.setattr(run.subprocess, "run", None)
    assert run.ensure_prepared("tiny", 1) == 0
