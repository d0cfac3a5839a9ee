"""The port's HDF5 reader (mpassit_tpu_torch/io/hdf5.py) on NetCDF4/HDF5
files it did not write, read with h5py blocked from import, as on a
machine without h5py.

- Files written at test time by h5py in each layout the reader parses
  (symbol-table groups, dense links and attributes in creation and in
  name order, v2 B-trees with internal nodes, fractal heaps with child
  indirect blocks, chunked data with deflate, shuffle and Fletcher32,
  edge chunks, chunks never written, big-endian, compact, libver
  "latest" contiguous, single-chunk and implicit indexes, vlen strings)
  and by netCDF-C through ctypes (tests/nc4_foreign.py; those cases skip
  where libnetcdf is absent): every dataset and attribute bit for bit
  h5py's read of the same file, with the same dtype, shape and order.
- The committed fixtures of tests/data/nc4_foreign/ against their
  manifest.
- What the reader still refuses, each refusal naming the structure.
- The CLI with h5py blocked on an MPAS mesh, diag and history written by
  netCDF-C, against the JAX package's run on the same files (h5py)."""

import copy
import json
import os
import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpassit_tpu.run.pipeline import run_pipeline as jax_run
from mpassit_tpu_torch.errors import FatalError
from mpassit_tpu_torch.io import hdf5, nc4
from mpassit_tpu_torch.run import pipeline as tpipe
from mpassit_tpu_torch.testing import describe_hdf5, digest

import nc4_foreign as nf
from test_pipeline import make_case
from test_torch_pipeline import _assert_results_close, _write_namelist

needs_netcdf_c = pytest.mark.skipif(
    nf.libnetcdf() is None, reason="system libnetcdf not present")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _js(d):
    return json.loads(json.dumps(d))


def _port_read(path, monkeypatch):
    """``describe_hdf5`` of the port's reader, h5py blocked."""
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "h5py", None)
        f = hdf5.open_file(path)
        try:
            return _js(describe_hdf5(f))
        finally:
            f.close()


def _assert_same_as_h5py(path, monkeypatch):
    with h5py.File(path, "r") as f:
        want = _js(describe_hdf5(f))
    got = _port_read(path, monkeypatch)
    assert [d["name"] for d in got["datasets"]] == \
        [d["name"] for d in want["datasets"]]
    assert got["attrs"] == want["attrs"]
    for g, w in zip(got["datasets"], want["datasets"]):
        assert g == w, g["name"]


# ---- files h5py writes -----------------------------------------------------

RNG = np.random.default_rng(5)


def _many(f, n_ds=20, n_attrs=20):
    for i in range(n_ds):
        f.create_dataset(f"x{(i * 7) % n_ds:04d}", data=np.arange(i + 1.0))
    for i in range(n_attrs):
        f.attrs[f"a{(n_attrs - i) * 13 % 997:04d}"] = (
            np.int32(i) if i % 3 else f"text {i}".encode())


def _deep(f):
    """600 links and 1500 attributes: v2 B-trees two levels deep."""
    _many(f, 600, 1500)


def _heap_rows(f):
    """4000 attributes of 320 bytes: a root indirect block whose rows past
    the largest direct block hold child indirect blocks."""
    for i in range(4000):
        f.attrs[f"big{i}"] = np.arange(40, dtype="f8") + i


def _chunked(f):
    f.create_dataset("plain", data=RNG.standard_normal((37, 23)),
                     chunks=(8, 5))
    f.create_dataset("gzip", data=RNG.standard_normal((37, 23))
                     .astype("f4"), chunks=(8, 5), compression="gzip",
                     shuffle=True)
    f.create_dataset("fletcher", data=RNG.integers(0, 100, 101)
                     .astype("i2"), chunks=(10,), fletcher32=True,
                     compression="gzip", shuffle=True)
    f.create_dataset("be", data=RNG.standard_normal(50).astype(">f8"))
    f.create_dataset("be_chunked", data=RNG.standard_normal(50)
                     .astype(">i4"), chunks=(7,), compression="gzip")
    part = f.create_dataset("partial", shape=(30, 30), dtype="f4",
                            chunks=(10, 10), fillvalue=-7.5)
    part[0:10, 0:5] = 1
    f.create_dataset("unwritten", shape=(0, 4), maxshape=(None, 4),
                     dtype="f4", chunks=(1, 4))
    # 3-byte elements: shuffle leaves the bytes past the last whole
    # element of a chunk as they are
    f.create_dataset("odd", data=np.frombuffer(RNG.bytes(3 * 17), "S3"),
                     chunks=(5,), shuffle=True)
    f.attrs["vlen"] = "hello"
    f.attrs["vlen_array"] = ["a", "bcd", ""]
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    ds = h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_INT32,
                         h5py.h5s.create_simple((4, 3)), dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(12, dtype="i4")
             .reshape(4, 3))


def _latest(f):
    """libver="latest": superblock 3, layout 4 (contiguous, a single
    chunk, the implicit index of a chunked dataset allocated early)."""
    f.create_dataset("contiguous", data=np.arange(12.0).reshape(3, 4))
    f.create_dataset("single", data=RNG.standard_normal((3, 4)),
                     chunks=(3, 4), compression="gzip")
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk((2, 2))
    dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    ds = h5py.h5d.create(f.id, b"implicit", h5py.h5t.NATIVE_DOUBLE,
                         h5py.h5s.create_simple((3, 5)), dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(15.0).reshape(3, 5))
    _many(f, 3, 12)


H5PY_LAYOUTS = {
    "default": (_many, {}),                    # symbol table, v1 headers
    "track_order": (_many, {"track_order": True}),   # dense, creation order
    "deep_track_order": (_deep, {"track_order": True}),
    "deep_name_order": (_deep, {"libver": ("v108", "latest")}),
    "heap_indirect_rows": (_heap_rows, {"track_order": True}),
    "chunked": (_chunked, {}),
    "chunked_track_order": (_chunked, {"track_order": True}),
    "latest": (_latest, {"libver": "latest"}),
}


@pytest.mark.parametrize("layout", list(H5PY_LAYOUTS))
def test_h5py_layouts_bit_for_bit(tmp_path, monkeypatch, layout):
    make, kw = H5PY_LAYOUTS[layout]
    path = str(tmp_path / f"{layout}.h5")
    with h5py.File(path, "w", **kw) as f:
        make(f)
    _assert_same_as_h5py(path, monkeypatch)


# ---- files netCDF-C writes -------------------------------------------------

def _ncc_minimal(path):
    with nf.NCWriter(path) as f:
        f.def_dim("n", 5)
        f.def_var("a", "f4", ("n",))
        f.def_var("b", "i4", ("n",))
        f.put_att("title", "two variables")
        f.put_att("scale", 2.5, var="a")
        f.enddef()
        f.put("a", np.arange(5, dtype="f4"))
        f.put("b", np.arange(5, dtype="i4") * 3)


def _ncc_theta(path):
    """MPAS's history layout: Time unlimited, so chunked under a v1
    B-tree; deflate 1 and shuffle; 40 global attributes."""
    n, nz = 2000, 7
    with nf.NCWriter(path) as f:
        f.def_dim("Time", None)
        f.def_dim("nCells", n)
        f.def_dim("nVertLevels", nz)
        f.def_var("theta", "f4", ("Time", "nCells", "nVertLevels"),
                  deflate=1, shuffle=True)
        nf._mpas_globals(f, {"config_dt": 20.0})
        f.enddef()
        f.put("theta", (300 + RNG.standard_normal((1, n, nz)))
              .astype("f4"))


def _ncc_many_attrs(path):
    """Hundreds of attributes, as MPAS's config_* are: v2 B-trees with
    internal nodes."""
    with nf.NCWriter(path) as f:
        f.def_dim("n", 3)
        f.def_var("v", "f8", ("n",))
        for i in range(700):
            f.put_att(f"config_{(i * 31) % 700:03d}",
                      f"v{i}" if i % 2 else float(i))
        for i in range(300):
            f.put_att(f"att{i}", np.int16(i), var="v")
        f.enddef()
        f.put("v", np.ones(3))


def _ncc_unwritten(path):
    """A record variable never written (no chunk index) and one whose
    last records leave chunks unwritten (the fill value)."""
    with nf.NCWriter(path) as f:
        f.def_dim("Time", None)
        f.def_dim("n", 40)
        f.def_var("never", "f4", ("Time", "n"))
        f.def_var("partial", "f8", ("Time", "n"), chunks=(1, 16),
                  fill=-1.5)
        f.enddef()
        f.put("partial", np.arange(20.0).reshape(1, 20), start=(2, 3))


H5_NCC = {"minimal": _ncc_minimal, "mpas_theta": _ncc_theta,
          "many_attributes": _ncc_many_attrs, "unwritten": _ncc_unwritten,
          "diag_fixture_layout": nf.make_diag_fixture}


@needs_netcdf_c
@pytest.mark.parametrize("layout", list(H5_NCC))
def test_netcdf_c_files_bit_for_bit(tmp_path, monkeypatch, layout):
    path = str(tmp_path / f"{layout}.nc")
    H5_NCC[layout](path)
    with open(path, "rb") as f:
        assert f.read(9)[8] == 2                 # superblock version 2
    _assert_same_as_h5py(path, monkeypatch)


@needs_netcdf_c
def test_netcdf_c_mpas_files_through_netcdf4file(tmp_path, monkeypatch):
    """The mesh, diag and history files of the end-to-end case, through
    ``NetCDF4File``'s reader API: the same dims (ids in order), variables,
    dims of each, attributes and values with and without h5py."""
    mesh, _, hist, diag = make_case(tmp_path, ncells=400)
    paths = nf.write_mpas_case(mesh, tmp_path, hist, diag)

    def inventory(path):
        with nc4.open_dataset(path) as f:
            return f, {
                "dims": [(d, f.dim_size(d)) for d in f.dim_names()],
                "globals": {k: np.asarray(f.get_attr(k)).tolist()
                            for k in f.global_attr_names()},
                "vars": {v: (f.var_dims(v), {
                    k: np.asarray(a).tolist()
                    for k, a in f.var_attrs(v).items()},
                    digest(f.read_var(v))) for v in f.var_names()}}

    for path in paths.values():
        f, want = inventory(path)
        assert not isinstance(f._f, hdf5._Reader)
        with monkeypatch.context() as mp:
            mp.setitem(sys.modules, "h5py", None)
            f, got = inventory(path)
            assert isinstance(f._f, hdf5._Reader)
        assert got == want
        assert got["dims"][0][0] == "Time"          # dim ids in order


# ---- the committed fixtures ------------------------------------------------

with open(os.path.join(nf.FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_fixture_matches_manifest(monkeypatch, name):
    """The port's reader, h5py blocked, gives the manifest (made from
    h5py's read when the fixtures were written)."""
    path = os.path.join(nf.FIXTURES, name)
    with open(path, "rb") as f:
        assert f.read(9)[8] == 2
    assert _port_read(path, monkeypatch) == MANIFEST["files"][name]


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_manifest_is_h5pys_read(name):
    with h5py.File(os.path.join(nf.FIXTURES, name), "r") as f:
        assert _js(describe_hdf5(f)) == MANIFEST["files"][name]


def test_fixtures_size():
    assert sum(os.path.getsize(os.path.join(nf.FIXTURES, n))
               for n in os.listdir(nf.FIXTURES)) <= 1 << 20


# ---- what the reader refuses -----------------------------------------------

def _extensible_array(path):
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(10.0), maxshape=(None,),
                         chunks=(3,))


def _v2_btree_index(path):
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.ones((4, 4)), maxshape=(None, None),
                         chunks=(2, 2))


def _scale_offset(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(100, dtype="i4"), chunks=(10,),
                         scaleoffset=0)


def _bad_heap_block(path):
    """Dense attributes whose fractal heap direct block lost a bit."""
    with h5py.File(path, "w", track_order=True) as f:
        for i in range(12):
            f.attrs[f"a{i}"] = np.int32(i)
    with open(path, "r+b") as fh:
        raw = fh.read()
        at = raw.index(b"FHDB") + 30
        fh.seek(at)
        fh.write(bytes([raw[at] ^ 1]))


@pytest.mark.parametrize("make,word", [
    (_extensible_array, "EXTENSIBLE ARRAY"),
    (_v2_btree_index, "CHUNK INDEX TYPE 5 .V2 B-TREE"),
    (_scale_offset, "FILTER 6 .SCALE-OFFSET"),
    (_bad_heap_block, "DIRECT BLOCK AT [0-9]+: CHECKSUM MISMATCH"),
])
def test_reader_names_what_it_refuses(tmp_path, make, word):
    path = str(tmp_path / "f.h5")
    make(path)
    with pytest.raises(FatalError, match=word):
        f = hdf5.open_file(path)
        try:
            for _, ds in f.items():
                ds[...]
        finally:
            f.close()


def test_fletcher32_matches_hdf5():
    """The checksum h5py stored behind a chunk, and the edge cases of
    the end-around-carry sums (empty, zeros, an odd byte, all ones)."""
    assert hdf5.fletcher32(b"") == 0
    assert hdf5.fletcher32(bytes(10)) == 0
    for data in (b"\x01", b"abcde", b"\xff" * 4096, RNG.bytes(1001)):
        s1 = s2 = 0
        for i in range(0, len(data), 2):
            w = data[i] << 8 | (data[i + 1] if i + 1 < len(data) else 0)
            s1 = (s1 + w) % 65535
            s2 = (s2 + s1) % 65535
        got = hdf5.fletcher32(data)
        assert got & 0xFFFF in ((s1, 65535) if s1 == 0 else (s1,))
        assert got >> 16 in ((s2, 65535) if s2 == 0 else (s2,))


# ---- the CLI on netCDF-C inputs, against the JAX package --------------------

@needs_netcdf_c
def test_cli_without_h5py_on_netcdf_c_inputs(tmp_path, monkeypatch):
    """``pipeline.main`` with h5py blocked on an MPAS mesh, diag and
    history written by netCDF-C (Time unlimited so chunked, deflate 1
    with shuffle, 45 global attributes, xtime char(Time, StrLen)):
    every RegridResult array within 1e-5 * max(1, max|ref|) of the JAX
    package's run on the same files, which reads them through h5py."""
    mesh, jcfg, hist, diag = make_case(tmp_path)
    paths = nf.write_mpas_case(mesh, tmp_path, hist, diag)
    jcfg.grid_file_input_grid = paths["grid"]
    jcfg.diag_file_input_grid = paths["diag"]
    jcfg.hist_file_input_grid = paths["hist"]
    cfg = copy.deepcopy(jcfg)
    ref = jax_run(jcfg, jnp.float32)
    arts = []
    run = tpipe.run_pipeline

    def observed(*a, **kw):
        arts.append(run(*a, **kw))
        return arts[-1]
    cfg.output_file = str(tmp_path / "out_port.nc")
    nml = tmp_path / "namelist.input"
    _write_namelist(cfg, nml)
    monkeypatch.setattr(tpipe, "run_pipeline", observed)
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setenv("MPASSIT_PLATFORM", "cpu")
    assert tpipe.main([str(nml)]) == 0
    _assert_results_close(arts[0].result, ref.result)
    with nc4.open_dataset(cfg.output_file) as f:
        assert isinstance(f._f, hdf5._Reader)
        assert f.has_var("T2") and f.has_var("U")
