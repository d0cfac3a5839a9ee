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
import struct
import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpassit_tpu.run.pipeline import run_pipeline as jax_run
from mpassit_tpu_torch.errors import FatalError
from mpassit_tpu_torch.io import h5filters, hdf5, nc4
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


def _smooth(shape, dtype="f4"):
    """A field with the spatial correlation of a model's: every szip
    option (zero blocks, second extension, split, uncompressed) codes it."""
    a = np.cumsum(RNG.standard_normal(shape), axis=-1) * 3 + 280
    return a.astype(dtype)


def _index_fixed_array(f, **filters):
    """libver "latest", fixed maximum dimensions: fixed-array indexes,
    with edge chunks, one past its 1024-element page (a page never
    written reads as the fill value) and one partly written."""
    f.create_dataset("edges", data=_smooth((37, 23)), chunks=(8, 5),
                     **filters)
    paged = f.create_dataset("paged", shape=(3000,), chunks=(1,),
                             dtype="i2", fillvalue=-5, **filters)
    paged[:500] = np.arange(500)
    paged[2900:] = 7
    part = f.create_dataset("partial", shape=(30, 30), dtype="f8",
                            chunks=(10, 10), fillvalue=-7.5, **filters)
    part[0:10, 0:5] = 1
    f.create_dataset("larger_max", data=np.arange(40.0), maxshape=(90,),
                     chunks=(7,), **filters)


def _index_extensible_array(f, **filters):
    """libver "latest", one unlimited dimension: extensible-array
    indexes, the unlimited axis first and in the middle, chunks never
    written, super blocks past the index block, and 150,000 chunks
    (super blocks of paged data blocks, pages never written)."""
    rec = f.create_dataset("records", shape=(50, 7, 9),
                           maxshape=(None, 7, 9), chunks=(2, 3, 4),
                           dtype="f4", **filters)
    rec[0:10] = _smooth((10, 7, 9))
    rec[40:44, 2:5] = RNG.standard_normal((4, 3, 9))
    mid = f.create_dataset("middle", shape=(6, 30, 5), maxshape=(6, None, 5),
                           chunks=(4, 3, 2), dtype="i4", fillvalue=-3,
                           **filters)
    mid[:, :20] = RNG.integers(0, 100, (6, 20, 5))
    many = f.create_dataset("paged", shape=(150_000,), maxshape=(None,),
                            chunks=(1,), dtype="u1", **filters)
    a = (np.arange(150_000) % 251).astype("u1")
    for lo, hi in ((0, 2000), (133_000, 135_000), (149_000, 150_000)):
        many[lo:hi] = a[lo:hi]
    f.create_dataset("never", shape=(0, 4), maxshape=(None, 4),
                     chunks=(1, 4), dtype="f4", **filters)


def _index_btree2(f, **filters):
    """libver "latest", two unlimited dimensions: v2 B-tree indexes of
    record type 10 (11 filtered), one deep enough for internal nodes."""
    f.create_dataset("deep", data=_smooth((40, 30), "f8"),
                     maxshape=(None, None), chunks=(3, 4), **filters)
    part = f.create_dataset("partial", shape=(20, 20), maxshape=(None, None),
                            chunks=(6, 6), dtype="i4", fillvalue=9,
                            **filters)
    part[:6, 6:] = 1


_GZIP = dict(compression="gzip", shuffle=True, fletcher32=True)


def _szip(f, mode):
    """szip in one mode (nn: preprocessed, ec: entropy coding only) on
    every pixel width HDF5 sets: 8, 16 (little- and big-endian) and 32
    and 64 bits as byte planes; blocks of 8 to 32 pixels; scanlines that
    are not a whole number of blocks (padded); a chunk of zeros."""
    kw = dict(compression="szip")
    f.create_dataset("f4", data=_smooth((45, 61)), chunks=(10, 20),
                     compression_opts=(mode, 8), **kw)
    f.create_dataset("f4_wide", data=_smooth((45, 61)), chunks=(10, 61),
                     compression_opts=(mode, 32), **kw)
    f.create_dataset("f8", data=_smooth((45, 61), "f8"), chunks=(45, 61),
                     compression_opts=(mode, 16), **kw)
    f.create_dataset("i2", data=RNG.integers(-3000, 3000, (50, 37))
                     .astype("i2"), chunks=(10, 37),
                     compression_opts=(mode, 32), **kw)
    f.create_dataset("i2_be", data=(np.arange(50 * 37).reshape(50, 37) % 97)
                     .astype(">i2"), chunks=(10, 37),
                     compression_opts=(mode, 8), **kw)
    f.create_dataset("u1", data=(np.arange(3000) % 7).astype("u1"),
                     chunks=(1000,), compression_opts=(mode, 8), **kw)
    f.create_dataset("zeros", data=np.zeros((64, 64), "f4"), chunks=(64, 64),
                     compression_opts=(mode, 8), **kw)
    # rows past 4096 pixels: scanlines of 128 blocks, the last one short
    for dt in ("f4", "i2"):
        f.create_dataset(f"long_rows_{dt}", data=_smooth((4, 5000), dt),
                         chunks=(2, 5000), compression_opts=(mode, 8), **kw)


def _lzf_layout(f):
    """LZF on a smooth field, and on random bytes it cannot shrink: the
    optional filter fails and HDF5 stores that chunk as it is, its bit
    set in the chunk's filter mask."""
    f.create_dataset("smooth", data=_smooth((45, 61)), chunks=(10, 20),
                     compression="lzf")
    ds = f.create_dataset("random", data=np.frombuffer(
        RNG.bytes(16000), "<f4").reshape(40, 100), chunks=(10, 100),
        compression="lzf", shuffle=True)
    assert any(ds.id.get_chunk_info(i).filter_mask
               for i in range(ds.id.get_num_chunks()))


def _scale_offset_layout(f):
    """Scale-offset: integers (minimum bits found per chunk, a fill value
    whose elements take the all-ones code) and floats by D-scale (f4 and
    f8, with and without a fill value)."""
    f.create_dataset("i4", data=RNG.integers(-500, 500, (40, 30))
                     .astype("i4"), chunks=(10, 30), scaleoffset=0)
    u2 = RNG.integers(0, 5000, (40, 30)).astype("u2")
    u2[::7] = 3
    f.create_dataset("u2_fill", data=u2, chunks=(10, 30), scaleoffset=0,
                     fillvalue=3)
    f.create_dataset("same", data=np.full((20, 10), 42, "i2"),
                     chunks=(10, 10), scaleoffset=0)
    smooth = _smooth((45, 61))
    f.create_dataset("f4", data=smooth, chunks=(10, 20), scaleoffset=2)
    f.create_dataset("f8", data=smooth.astype("f8"), chunks=(10, 20),
                     scaleoffset=3)
    f.create_dataset("f4_fill", data=np.where(smooth > 285, np.float32(-9.5),
                                              smooth),
                     chunks=(10, 20), scaleoffset=1, fillvalue=-9.5)


def _nbit_dataset(f, name, tid, shape, data, chunks):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk(chunks)
    dcpl.set_filter(h5py.h5z.FILTER_NBIT)
    ds = h5py.h5d.create(f.id, name.encode(), tid,
                         h5py.h5s.create_simple(shape), dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, data)


def _nbit_layout(f):
    """n-bit: i4 and f4 at full precision (stored as they are), and
    integers of fewer bits than their size, which HDF5 packs: 12 bits at
    offset 4 of an i4, 20 of a u4, 9 at offset 3 of a big-endian i2."""
    smooth = _smooth((45, 61))
    for dt in ("i4", "f4"):
        _nbit_dataset(f, dt, h5py.h5t.py_create(np.dtype(dt)), (45, 61),
                      smooth.astype(dt), (10, 20))
    for prec, off, base, data in (
            (12, 4, h5py.h5t.STD_I32LE, (np.arange(300) - 150) * 13),
            (20, 0, h5py.h5t.STD_U32LE, np.arange(300) * 3000),
            (9, 3, h5py.h5t.STD_I16BE, np.arange(300) - 150)):
        tid = base.copy()
        tid.set_precision(prec)
        tid.set_offset(off)
        _nbit_dataset(f, f"bits{prec}_at{off}", tid, (300,),
                      data.astype("u4" if prec == 20 else "i4"), (64,))


def _huge_attributes(f):
    """Dense attributes past the heap's managed object size (huge heap
    objects, found through the heap's v2 B-tree of type 1), on the root
    and on a dataset."""
    for i in range(12):
        f.attrs[f"a{i}"] = np.int32(i)
    f.attrs["big"] = np.arange(2000.0)
    ds = f.create_dataset("x", data=np.arange(3.0))
    for i in range(10):
        ds.attrs[f"b{i}"] = np.arange(1000 * (i + 1), dtype="f4")


H5PY_LAYOUTS = {
    "default": (_many, {}),                    # symbol table, v1 headers
    "track_order": (_many, {"track_order": True}),   # dense, creation order
    "deep_track_order": (_deep, {"track_order": True}),
    "deep_name_order": (_deep, {"libver": ("v108", "latest")}),
    "heap_indirect_rows": (_heap_rows, {"track_order": True}),
    "chunked": (_chunked, {}),
    "chunked_track_order": (_chunked, {"track_order": True}),
    "latest": (_latest, {"libver": "latest"}),
    "fixed_array": (_index_fixed_array, {"libver": "latest"}),
    "fixed_array_gzip": (lambda f: _index_fixed_array(f, **_GZIP),
                         {"libver": "latest"}),
    "extensible_array": (_index_extensible_array, {"libver": "latest"}),
    "extensible_array_gzip": (lambda f: _index_extensible_array(
        f, **_GZIP), {"libver": "latest"}),
    "v2_btree_index": (_index_btree2, {"libver": "latest"}),
    "v2_btree_index_gzip": (lambda f: _index_btree2(f, **_GZIP),
                            {"libver": "latest"}),
    "szip_nn": (lambda f: _szip(f, "nn"), {}),
    "szip_ec": (lambda f: _szip(f, "ec"), {"libver": "latest"}),
    "lzf": (_lzf_layout, {"track_order": True}),
    "scale_offset": (_scale_offset_layout, {}),
    "nbit": (_nbit_layout, {}),
    "huge_attributes": (_huge_attributes, {"libver": "latest"}),
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


def _ncc_szip(path):
    """``nc_def_var_szip`` in both modes (NN, 16 pixels per block; EC, 8)
    on MPAS-shaped record variables; skips where the system netCDF-C's
    HDF5 has no szip."""
    n, nz = 2000, 7
    with nf.NCWriter(path) as f:
        f.def_dim("Time", None)
        f.def_dim("nCells", n)
        f.def_dim("nVertLevels", nz)
        try:
            f.def_var("theta", "f4", ("Time", "nCells", "nVertLevels"),
                      szip=(32, 16))
        except OSError as e:
            pytest.skip(f"netCDF-C without szip: {e}")
        f.def_var("qv", "f8", ("Time", "nCells"), szip=(4, 8))
        f.enddef()
        f.put("theta", _smooth((1, n, nz)))
        f.put("qv", _smooth((1, n), "f8") * 1e-5)


H5_NCC = {"minimal": _ncc_minimal, "mpas_theta": _ncc_theta,
          "many_attributes": _ncc_many_attrs, "unwritten": _ncc_unwritten,
          "diag_fixture_layout": nf.make_diag_fixture, "szip": _ncc_szip}


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
        # netCDF-C's superblock 2; h5py's 3 under libver "latest"
        assert f.read(9)[8] == (3 if "latest" in name else 2)
    assert _port_read(path, monkeypatch) == MANIFEST["files"][name]


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_manifest_is_h5pys_read(name):
    with h5py.File(os.path.join(nf.FIXTURES, name), "r") as f:
        assert _js(describe_hdf5(f)) == MANIFEST["files"][name]


def test_fixtures_size():
    assert sum(os.path.getsize(os.path.join(nf.FIXTURES, n))
               for n in os.listdir(nf.FIXTURES)) <= 1 << 20


_H5PY_LAYOUT = {h5py.h5d.COMPACT: "compact",
                h5py.h5d.CONTIGUOUS: "contiguous",
                h5py.h5d.CHUNKED: "chunked"}
_H5PY_FILTER = {h5py.h5z.FILTER_DEFLATE: "deflate",
                h5py.h5z.FILTER_SHUFFLE: "shuffle",
                h5py.h5z.FILTER_FLETCHER32: "fletcher32",
                h5py.h5z.FILTER_SZIP: "szip", h5py.h5z.FILTER_NBIT: "n-bit",
                h5py.h5z.FILTER_SCALEOFFSET: "scale-offset", 32000: "lzf"}


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_storage_is_what_h5py_reports(name):
    """``storage()`` of every dataset of a fixture: the layout, filters
    and allocation h5py reports, and the chunk index the writer chose:
    under libver "latest" an extensible array where an axis is
    unlimited, else a fixed array; a v1 B-tree in netCDF-C's files."""
    r = hdf5.open_file(os.path.join(nf.FIXTURES, name))
    try:
        with h5py.File(os.path.join(nf.FIXTURES, name), "r") as f:
            for key, ds in r.items():
                want = f[key]
                plist = want.id.get_create_plist()
                layout = _H5PY_LAYOUT[plist.get_layout()]
                index = None
                if layout == "chunked":
                    index = ("btree1" if "latest" not in name
                             else "earray" if None in want.maxshape
                             else "farray")
                assert ds.storage() == {
                    "layout": layout, "index": index,
                    "filters": [_H5PY_FILTER[plist.get_filter(i)[0]]
                                for i in range(plist.get_nfilters())],
                    "allocated": want.id.get_storage_size() > 0}, key
    finally:
        r.close()


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


@pytest.mark.parametrize("make", [_extensible_array, _v2_btree_index,
                                  _scale_offset])
def test_reader_reads_what_it_refused(tmp_path, monkeypatch, make):
    """An extensible-array and a v2-B-tree chunk index and scale-offset,
    which the reader refused before it decoded them: bit for bit h5py's
    read."""
    path = str(tmp_path / "f.h5")
    make(path)
    _assert_same_as_h5py(path, monkeypatch)


def _plugin(fid):
    """A filter h5py writes into the pipeline without its plugin
    (``allow_unknown_filter``): zstd, blosc, bzip2."""
    def make(path):
        with h5py.File(path, "w") as f:
            f.create_dataset("x", data=np.arange(100.0), chunks=(10,),
                             compression=fid, allow_unknown_filter=True)
    return make


def _external(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(10.0, dtype="f4"),
                         external=[(path + ".raw", 0, 40)])


def _virtual(path):
    src = path + ".src.h5"
    with h5py.File(src, "w") as f:
        f.create_dataset("a", data=np.arange(10.0))
    layout = h5py.VirtualLayout(shape=(10,), dtype="f8")
    layout[:] = h5py.VirtualSource(src, "a", shape=(10,))
    with h5py.File(path, "w", libver="latest") as f:
        f.create_virtual_dataset("v", layout)


def _flip(path, sig, at):
    """Flip one bit ``at`` bytes past the first ``sig`` in the file."""
    with open(path, "r+b") as fh:
        raw = fh.read()
        pos = raw.index(sig) + at
        fh.seek(pos)
        fh.write(bytes([raw[pos] ^ 1]))


def _bad_index_header(sig):
    """A fixed or extensible array whose header lost a bit in its
    maximum element count or statistics."""
    def make(path):
        with h5py.File(path, "w", libver="latest") as f:
            f.create_dataset("x", data=np.arange(100.0), chunks=(10,),
                             maxshape=(None,) if sig == b"EAHD" else None)
        _flip(path, sig, 20)
    return make


def _truncated_szip(path):
    """A szip chunk whose stored size in its v1 B-tree key lost 16
    bytes: the coded stream ends before the chunk does."""
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("x", data=_smooth((40, 50)), chunks=(40, 50),
                              compression="szip", compression_opts=("nn", 8))
        info = ds.id.get_chunk_info(0)
    key = (struct.pack("<II", info.size, 0) + bytes(24)
           + struct.pack("<Q", info.byte_offset))
    with open(path, "r+b") as fh:
        raw = fh.read()
        pos = raw.index(key)
        fh.seek(pos)
        fh.write(struct.pack("<I", info.size - 16))


def _szip_chunk(chunk):
    """A 64-byte szip dataset (EC, 8 pixels per block) whose one chunk
    is ``chunk``, written as it is."""
    def make(path):
        with h5py.File(path, "w") as f:
            ds = f.create_dataset("x", shape=(64,), dtype="u1",
                                  chunks=(64,), compression="szip",
                                  compression_opts=("ec", 8))
            ds.id.write_direct_chunk((0,), chunk)
    return make


#: a chunk whose size header claims 4 GiB: refused before any allocation
_SZIP_INFLATED = struct.pack("<I", 0xFFFF_FFF0) + bytes(16)
#: low-entropy option 0, zero-block code, then a run of 100 zero blocks
#: (a fundamental sequence of 100 zeros): past the 8-block interval
_SZIP_LONG_RUN = struct.pack("<I", 64) + int(
    "0000" + "0" * 100 + "1" + "0" * 7, 2).to_bytes(14, "big")


def _corrupt_lzf(path):
    """An LZF chunk whose first byte became a back-reference, before any
    output it could refer to."""
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("x", data=_smooth((40, 50)), chunks=(40, 50),
                              compression="lzf", shuffle=True)
        info = ds.id.get_chunk_info(0)
        assert info.filter_mask == 0
        at = info.byte_offset
    with open(path, "r+b") as fh:
        fh.seek(at)
        fh.write(b"\xe0")


def _nbit_compound(path):
    """n-bit on a compound whose member has fewer bits than its size, so
    HDF5 packs it (the compound case of H5Znbit)."""
    member = h5py.h5t.STD_I32LE.copy()
    member.set_precision(12)
    member.set_offset(4)
    tid = h5py.h5t.create(h5py.h5t.COMPOUND, 8)
    tid.insert(b"a", 0, member)
    tid.insert(b"b", 4, h5py.h5t.IEEE_F32LE)
    data = np.zeros(30, [("a", "<i4"), ("b", "<f4")])
    data["a"] = np.arange(30)
    with h5py.File(path, "w") as f:
        _nbit_dataset(f, "c", tid, (30,), data, (10,))


def _short_float(path):
    """A 4-byte float of 24 significant bits at bit offset 8 (an 8-bit
    exponent, a 15-bit mantissa), which HDF5 converts to f4 on reading."""
    tid = h5py.h5t.IEEE_F32LE.copy()
    tid.set_fields(23, 15, 8, 0, 15)
    tid.set_precision(24)
    tid.set_offset(8)
    with h5py.File(path, "w") as f:
        ds = h5py.h5d.create(f.id, b"x", tid, h5py.h5s.create_simple((10,)))
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(10, dtype="f4"))


def _shared_message(path):
    """A dataset header whose datatype message is flagged shared (stored
    elsewhere, as in a shared-message table), its checksum made again."""
    with h5py.File(path, "w", track_order=True) as f:
        f.create_dataset("x", data=np.arange(3.0), track_order=True)
        addr = h5py.h5o.get_info(f["x"].id).addr
    with open(path, "r+b") as fh:
        raw = bytearray(fh.read())
    flags = raw[addr + 5]
    p = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    w = 1 << (flags & 3)
    end = p + w + int.from_bytes(raw[p:p + w], "little")
    p += w
    while p < end:
        t, size = raw[p], struct.unpack_from("<H", raw, p + 1)[0]
        if t == 3:
            raw[p + 3] |= 2
            break
        p += 6 + size
    struct.pack_into("<I", raw, end, hdf5.lookup3(bytes(raw[addr:end])))
    with open(path, "wb") as fh:
        fh.write(raw)


@pytest.mark.parametrize("make,word", [
    (_bad_heap_block, "DIRECT BLOCK AT [0-9]+: CHECKSUM MISMATCH"),
    (_plugin(32015), "FILTER 32015 .ZSTD"),
    (_plugin(32001), "FILTER 32001 .BLOSC"),
    (_plugin(307), "FILTER 307 .BZIP2"),
    (_external, "EXTERNAL STORAGE"),
    (_virtual, "VIRTUAL LAYOUT"),
    (_bad_index_header(b"FAHD"), "FIXED ARRAY HEADER AT [0-9]+: CHECKSUM "
                                 "MISMATCH"),
    (_bad_index_header(b"EAHD"), "EXTENSIBLE ARRAY HEADER AT [0-9]+: "
                                 "CHECKSUM MISMATCH"),
    (_truncated_szip, "CHUNK AT [0-9]+: FILTER 4 .SZIP.: .* TRUNCATED"),
    (_szip_chunk(_SZIP_INFLATED), "CHUNK AT [0-9]+: FILTER 4 .SZIP.: THE "
                                  "CHUNK DECODES TO 4294967280 BYTES"),
    (_szip_chunk(_SZIP_LONG_RUN), "CHUNK AT [0-9]+: FILTER 4 .SZIP.: A "
                                  "ZERO-BLOCK RUN PAST ITS REFERENCE"),
    (_corrupt_lzf, "CHUNK AT [0-9]+: FILTER 32000 .LZF.: A BACK-REFERENCE"),
    (_nbit_compound, "CHUNK AT [0-9]+: FILTER 5 .N-BIT.: COMPOUND"),
    (_shared_message, "SHARED MESSAGE .TYPE 3"),
    (_short_float, "FLOATING-POINT DATATYPE OF PRECISION 24 AT BIT OFFSET "
                   "8"),
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


def test_filter_decoders_do_not_fall_back(tmp_path, monkeypatch):
    """With no g++ on PATH and no built library, the first szip chunk
    raises a FatalError naming the build: nothing decodes szip or LZF in
    Python instead."""
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=_smooth((10, 20)), chunks=(10, 20),
                         compression="szip")
    monkeypatch.setattr(h5filters, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(h5filters, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path / "no_compiler"))
    r = hdf5.open_file(path)
    try:
        with pytest.raises(FatalError, match="BUILDING THE HDF5 FILTER "
                                             "DECODERS .*g[+][+]"):
            r["x"][...]
    finally:
        r.close()
    assert not os.listdir(tmp_path / "build")


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


def test_cli_without_h5py_on_latest_szip_lzf_inputs(tmp_path, monkeypatch):
    """``pipeline.main`` with h5py blocked on the MPAS mesh, diag and
    history of the end-to-end case rewritten by h5py with libver
    "latest" (``Time`` unlimited, so an extensible-array index, several
    chunks per record; szip and LZF in turn, text through LZF): every
    RegridResult array within 1e-5 * max(1, max|ref|) of the JAX
    package's run on the same files, which reads them through h5py."""
    _, jcfg, _, _ = make_case(tmp_path)
    for key in ("grid", "diag", "hist"):
        src = getattr(jcfg, f"{key}_file_input_grid")
        dst = str(tmp_path / f"{key}_latest.nc")
        nf.copy_through_h5py(src, dst, nf.mixed_filters)
        setattr(jcfg, f"{key}_file_input_grid", dst)
    with h5py.File(jcfg.hist_file_input_grid) as f:
        kinds = {ds.compression for ds in f.values()}
        assert {"szip", "lzf"} <= kinds
        assert f.id.get_create_plist().get_version()[0] == 3
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
    with nc4.open_dataset(cfg.hist_file_input_grid) as f:
        assert isinstance(f._f, hdf5._Reader)
