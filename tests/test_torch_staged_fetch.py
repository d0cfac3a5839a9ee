"""The apply's staged fetch (``mpassit_tpu_torch.ops.matmul_apply
._fetch_strips``): every row chunk crosses through one of the device's two
staging buffers (``_Staging``), chunk k through buffer k mod 2, and the
host scatters chunk k - 1 while chunk k is copied.

On the CPU the same loop runs through plain host buffers, so these tests
hold its chunks and buffers to the device result bit for bit: one chunk
or many, an odd and an even number of them with a short last one (both
buffers used, and used again), a column count that is not a multiple of
CB, groups that start past column 0, several column groups of an apply
(``MPASSIT_DEVICE_BUDGET_GB``, and the FETCH-column groups of
SlabMatmulRegridder), with and without a strip sink; the counters; the
buffers kept across calls. On a CUDA card only: the buffers page-locked
and allocated once, every fetched byte staged, the result the CPU fetch's
of the same device result, and the fetch's device memory within
FETCH_TMP.

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_staged_fetch.py
"""

import numpy as np
import pytest
import torch

from mpassit_tpu_torch import spans
from mpassit_tpu_torch.ops import matmul_apply as tm
from mpassit_tpu_torch.weights.ell import ELLWeights

CPU = torch.device("cpu")
NY, NX = 37, 45
TINY = "0.001"          # GB: every pack here exceeds it


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_budget(monkeypatch):
    monkeypatch.delenv("MPASSIT_DEVICE_BUDGET_GB", raising=False)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (page-locked staging, side stream)")
    return torch.device("cuda", 0)


def _ell(offsets, ny=NY, nx=NX, seed=0):
    """A local operator over an (ny, nx) source: target point p reads the
    source points p + offsets (clipped), some weights zero."""
    rng = np.random.default_rng(seed)
    n = ny * nx
    idx = np.clip(np.arange(n)[:, None] + np.asarray(offsets)[None, :],
                  0, n - 1).astype(np.int64)
    w = rng.random(idx.shape)
    w[rng.random(idx.shape) < 0.1] = 0.0
    return ELLWeights(idx=idx, w=w, n_src=n, method="bilinear",
                      dst_shape=(ny, nx))


def _sink_into(strips):
    def sink(lo, strip):
        assert lo not in strips and strip.shape[2] <= tm.CB
        strips[lo] = np.array(strip)
    return sink


def _joined(strips):
    return np.concatenate([strips[k] for k in sorted(strips)], axis=2)


def _count_chunks(monkeypatch):
    """Count the row chunks a fetch stages (one gather_bands call each)."""
    calls = []
    gather = tm.gather_bands

    def spy(x, mesh, root_only=False):
        calls.append(x.shape[0])
        return gather(x, mesh, root_only)

    monkeypatch.setattr(tm, "gather_bands", spy)
    return calls


# (o's width, C, lo0): one group past C's end; a later group, C not a
# multiple of CB; a group of less than one CB strip
GROUPS = [(384, 300, 0), (384, 700, 512), (128, 600, 512)]
#: rows per chunk: all rows in one; 13 chunks (odd) and 10 (even) of the
#: 37 rows, each with a short last one
ROWS = [NY, 3, 4]


@pytest.mark.parametrize("sink", [False, True])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("width,C,lo0", GROUPS)
def test_fetch_equals_the_device_result(monkeypatch, width, C, lo0, rows,
                                        sink):
    o = torch.randn((64, 64, width), generator=torch.Generator().manual_seed(
        width + C + rows))
    hi = min(lo0 + width, C)
    ref = o[:NY, :NX, :hi - lo0].numpy()
    # a chunk of ``rows`` rows of the first strip's columns
    w0 = min(tm.CB if sink else hi - lo0, hi - lo0)
    monkeypatch.setattr(tm, "FETCH_TMP", tm.FETCH_CHUNKS * 4 * NX * w0 * rows)
    chunks = _count_chunks(monkeypatch)
    out = np.full((NY, NX, C), np.nan, np.float32)
    strips = {}
    tm._fetch_strips(o, C, NY, NX, lo0, False, None if sink else out,
                     _sink_into(strips) if sink else None)
    if sink:
        assert sorted(strips) == list(range(lo0, hi, tm.CB))
        np.testing.assert_array_equal(_joined(strips), ref)
    else:
        np.testing.assert_array_equal(out[:, :, lo0:hi], ref)
        assert np.isnan(out[:, :, :lo0]).all()
        assert np.isnan(out[:, :, hi:]).all()
    # the first strip crosses in chunks of ``rows`` rows, the last short
    n_first = -(-NY // rows)
    assert chunks[:n_first] == [rows] * (n_first - 1) + [
        NY - rows * (n_first - 1)]
    if not sink:
        assert len(chunks) == n_first
        assert n_first % 2 == {NY: 1, 3: 1, 4: 0}[rows]


@pytest.mark.parametrize("sink", [False, True])
@pytest.mark.parametrize("kind", ["packed_grouped", "slab_two_groups"])
def test_apply_equals_the_device_result(monkeypatch, kind, sink):
    """apply_np, fetched in several column groups and in row chunks with a
    short last one, against the device result that ``__call__`` returns
    unfetched."""
    if kind == "packed_grouped":
        cols = [500, 80, 60]                  # C 640: not a multiple of CB
        rg = tm.PackedSlabRegridder(
            [(_ell(off, seed=i), c) for i, (off, c) in enumerate(zip(
                ([0, 1, NX], [0], [0, -1, 1, -NX]), cols))], CPU)
        monkeypatch.setenv("MPASSIT_DEVICE_BUDGET_GB", TINY)
        assert rg._grouped_width() == tm.LANE       # 5 groups
    else:
        cols = [600]                          # groups [0, 512), [512, 640)
        rg = tm.SlabMatmulRegridder(_ell([0, 1, NX]), CPU)
    src = np.random.default_rng(5).standard_normal(
        (NY * NX, sum(cols))).astype(np.float32)
    ref = rg(torch.from_numpy(src))[:NY, :NX].numpy()
    monkeypatch.setattr(tm, "FETCH_TMP",
                        tm.FETCH_CHUNKS * 4 * NX * tm.LANE * 3)
    if sink:
        strips = {}
        assert rg.apply_np(src, strip_sink=_sink_into(strips)) is None
        got = _joined(strips)
    else:
        got = rg.apply_np(src)
    np.testing.assert_array_equal(got, ref)


def test_counts_and_buffers_on_the_cpu():
    """On the CPU nothing is staged through page-locked memory: the
    counter reads 0 beside every fetched byte, and the plain buffers are
    made once and kept."""
    rg = tm.SlabMatmulRegridder(_ell([0, 1, NX]), CPU)
    src = np.random.default_rng(6).standard_normal(
        (NY * NX, 300)).astype(np.float32)
    ptrs = []
    for _ in range(2):
        t = spans.Timings()
        with spans.recording(t):
            rg.apply_np(src)
        assert t.counts["apply.fetch_bytes"] == 4 * NY * NX * 300
        assert t.counts["apply.fetch_staged_bytes"] == 0
        st = tm._staging(CPU)
        assert not st.pinned and st.stream is None and len(st.bufs) == 2
        ptrs.append([b.data_ptr() for b in st.bufs])
    assert ptrs[0] == ptrs[1] and ptrs[0][0] != ptrs[0][1]


@pytest.mark.cuda
def test_staging_buffers_on_the_card(cuda_device):
    """Page-locked, allocated once for every apply and every recorded
    call, every fetched byte staged, the result the CPU fetch's."""
    rg = tm.PackedSlabRegridder([(_ell([0, 1, NX]), 200),
                                 (_ell([0], seed=1), 56)], cuda_device)
    src = np.random.default_rng(7).standard_normal(
        (NY * NX, 256)).astype(np.float32)
    ref = rg(torch.from_numpy(src).to(cuda_device))[:NY, :NX].cpu().numpy()
    st = tm._staging(cuda_device)
    ptrs = []
    for recorded in (False, False, True, True):
        t = spans.Timings()
        with spans.recording(t if recorded else None):
            got = rg.apply_np(src)
        np.testing.assert_array_equal(got, ref)
        assert st.pinned and len(st.bufs) == 2
        assert all(b.is_pinned() for b in st.bufs)
        ptrs.append([b.data_ptr() for b in st.bufs])
        if recorded:
            assert (t.counts["apply.fetch_staged_bytes"]
                    == t.counts["apply.fetch_bytes"] == got.nbytes)
    assert all(p == ptrs[0] for p in ptrs)


@pytest.mark.cuda
@pytest.mark.parametrize("sink", [False, True])
def test_staged_fetch_memory_on_the_card(cuda_device, sink):
    """A result of ~0.6 GB crosses in several chunks; the device holds no
    more than FETCH_TMP beyond it meanwhile, and the host gets what the
    CPU fetch of the same result gets."""
    ny, nx, C = 300, 1800, 250
    o = torch.randn((320, 1824, 256), device=cuda_device)
    ref = np.empty((ny, nx, C), np.float32)
    tm._fetch_strips(o.cpu(), C, ny, nx, 0, False, ref, None)
    torch.cuda.synchronize(cuda_device)
    before = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    out, strips = np.empty((ny, nx, C), np.float32), {}
    t = spans.Timings()
    with spans.recording(t):
        tm._fetch_strips(o, C, ny, nx, 0, False, None if sink else out,
                         _sink_into(strips) if sink else None)
    peak = torch.cuda.max_memory_allocated(cuda_device)
    assert peak - before <= tm.FETCH_TMP
    np.testing.assert_array_equal(_joined(strips) if sink else out, ref)
    assert (t.counts["apply.fetch_staged_bytes"]
            == t.counts["apply.fetch_bytes"] == ref.nbytes)
