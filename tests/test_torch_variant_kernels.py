"""mpassit_tpu_torch.ops.variant_kernels and the kernel-variants tool: the
plain versions against the TPU kernels they replace
(tools/kernel_variants.make_v1 and make_v2, run in Pallas interpret mode on
the CPU), the wrappers' routing, counters and validation, the tool's
function on a tiny mesh, and — on a CUDA card only — each kernel against
its plain version.

Tolerances: the plain versions and the TPU kernels form the same bf16
terms, exact in f32, and differ only in the order of the f32 sums, so 1e-6
of max|JAX| (and of max|plain| for the kernels). v1 and v2 kernels sum the
same terms in the same order: equal bit for bit.

The module imports JAX only inside the reference comparisons, so that the
CUDA tests also run on a card machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_variant_kernels.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from mpassit_tpu_torch.ops import variant_kernels as vk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 1024
TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _problem(seed, nty=2, ntx=3, W=40, Cp=256, K=3, out_of_range=False):
    """Bilinear-like ELL arrays over a (n_tiles, W, Cp) slab: weights in
    [0, 1), duplicate locs within a point (their weights must be summed
    before the split), w = 0 pads at loc 0 as the pack leaves them, and
    optionally entries naming rows >= W (which add nothing)."""
    rng = np.random.default_rng(seed)
    n_tiles = nty * ntx
    loc = rng.integers(0, W, (n_tiles, K, TILE)).astype(np.int32)
    w = rng.random((n_tiles, K, TILE)).astype(np.float32)
    if K > 1:
        loc[:, -1, : TILE // 3] = loc[:, 0, : TILE // 3]      # duplicates
    pad = rng.random((n_tiles, K, TILE)) < 0.2
    loc[pad], w[pad] = 0, 0.0
    if out_of_range:
        loc[:, 0, ::7] = W + 3
    slab = rng.standard_normal((n_tiles, W, Cp)).astype(np.float32)
    return loc, w, slab


def _jax_variant(make, loc, w, slab, nty, ntx, **kw):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    sys.path.insert(0, REPO)
    import tools.kernel_variants as tkv

    W, Cp = slab.shape[1:]
    with pltpu.force_tpu_interpret_mode():
        run = getattr(tkv, make)(nty, ntx, W, Cp, **kw)
        return np.asarray(run(jnp.asarray(loc), jnp.asarray(w),
                              jnp.asarray(slab)))


def _assert_close(got, ref):
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def _torch(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("seed,nty,ntx,W,Cp,K,oor", [
    (0, 2, 3, 40, 256, 3, False),     # the tool's K, W not a multiple of 32
    (1, 1, 2, 16, 512, 3, True),      # two 256-column sub-chunks, rows >= W
    (2, 2, 1, 24, 128, 4, False),
])
def test_plain_v1_matches_jax_make_v1(seed, nty, ntx, W, Cp, K, oor):
    loc, w, slab = _problem(seed, nty, ntx, W, Cp, K, oor)
    ref = _jax_variant("make_v1", loc, w, slab, nty, ntx)
    got = vk.ell_split_apply_v1_plain(*_torch(loc, w, slab), nty=nty,
                                      ntx=ntx)
    _assert_close(got.numpy(), ref)


@pytest.mark.parametrize("CC", [128, 256])
def test_plain_v2_matches_jax_make_v2(CC):
    nty, ntx = 2, 3
    loc, w, slab = _problem(3, nty, ntx, W=40, Cp=256, K=3,
                            out_of_range=True)
    ref = _jax_variant("make_v2", loc, w, slab, nty, ntx, CC=CC)
    got = vk.ell_split_apply_v2(*_torch(loc, w, slab), nty=nty, ntx=ntx,
                                CC=CC)
    _assert_close(got.numpy(), ref)


def test_one_hot_sums_duplicates_before_the_split():
    """The plain operator equals the JAX one-hot build bit for bit, with
    duplicates summed in k order, pads adding nothing and rows >= W
    dropped."""
    import jax.numpy as jnp

    from mpassit_tpu.ops.matmul_apply import _build_A_T

    loc, w, _ = _problem(4, 1, 2, W=24, Cp=128, K=4)
    A = vk._one_hot(*_torch(loc, w), 24)
    T = loc.shape[0] * TILE
    flat = lambda a: a.transpose(0, 2, 1).reshape(T, -1)  # noqa: E731
    ref = np.asarray(_build_A_T(jnp.asarray(flat(loc)), jnp.asarray(flat(w)),
                                n_tiles=2, w_width=24))
    assert A.numpy().tobytes() == ref.astype(np.float32).tobytes()
    loc_oor = loc.copy()
    loc_oor[:, 1, :] = 24
    A2 = vk._one_hot(*_torch(loc_oor, w), 24)
    w_kept = w.copy()
    w_kept[:, 1, :] = 0.0
    assert torch.equal(A2, vk._one_hot(*_torch(loc, w_kept), 24))


def test_v1_and_v2_plain_agree_and_keep_the_split_class():
    """Both plain versions against a float64 evaluation: within the
    split_bf16 class (~2^-16 relative per dropped lo x lo product), and not
    exact (the split really drops terms)."""
    nty, ntx = 1, 2
    loc, w, slab = _problem(5, nty, ntx, W=16, Cp=128)
    args = _torch(loc, w, slab)
    v1 = vk.ell_split_apply_v1_plain(*args, nty=nty, ntx=ntx)
    v2 = vk.ell_split_apply_v2_plain(*args, nty=nty, ntx=ntx)
    assert (v1 - v2).abs().max() <= TOL * v1.abs().max()
    A = vk._one_hot(*args[:2], 16).double()
    truth = torch.einsum("twp,twc->tpc", A, args[2].double())
    truth = truth.reshape(1, 2, 32, 32, 128).permute(0, 2, 1, 3, 4)
    err = float((v1.double() - truth.reshape(32, 64, 128)).abs().max()
                / truth.abs().max())
    assert 1e-9 < err < 3e-5, err


def test_cpu_tensor_runs_plain_and_counts():
    loc, w, slab = _torch(*_problem(6, 1, 1, W=8, Cp=256))
    launches, plain = dict(vk.LAUNCHES), dict(vk.PLAIN_CALLS)
    out = vk.ell_split_apply_v1(loc, w, slab, nty=1, ntx=1)
    assert out.device.type == "cpu" and out.shape == (32, 32, 256)
    vk.ell_split_apply_v2(loc, w, slab, nty=1, ntx=1, CC=256)
    assert vk.LAUNCHES == launches
    assert vk.PLAIN_CALLS == {k: v + 1 for k, v in plain.items()}


def test_other_device_raises():
    loc = torch.zeros((1, 3, TILE), dtype=torch.int32, device="meta")
    w = torch.zeros((1, 3, TILE), device="meta")
    slab = torch.zeros((1, 8, 128), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        vk.ell_split_apply_v1(loc, w, slab, nty=1, ntx=1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        vk.ell_split_apply_v2(loc, w, slab, nty=1, ntx=1)


@pytest.mark.parametrize("kw,match", [
    (dict(loc=torch.zeros((1, 3, TILE))), "loc must be"),
    (dict(loc=torch.zeros((1, 3, 512), dtype=torch.int32)), "loc must be"),
    (dict(w=torch.zeros((1, 2, TILE))), "w must match"),
    (dict(loc=torch.zeros((1, 17, TILE), dtype=torch.int32),
          w=torch.zeros((1, 17, TILE))), "K = 17"),
    (dict(slab=torch.zeros((1, 8, 100))), "multiple of 128"),
    (dict(slab=torch.zeros((1, 8, 128), dtype=torch.float64)), "slab must"),
    (dict(nty=2), "grid wants"),
    (dict(CC=64), "CC must be"),
    (dict(CC=256, slab=torch.zeros((1, 8, 384))), "CC must be"),
])
def test_validation(kw, match):
    args = dict(loc=torch.zeros((1, 3, TILE), dtype=torch.int32),
                w=torch.zeros((1, 3, TILE)), slab=torch.zeros((1, 8, 128)),
                nty=1, ntx=1)
    args.update(kw)
    fn = vk.ell_split_apply_v2 if "CC" in kw else vk.ell_split_apply_v1
    with pytest.raises(ValueError, match=match):
        fn(args.pop("loc"), args.pop("w"), args.pop("slab"), **args)


def test_tool_runs_on_cpu_with_the_plain_versions(tmp_path):
    """The tool's problem build and variant run on a tiny mesh: every
    variant runs through its wrapper's plain version, the spot checks
    hold, nothing is timed, and a second build finds the weights cached."""
    from mpassit_tpu_torch.ops import packed_kernel as pk
    from mpassit_tpu_torch.ops import write_wall as ww
    from mpassit_tpu_torch.tools import kernel_variants as kv

    ell, info = kv.build_problem(3000, 61, 37, str(tmp_path))
    assert info["weights"] == "cold" and (info["ny"], info["nx"]) == (37, 61)
    plain = (pk.PLAIN_CALLS, dict(vk.PLAIN_CALLS), ww.PLAIN_CALLS)
    res = kv.run_variants(ell, "cpu", cols=200, seed=1,
                          cache_dir=str(tmp_path))
    assert res["ok"], res["checks"]
    p = res["problem"]
    assert (p["nty"], p["ntx"], p["Cp"], p["K"]) == (2, 2, 256, 3)
    assert [r["variant"] for r in res["variants"]] == [
        "v0", "v1", "v2_cc128", "v2_cc256", "write_wall"]
    assert all("ms" not in r for r in res["variants"])
    assert res["checks"]["v1_vs_v2_cc128_rel"] <= kv.TOL_V1_V2
    assert 0 < res["checks"]["v1_vs_v0_rel"] <= kv.TOL_V1_V0
    assert pk.PLAIN_CALLS == plain[0] + 1 and ww.PLAIN_CALLS == plain[2] + 1
    assert vk.PLAIN_CALLS == {"ell_split_apply_v1": plain[1][
        "ell_split_apply_v1"] + 1, "ell_split_apply_v2": plain[1][
        "ell_split_apply_v2"] + 2}
    assert kv.build_problem(3000, 61, 37, str(tmp_path))[1]["weights"] == \
        "warm"


def test_tool_needs_a_card(monkeypatch, capsys):
    from mpassit_tpu_torch.tools import kernel_variants as kv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kv.main(["--ncells", "1000"]) == 1
    assert "CUDA device" in capsys.readouterr().err


@pytest.mark.cuda
@pytest.mark.parametrize("W,Cp,K", [(40, 384, 3), (16, 512, 3), (70, 256, 4)])
def test_cuda_kernels_match_plain(cuda_device, W, Cp, K):
    """v1, and v2 at each CC that divides Cp, against their plain versions
    (1e-6 of max|plain|), and v1 against v2 bit for bit. W not a multiple
    of v1's 32-row step, duplicates, pads and rows >= W."""
    nty, ntx = 3, 5
    args = _torch(*_problem(7, nty, ntx, W, Cp, K, out_of_range=True),
                  device=cuda_device)
    launches = dict(vk.LAUNCHES)
    v1 = vk.ell_split_apply_v1(*args, nty=nty, ntx=ntx)
    torch.cuda.synchronize()
    assert vk.LAUNCHES["ell_split_apply_v1"] == launches[
        "ell_split_apply_v1"] + 1
    ref = vk.ell_split_apply_v1_plain(*args, nty=nty, ntx=ntx)
    assert torch.isfinite(v1).all()
    assert (v1 - ref).abs().max() <= TOL * ref.abs().max()
    ref2 = vk.ell_split_apply_v2_plain(*args, nty=nty, ntx=ntx)
    for CC in [c for c in vk.V2_CC if Cp % c == 0]:
        v2 = vk.ell_split_apply_v2(*args, nty=nty, ntx=ntx, CC=CC)
        torch.cuda.synchronize()
        assert (v2 - ref2).abs().max() <= TOL * ref2.abs().max()
        assert torch.equal(v1, v2)


@pytest.mark.cuda
def test_v2_kernel_refuses_a_slab_wider_than_shared_memory(cuda_device):
    W = vk.V2_MAX_W + 2
    loc, w, slab = _torch(*_problem(8, 1, 1, W=W, Cp=128),
                          device=cuda_device)
    with pytest.raises(ValueError, match="shared"):
        vk.ell_split_apply_v2(loc, w, slab, nty=1, ntx=1)
