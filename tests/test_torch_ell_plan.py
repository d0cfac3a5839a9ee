"""ops/packed_kernel.ell_plan, the launch geometry of csrc/ell_apply.cuh
(packed_apply and packed_gather_apply), read on the CPU as the kernel reads
it: per column the method, role and rotation partner (and the int table
that encodes them), per block the tile and column range, per launch the
block width and the staging choice. One parametrised test, one case per
property."""

import pytest

from mpassit_tpu_torch.ops import packed_kernel as pk
from mpassit_tpu_torch.ops.packed_kernel import PLAIN, TAIL, U, V, ell_plan

#: the smoke run's CONUS pack: bilinear, nearest, conserve, mass winds
PACK = dict(n_tiles=1938, W=40, Cp=1024,
            ranges=((0, 992), (992, 1008), (1008, 1024)),
            rotate=((0, 55, 55),))


def decode(e):
    """The kernel's reading of a table entry (ci_* in ell_apply.cuh)."""
    return ((e & 15) - 1, (e >> 4) & 3, ((e >> 6) & 15) - 1, e >> 10)


def case_pack_roles_and_partners():
    p = ell_plan(**PACK)
    assert p.cend == 1024 and TAIL not in p.role
    for c in range(55):
        assert (p.role[c], p.partner[c]) == (U, c + 55)
        assert (p.role[c + 55], p.partner[c + 55]) == (V, c)
    assert set(p.role[110:]) == {PLAIN} and set(p.partner[110:]) == {-1}
    assert p.method[:992] == (0,) * 992
    assert p.method[992:1008] == (1,) * 16 and p.method[1008:] == (2,) * 16


def case_table_encodes_the_columns():
    p = ell_plan(n_tiles=3, W=24, Cp=384, ranges=((0, 130), (130, 259)),
                 rotate=((130, 133, 2), (0, 40, 30)))
    for c in range(p.Cp):
        m, role, pm, part = decode(p.table[c])
        assert (m, role) == (p.method[c], p.role[c])
        if role in (U, V):
            assert part == p.partner[c] and pm == p.method[part]
        else:
            assert (pm, part, p.partner[c]) == (-1, 0, -1)


def case_window_straddles_a_float4_group():
    """(0, 55, 55): columns 52-54 are u and 55 is v, 108-109 v and 110-111
    plain; those groups, like the groups of one role, take the window
    path (one method, partners of the same method), the plain groups the
    float4 path."""
    p = ell_plan(**PACK)
    assert p.role[52:56] == (U, U, U, V)
    assert [p.partner[c] for c in range(52, 56)] == [107, 108, 109, 0]
    assert p.role[108:112] == (V, V, PLAIN, PLAIN)
    assert {p.path(c) for c in range(0, 112, 4)} == {"window"}
    assert {p.path(c) for c in range(112, 1024, 4)} == {"float4"}


def case_window_straddles_a_block_edge():
    """A window inside one CB=256 sub-chunk of a method that starts at
    column 200 crosses the block edge at column 256: partners in the other
    block are read from device memory."""
    p = ell_plan(n_tiles=2, W=24, Cp=512, ranges=((0, 200), (200, 500)),
                 rotate=((250, 262, 10),))
    assert p.BW == 128 and p.stage
    assert [p.partner_in_block(c) for c in (250, 255, 256, 259)] == \
        [False, False, True, True]
    assert [p.partner_in_block(c) for c in (262, 267, 268, 271)] == \
        [False, False, True, True]
    assert not p.partner_in_block(100)


def case_method_range_ends_off_a_multiple_of_4():
    p = ell_plan(n_tiles=2, W=16, Cp=384, ranges=((0, 130), (130, 259)))
    assert p.cend == 259
    assert p.method[128:132] == (0, 0, 1, 1) and p.path(128) == "scalar"
    assert p.role[256:260] == (PLAIN, PLAIN, PLAIN, TAIL)
    assert p.method[256:260] == (1, 1, 1, -1) and p.path(256) == "scalar"
    assert p.path(260) == "float4" and set(p.role[259:]) == {TAIL}


def case_block_ranges():
    p = ell_plan(n_tiles=2, W=16, Cp=384, ranges=((0, 300),))
    assert (p.BW, p.nblk, p.grid) == (128, 3, 6)
    assert [p.block(b) for b in range(6)] == [
        (0, 0, 128), (0, 128, 256), (0, 256, 384), (1, 0, 128),
        (1, 128, 256), (1, 256, 384)]


STAGING = [
    (40, 1024, 128, True),      # CONUS pack: 20 KB staged
    (160, 1024, 128, True),     # its gather layout W8: 80 KB
    (1096, 128, 64, False),     # EDGE1 restagger: rows through L1/L2
    (1320, 128, 64, False),     # its gather layout
    (40, 128, 128, True),       # a one-chunk operator (Cp = 128)
    (148, 256, 128, True),      # 74 KB: three blocks per SM
    (149, 256, 128, True),      # 74.5 KB: two
    (192, 256, 128, True),      # 96 KB, the limit
    (193, 256, 64, False),
    (2048, 512, 64, False),     # the widest slab (W_CAP)
]


def case_staging_choice(W, Cp, BW, stage):
    p = ell_plan(n_tiles=1, W=W, Cp=Cp, ranges=((0, Cp),))
    assert (p.BW, p.stage) == (BW, stage)
    assert p.smem == (W * BW * 4 if stage else 0)
    assert p.smem <= pk.STAGE_MAX
    # staged blocks per SM: 3 up to 74 KB of rows (each block also holds
    # 1 KB reserved and 1 KB of its own), else 2
    assert p.min_blocks == (0 if not stage else 3 if p.smem <= 74 * 1024
                            else 2)


REFUSED = [
    (dict(rotate=((100, 120, 30),), ranges=((0, 140),)), "outside"),
    (dict(rotate=((0, 10, 20),)), "share column"),
    (dict(Cp=200), "multiple of 128"),
    (dict(ranges=tuple((i, i + 1) for i in range(9))), "ranges"),
    (dict(ranges=((0, 10), (20, 30))), "contiguously"),
    (dict(W=0), "W=0"),
]


def case_refuses(kw, match):
    args = dict(n_tiles=1, W=8, Cp=256, ranges=((0, 256),))
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        ell_plan(**args)


CASES = [pytest.param(fn, (), id=name[5:])
         for name, fn in list(globals().items())
         if name.startswith("case_") and name not in (
             "case_staging_choice", "case_refuses")]
CASES += [pytest.param(case_staging_choice, v, id="staging-W{}-Cp{}".format(
    *v)) for v in STAGING]
CASES += [pytest.param(case_refuses, v, id=f"refuses-{v[1].replace(' ', '_')}")
          for v in REFUSED]


@pytest.mark.parametrize("case,args", CASES)
def test_ell_plan(case, args):
    case(*args)
