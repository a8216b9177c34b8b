"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: every test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import). On a GPU machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Results must be bit-identical (the arithmetic is exact mod p).
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import aa_match, ops, ripple, ss_matmul  # noqa: E402,E501

P = 2**31 - 1
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _field(shape, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, P, shape, generator=g, dtype=torch.int32, device=dev)
    hot = torch.rand(shape, generator=g, device=dev) < 0.125
    return torch.where(hot, torch.full_like(x, P - 1), x)


@pytest.mark.parametrize("sa,sb", [
    ((37, 1000), (1000, 300)), ((3, 5, 4097), (3, 4097, 129)),
    ((4, 7, 513), (513, 200)), ((2, 0, 64), (2, 64, 10)),
    ((2, 3, 64), (2, 64, 0)), ((2, 3, 300000), (2, 300000, 64)),
    ((1, 17, 131), (1, 131, 255))])
def test_ss_matmul_kernel_equals_plain(cuda, sa, sb):
    a, b = _field(sa, 1, cuda), _field(sb, 2, cuda)
    ops.reset_launch_counts()
    got = ops.ss_matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, ss_matmul.ss_matmul_plain(a, b))
    empty = 0 in sa or 0 in sb
    tall = ss_matmul.is_tall_skinny(sa[-2], sa[-1], sb[-1])
    counts = ops.launch_counts()
    assert counts["ss_matmul_tall" if tall else "ss_matmul"] \
        == (0 if empty else 1)
    assert counts["ss_matmul" if tall else "ss_matmul_tall"] == 0


@pytest.mark.parametrize("c,b,n,w,a", [(3, 1, 1000, 8, 69), (2, 3, 77, 5, 33),
                                       (4, 2, 33, 12, 69)])
def test_aa_match_batch_kernel_equals_plain(cuda, c, b, n, w, a):
    col = _field((c, b, n, w, a), 3, cuda)
    pat = _field((c, b, w, a), 4, cuda)
    got = ops.aa_match_batch(col, pat)
    torch.cuda.synchronize()
    assert torch.equal(got, aa_match.aa_match_batch_plain(col, pat))
    one = col[:, :1].expand(c, b, n, w, a)
    ops.reset_launch_counts()
    assert torch.equal(ops.aa_match_batch(one, pat),
                       aa_match.aa_match_batch_plain(one, pat))
    assert ops.launch_counts()["aa_match_batch"] == 1     # one read of col


def test_aa_match_rows_kernel_equals_plain(cuda):
    rel = _field((3, 500, 4, 8, 69), 5, cuda)
    pat = _field((3, 5, 8, 69), 6, cuda)
    blocks = dict(columns=[0, 3, 3, 1, 2], starts=[0, 17, 250, 499, 100],
                  lengths=[500, 40, 250, 1, 0])
    got = ops.aa_match_rows(rel, pat=pat, height=500, **blocks)
    torch.cuda.synchronize()
    assert torch.equal(got, aa_match.aa_match_rows_plain(
        rel, pat=pat, height=500, **blocks))


@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("k", [1, 2, 5, 8, 13])
def test_ripple_segment_kernel_equals_plain(cuda, k, init):
    lanes = (3, 4, 1027)                     # not a multiple of the block
    a, b = _field(lanes + (k,), 7, cuda), _field(lanes + (k,), 8, cuda)
    carry = None if init else _field(lanes, 9, cuda)
    ops.reset_launch_counts()
    got = ops.ripple_segment(a, b, carry)
    torch.cuda.synchronize()
    want = ripple.ripple_segment_plain(a, b, carry)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    counts = ops.launch_counts()
    assert (counts["ripple_carry"], counts["ripple_segment"]) \
        == ((1, 0) if k == 1 else (0, 1))


def test_ripple_kernel_reads_strided_views(cuda):
    full, other = _field((3, 4, 600, 13), 10, cuda), _field((3, 4, 600, 13),
                                                           11, cuda)
    a, b = full[:, :, 77:377, 8:13], other[:, :, 77:377, 8:13]
    carry = _field((3, 4, 700), 12, cuda)[:, :, 100:400]
    got = ops.ripple_segment(a, b, carry)
    want = ripple.ripple_segment_plain(a, b, carry)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    col = _field((3, 600, 8), 13, cuda)[:, None].expand(3, 2, 600, 8)
    carry = _field((3, 2, 600), 14, cuda)
    got = ops.ripple_carry(col[..., 0], other[:, :2, :, 0], carry)
    want = ripple.ripple_segment_plain(col[..., :1], other[:, :2, :, :1],
                                       carry)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    empty = ops.ripple_segment(a[:, :, :0], b[:, :, :0])
    assert empty[0].shape == (3, 4, 0)


def _ripple_equal(a, b, carry):
    """Kernel vs plain, bit for bit; -> the route that launched."""
    before = ops.ripple_route_counts()
    got = ripple.ripple_segment_cuda(a, b, carry)
    torch.cuda.synchronize()
    want = ripple.ripple_segment_plain(a, b, carry)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    after = ops.ripple_route_counts()
    (took,) = [r for r in after if after[r] != before[r]]
    return took


@pytest.mark.parametrize("layout,route", [("bit_major", "bit_major"),
                                          ("interleaved", "strided")])
@pytest.mark.parametrize("carry_kind", ["init", "aligned", "unaligned"])
@pytest.mark.parametrize("k", range(1, 14))
def test_ripple_routes_equal_plain(cuda, k, carry_kind, layout, route):
    """Both routes at every k, LSB and carried (a carry whose rows are
    16-byte aligned, and one whose rows are not), on 1,027 lanes a row (a
    ragged tail of 4-lane groups), at the bit offset 13 − k: bit-major
    planes on the bit-major route, interleaved rows on the strided one."""
    src = [_field((3, 2, 1027, 13), 20 + i, cuda) for i in range(3)]
    if layout == "bit_major":
        rows = ripple.bit_major(src, dim=1)                  # (3, 6, n, 13)
    else:
        rows = torch.cat(src, dim=1)                         # interleaved
    a, b = rows[:, :4, :, 13 - k:], rows[:, 2:, :, 13 - k:]
    carry = {"init": None,
             "aligned": _field((3, 4, 1028), 23, cuda)[..., :1027],
             "unaligned": _field((3, 4, 1027), 24, cuda)}[carry_kind]
    assert _ripple_equal(a, b, carry) == route


def test_ripple_views_take_the_planned_route(cuda):
    """The views the paths and callers pass, each on the route the plan
    names: bit-major shard slices at 16-byte and 4-byte offsets, a column
    broadcast across the batch, the tournament's pair views of bit-major
    and of interleaved candidates and its operands built by
    bit_major_where, one-lane rows and 4-byte tails."""
    full = ripple.bit_major([_field((3, 2, 600, 13), 30, cuda)], dim=1)
    other = ripple.bit_major([_field((3, 2, 600, 13), 31, cuda)], dim=1)
    carry = _field((3, 2, 700), 32, cuda)
    for lo, route in ((4, "bit_major"), (77, "strided")):
        a, b = full[:, :, lo:lo + 300, 8:13], other[:, :, lo:lo + 300, 8:13]
        assert _ripple_equal(a, b, carry[..., lo:lo + 300]) == route
    col = ripple.bit_major([_field((3, 1, 600, 8), 33, cuda)], dim=1)
    wide = col.expand(3, 4, 600, 8)
    assert wide.stride(1) == 0
    assert _ripple_equal(wide, other[:, :1, :, :8].expand(3, 4, 600, 8),
                         None) == "bit_major"
    x1, x2 = full[:, :, 0::2, :8], full[:, :, 1::2, :8]
    assert _ripple_equal(x1, x2, None) == "strided"
    is_min = torch.tensor([True, False], device=cuda)[None, :, None, None]
    lhs = ripple.bit_major_where(is_min, x1, x2)
    rhs = ripple.bit_major_where(is_min, x2, x1)
    assert _ripple_equal(lhs, rhs, None) == "bit_major"
    inter = _field((3, 2, 601, 13), 34, cuda)
    x1, x2 = inter[:, :, 0:600:2, :8], inter[:, :, 1:600:2, :8]
    assert _ripple_equal(x1, x2, None) == "strided"
    for lanes in (1, 2, 3, 5):
        a = ripple.bit_major([_field((3, 2, lanes, 13), 35, cuda)], dim=1)
        b = ripple.bit_major([_field((3, 2, lanes, 13), 36, cuda)], dim=1)
        c = _field((3, 2, lanes), 37, cuda)
        assert _ripple_equal(a[..., :5], b[..., :5], c) == "bit_major"


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_aa_slide_batch_kernel_equals_plain(cuda, k):
    c, b, n, w, a = 3, 2, 1001, 8, 69            # ragged n
    col = _field((c, b, n, w, a), 15, cuda)
    pat = _field((c, b, k, a), 16, cuda)
    ops.reset_launch_counts()
    got = ops.aa_slide_batch(col, pat)
    torch.cuda.synchronize()
    assert got.shape == (c, b, n, w - k + 1)
    assert torch.equal(got, aa_match.aa_slide_batch_plain(col, pat))
    assert ops.launch_counts()["aa_slide_batch"] == 1
    one = col[:, :1].expand(c, b, n, w, a)       # B-stride 0
    assert torch.equal(ops.aa_slide_batch(one, pat),
                       aa_match.aa_slide_batch_plain(one, pat))


def test_aa_slide_rows_kernel_equals_plain(cuda):
    rel = _field((3, 500, 4, 8, 69), 17, cuda)
    pat = _field((3, 5, 3, 69), 18, cuda)
    blocks = dict(columns=[0, 3, 3, 1, 2], starts=[0, 17, 250, 499, 100],
                  lengths=[500, 40, 250, 1, 0])
    got = ops.aa_slide_rows(rel, pat=pat, height=500, **blocks)
    torch.cuda.synchronize()
    assert torch.equal(got, aa_match.aa_slide_rows_plain(
        rel, pat=pat, height=500, **blocks))
    full = torch.full((2, 1, 40, 5, 7), P - 1, dtype=torch.int32,
                      device=cuda)
    tile = torch.full((2, 1, 2, 7), P - 1, dtype=torch.int32, device=cuda)
    assert torch.equal(ops.aa_slide_batch(full, tile),
                       aa_match.aa_slide_batch_plain(full, tile))


# ---------------------------------------------------------------------------
# the match and slide kernels: where their staging is tightest
# ---------------------------------------------------------------------------

def _staging_edge(case, dev):
    """-> (column stack (c, B, n, W, A), value of a constant pattern or
    None for a random one, 16 if the stack must take 16-byte copies)."""
    if case in ("all-(p-1)", "all-(2^31-1)"):
        value = P - 1 if case == "all-(p-1)" else 2**31 - 1
        return torch.full((2, 1, 300, 8, 69), value, dtype=torch.int32,
                          device=dev), value, 16
    if case.startswith("prefix-"):         # k·A words: a partial last copy
        k = int(case[-1])
        rel = _field((3, 700, 5, 8, 69), 40, dev)
        return rel[..., :k, :][:, :, 2][:, None], None, 16
    if case == "tail":                     # W·A·4 = 660 B, pitch 168 words
        buf = _field((2, 3, 301, 168), 41, dev)
        return buf[..., :165].unflatten(-1, (5, 33)), None, 16
    cap = aa_match.tile_layout(8, 69, 2, 10**6)[2]       # "chunked"
    cap = max(cap, aa_match.tile_layout(8, 69, 8, 10**6)[2])
    one = _field((2, 1, 300, 8, 69), 42, dev)
    return one.expand(2, cap + 5, 300, 8, 69), None, 16


@pytest.mark.parametrize("kind", ["match", "slide"])
@pytest.mark.parametrize("case", ["all-(p-1)", "all-(2^31-1)", "prefix-1",
                                  "prefix-4", "tail", "chunked"])
def test_aa_kernels_staging_edges(cuda, case, kind):
    """Extreme operands at full W, prefix views whose rows are not a
    multiple of 16 bytes, a W·A·4 not a multiple of 16 on the 16-byte
    route, and a B-stride-0 stack cut into chunks: bit-identical, one
    launch each."""
    col, value, route = _staging_edge(case, cuda)
    c, b, n, w, a = col.shape
    k = w if kind == "match" else min(2, w)
    shape = (c, b, k, a)
    pat = (_field(shape, 43, cuda) if value is None else
           torch.full(shape, value, dtype=torch.int32, device=cuda))
    pl = aa_match.batch_plan(col, 0 if kind == "match" else k)
    assert pl.copy_bytes == route
    if case == "chunked":
        assert pl.patterns < b and len(pl.chunks) == 2
    fn, plain, counter = (
        (ops.aa_match_batch, aa_match.aa_match_batch_plain, "aa_match_batch")
        if kind == "match" else
        (ops.aa_slide_batch, aa_match.aa_slide_batch_plain, "aa_slide_batch"))
    ops.reset_launch_counts()
    got = fn(col, pat)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(col, pat))
    assert ops.launch_counts()[counter] == 1


def test_aa_slide_kernel_tile_row_passes(cuda):
    """Words of 1,300 one-symbol positions against a tile of 1,173 rows
    (M = 128): one tuple's dots exceed shared memory, so a tile's rows
    take several passes and each window's chain carries between them."""
    col = _field((1, 2, 37, 1300, 1), 46, cuda)
    pat = _field((1, 2, 1173, 1), 47, cuda)
    pl = aa_match.batch_plan(col, 1173)
    assert 1 < pl.k_pass < 1173
    ops.reset_launch_counts()
    got = ops.aa_slide_batch(col, pat)
    torch.cuda.synchronize()
    assert torch.equal(got, aa_match.aa_slide_batch_plain(col, pat))
    assert ops.launch_counts()["aa_slide_batch"] == 1


@pytest.mark.parametrize("kind", ["match", "slide"])
@pytest.mark.parametrize("height,lengths", [(1, [0, 1, 0]), (64, [0, 0, 0]),
                                            (300, [300, 1, 0])])
def test_aa_rows_zero_and_one_row_blocks(cuda, kind, height, lengths):
    """Blocks of no tuple and of one, in the rows form: zeros past each
    block's length, and a launch whose every block is empty."""
    rel = _field((3, 700, 5, 8, 69), 44, cuda)
    k = 8 if kind == "match" else 3
    pat = _field((3, 3, k, 69), 45, cuda)
    blocks = dict(columns=[1, 1, 3], starts=[0, 699, 5], lengths=lengths,
                  pat=pat, height=height)
    fn, plain = ((ops.aa_match_rows, aa_match.aa_match_rows_plain)
                 if kind == "match" else
                 (ops.aa_slide_rows, aa_match.aa_slide_rows_plain))
    got = fn(rel, **blocks)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(rel, **blocks))


@pytest.mark.parametrize("m", [1, 3, 17, 69, 255, 256])
@pytest.mark.parametrize("form", ["3x3", "3x2"])
def test_ss_matmul_tall_kernel_equals_plain(cuda, m, form):
    k, n = 4099, 129                             # K not a multiple of 32
    a = _field((3, m, k), 19, cuda)
    b = _field((3, k, n) if form == "3x3" else (k, n), 20, cuda)
    assert ss_matmul.is_tall_skinny(m, k, n)
    ops.reset_launch_counts()
    got = ops.ss_matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, ss_matmul.ss_matmul_plain(a, b))
    counts = ops.launch_counts()
    assert (counts["ss_matmul_tall"], counts["ss_matmul"]) == (1, 0)


def test_ss_matmul_tall_kernel_edges(cuda):
    for sa, sb in [((2, 1, 70000), (2, 70000, 1)),        # N = 1, K split
                   ((1, 256, 8192), (1, 8192, 1000)),
                   ((2, 0, 2048), (2, 2048, 5))]:
        a, b = _field(sa, 21, cuda), _field(sb, 22, cuda)
        assert torch.equal(ss_matmul.ss_matmul_tall_cuda(a, b),
                           ss_matmul.ss_matmul_plain(a, b))
    full = torch.full((2, 256, 3000), P - 1, dtype=torch.int32, device=cuda)
    other = torch.full((2, 3000, 40), P - 1, dtype=torch.int32, device=cuda)
    assert torch.equal(ss_matmul.ss_matmul_tall_cuda(full, other),
                       ss_matmul.ss_matmul_plain(full, other))
    big = torch.full((1, 4, 2048), 2**31 - 1, dtype=torch.int32, device=cuda)
    assert torch.equal(ss_matmul.ss_matmul_tall_cuda(big, big[0].T),
                       ss_matmul.ss_matmul_plain(big, big[0].T))


def test_ss_matmul_tall_kernel_reads_shard_slices(cuda):
    """An embedding lookup's vocab shard: A is a column slice
    ``stacked[:, :, lo:hi]`` (unit last stride, row stride V), B a row
    slice of the table; lo % 4 != 0 takes the 4-byte copy route."""
    stacked = _field((4, 8, 6001), 23, cuda)
    table = _field((4, 6001, 96), 24, cuda)
    for lo, hi in ((0, 2000), (2000, 4001), (4001, 6001), (3, 3003)):
        a, b = stacked[:, :, lo:hi], table[:, lo:hi]
        assert ss_matmul.is_tall_skinny(8, hi - lo, 96)
        assert torch.equal(ops.ss_matmul(a, b),
                           ss_matmul.ss_matmul_plain(a, b))


def _onehot_case(toks, a1, c):
    """One ``share_onehot`` call: bit-equal to the plain version, one
    launch (none at M = 0), on the route ``onehot_plan`` names for its
    operands."""
    ops.reset_launch_counts()
    got = ops.share_onehot(toks, a1, n_shares=c)
    torch.cuda.synchronize()
    assert got.shape == (c, *a1.shape)
    assert torch.equal(got, ss_matmul.share_onehot_plain(toks, a1,
                                                         n_shares=c))
    route = ss_matmul.onehot_plan(a1.data_ptr(), got.data_ptr(), a1.stride(),
                                  *a1.shape)
    launched = int(a1.shape[0] > 0)
    assert ops.launch_counts()["share_onehot"] == launched
    assert ops.onehot_route_counts() == {
        r: launched * (r == route) for r in ss_matmul.ONEHOT_ROUTES}
    return route


@pytest.mark.parametrize("c", [1, 4, 20])
@pytest.mark.parametrize("m,v", [(0, 1000), (1, 1), (17, 1000), (300, 1003),
                                 (256, 4096)] + [
    (m, v) for v in (1000, 1001, 1002, 1003, 3) for m in (1, 3, 4, 8, 17)])
def test_share_onehot_kernel_equals_plain(cuda, m, v, c):
    """Every V % 4 (and V < 4, where a quad spans rows) against M % 4, so
    M·V % 4 takes every value: the quad route exactly where it is 0."""
    g = torch.Generator(device=cuda).manual_seed(25)
    toks = torch.randint(0, v, (m,), generator=g, device=cuda)
    if m >= 4:                       # first, last, a repeat and the padding
        toks[:4] = torch.tensor([0, v - 1, int(toks[5 % m]), -1])
    route = _onehot_case(toks, _field((m, v), 26, cuda), c)
    assert m == 0 or route == ("quad" if m * v % 4 == 0 else "word")


def test_share_onehot_kernel_extremes_and_strides(cuda):
    a1 = torch.full((5, 1024), P - 1, dtype=torch.int32, device=cuda)
    toks = torch.tensor([0, 1023, -1, 5000, 7], device=cuda)
    assert torch.equal(ops.share_onehot(toks, a1, n_shares=20),
                       ss_matmul.share_onehot_plain(toks, a1, n_shares=20))
    wide = _field((6, 1030), 27, cuda)       # rows 4-byte but not 16-byte
    for view in (wide[:, 3:1027], wide[:, :1024], wide[::2, 1:9]):
        t = torch.arange(view.shape[0], device=cuda) * 3
        assert torch.equal(ops.share_onehot(t, view, n_shares=4),
                           ss_matmul.share_onehot_plain(t, view, n_shares=4))


@pytest.mark.parametrize("v", [1001, 1002, 1003, 6])
def test_share_onehot_quad_across_a_row_boundary(cuda, v):
    """Hot words on both sides of a row boundary inside one 16-byte quad:
    the last id of one row, the first of the next (M·V % 4 == 0)."""
    m = 8
    toks = torch.tensor([v - 1, 0] * 4, device=cuda)
    toks[4:6] = torch.tensor([v - 2, 1])
    assert _onehot_case(toks, _field((m, v), 30, cuda), 4) == "quad"


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_share_onehot_out_of_range_ids(cuda, dtype):
    """Ids −5, V and 2³¹ + 3 (int64 only) give zero one-hot rows: in flat
    addressing V would otherwise mark the next row's word 0, −1 the
    previous row's last word."""
    v = 1002
    ids = [-5, v, 0, v - 1, -1, 2**31 + 3, 7, v]
    if dtype == torch.int32:
        ids[5] = 2**31 - 1
    toks = torch.tensor(ids, dtype=dtype, device=cuda)
    assert _onehot_case(toks, _field((8, v), 31, cuda), 20) == "quad"


def test_share_onehot_strided_views_take_the_word_route(cuda):
    wide = _field((6, 1030), 32, cuda)
    base = _field((4 * 1000 + 1,), 33, cuda)
    for view in (wide[:, 3:1027], wide[::2, 1:9], wide[:, :1000],
                 wide[:, ::2], _field((9, 6), 35, cuda).t(),
                 base[1:].view(4, 1000)):
        t = torch.arange(view.shape[0], device=cuda) * 3
        assert _onehot_case(t, view, 4) == "word"
    toks = torch.tensor([[5, 1], [0, 1], [999, 1], [-1, 1]],
                        device=cuda)[:, 0]          # token stride 2
    assert _onehot_case(toks, _field((4, 1000), 34, cuda), 4) == "quad"


# ---------------------------------------------------------------------------
# the int8 tensor-core matmul kernels: byte-limb edges, both entry points
# ---------------------------------------------------------------------------

_KERNELS = {"tall": ss_matmul.ss_matmul_tall_cuda,
            "general": ss_matmul.ss_matmul_cuda}


@pytest.mark.parametrize("dk", [-1, 0, 1, ss_matmul.K_CHUNK + 1])
@pytest.mark.parametrize("kernel,m", [("tall", 1), ("tall", 8), ("tall", 9),
                                      ("tall", 33), ("tall", 256),
                                      ("general", 257),
                                      ("general", 1000)])
def test_ss_matmul_kernels_chunk_boundaries(cuda, kernel, m, dk):
    """K = K_CHUNK − 1, K_CHUNK, K_CHUNK + 1 and 2·K_CHUNK + 1 (where the
    s32 diagonal sums fold), N = 70 (not a multiple of the 64-column
    tile)."""
    k = ss_matmul.K_CHUNK + dk
    a, b = _field((2, m, k), 30 + m, cuda), _field((2, k, 70), 31 + dk, cuda)
    got = _KERNELS[kernel](a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, ss_matmul.ss_matmul_plain(a, b))


@pytest.mark.parametrize("value", [P - 1, 2**31 - 1])
@pytest.mark.parametrize("kernel,m", [("tall", 8), ("tall", 33),
                                      ("general", 300)])
def test_ss_matmul_kernels_extremes(cuda, kernel, m, value):
    """Constant operands at K = 2·K_CHUNK + 1: every byte limb at its
    largest, three chunks, the last of one term."""
    k = 2 * ss_matmul.K_CHUNK + 1
    a = torch.full((2, m, k), value, dtype=torch.int32, device=cuda)
    b = torch.full((2, k, 130), value, dtype=torch.int32, device=cuda)
    got = _KERNELS[kernel](a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, ss_matmul.ss_matmul_plain(a, b))
    assert (got == (k * value * value) % P).all()


@pytest.mark.parametrize("kernel", ["tall", "general"])
def test_ss_matmul_kernels_shard_slices_and_shared_operand(cuda, kernel):
    """Vocab-shard column slices of A at offsets that are not a multiple of
    4 (4-byte copies; ``lo = 3`` and the S = 3 split of 151,936 ids) and
    the (3, 2) rank (B-stride 0)."""
    stacked = _field((4, 9, 151936), 32, cuda)
    table = _field((4, 151936, 70), 33, cuda)
    for lo, hi in ((3, 3003), (0, 50645), (50645, 101290),
                   (101290, 151936)):
        a, b = stacked[:, :, lo:hi], table[:, lo:hi]
        assert torch.equal(_KERNELS[kernel](a, b),
                           ss_matmul.ss_matmul_plain(a, b))
    a, b = _field((3, 69, 9000), 34, cuda), _field((9000, 130), 35, cuda)
    assert torch.equal(_KERNELS[kernel](a, b),
                       ss_matmul.ss_matmul_plain(a, b))


# ---------------------------------------------------------------------------
# the §3.3 joins' operand forms (W = 8, A = 69, relation rows of m·W·A)
# ---------------------------------------------------------------------------

_JW, _JA = 8, 69


def _join_cols(cuda, nx=600, ny=77, seed=40):
    """Column 0 of a 5-attribute parent and a 3-attribute child relation:
    strided (c, n, W, A) views whose rows are m·W·A words apart."""
    rel_x = _field((3, nx, 5, _JW, _JA), seed, cuda)
    rel_y = _field((3, ny, 3, _JW, _JA), seed + 1, cuda)
    return rel_x[:, :, 0], rel_y[:, :, 0]


@pytest.mark.parametrize("orient", ["fetch_rows", "pairs"])
@pytest.mark.parametrize("j", range(_JW))
def test_join_match_position_views(cuda, j, orient):
    """One word position's K = 69 product on views whose base lies j·69
    words into a row (4-byte aligned, 16-byte only at j = 0 and 4), in the
    fetch-row orientation the port uses, Y_j @ X_jᵀ, and in the
    reference's X_j @ Y_jᵀ; K = 69 is not a multiple of the 64-term stage."""
    col_x, col_y = _join_cols(cuda)
    xj, yj = col_x[:, :, j], col_y[:, :, j]
    a, b = ((yj, xj.transpose(-1, -2)) if orient == "fetch_rows"
            else (xj, yj.transpose(-1, -2)))
    ops.reset_launch_counts()
    got = ops.ss_matmul(a, b)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ss_matmul"] == 1
    assert torch.equal(got, ss_matmul.ss_matmul_plain(a, b))


@pytest.mark.parametrize("n", [1, 1023])
def test_join_match_ragged_sides(cuda, n):
    """N = 1 and N = 1,023 columns (and as many rows, the other way round),
    the 552-term aggregate contraction included."""
    col_x, col_y = _join_cols(cuda, ny=n, seed=42)
    for a, b in ((col_x[:, :, 3], col_y[:, :, 3].transpose(-1, -2)),
                 (col_y[:, :, 5], col_x[:, :, 5].transpose(-1, -2)),
                 (col_y.flatten(-2), col_x.flatten(-2).transpose(-1, -2))):
        assert torch.equal(ops.ss_matmul(a, b),
                           ss_matmul.ss_matmul_plain(a, b))


def test_join_aggregate_flattened_columns(cuda):
    """The aggregate form's K = 552 product: the child column flattened as
    a strided (c, ny, W·A) view, the parent's transposed into a copy."""
    col_x, col_y = _join_cols(cuda, seed=44)
    a = col_y.flatten(-2)
    b = col_x.flatten(-2).transpose(-1, -2)
    assert a.stride(-2) == 3 * _JW * _JA
    ops.reset_launch_counts()
    got = ops.ss_matmul(a, b)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ss_matmul"] == 1
    assert torch.equal(got, ss_matmul.ss_matmul_plain(a, b))


@pytest.mark.parametrize("k", [_JA, _JW * _JA])
def test_join_match_extremes(cuda, k):
    """All-(p−1) operands at the position and aggregate depths."""
    a = torch.full((3, 300, k), P - 1, dtype=torch.int32, device=cuda)
    b = torch.full((3, k, 1025), P - 1, dtype=torch.int32, device=cuda)
    got = ops.ss_matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, ss_matmul.ss_matmul_plain(a, b))
    assert (got == k % P).all()                 # (p−1)² ≡ 1


def test_join_match_matrix_on_card_equals_cpu(cuda):
    """``match_matrix`` and a flattened (c·B) group of 3 joins — two on one
    parent column (a B-stride-0 view) — on the card: W launches for the
    chain, one for the aggregate form, and the CPU path's shares exactly."""
    from repro_torch.api import backends
    col_x, col_y = _join_cols(cuda, seed=46)
    got = ops.match_matrix(col_x, col_y)
    assert torch.equal(got.cpu(), ops.match_matrix(col_x.cpu(),
                                                   col_y.cpu()))
    rel_y = _field((3, 77, 3, _JW, _JA), 48, cuda)
    bx = torch.stack([col_x, col_x, col_x], dim=1)
    bx_view = col_x[:, None].expand(3, 3, *col_x.shape[1:])
    by = torch.stack([col_y, rel_y[:, :, 0], rel_y[:, :, 2]], dim=1)
    ops.reset_launch_counts()
    chain = ops.match_matrix_batch(bx_view, by)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ss_matmul"] == _JW
    assert torch.equal(chain, ops.match_matrix_batch(bx, by))
    assert torch.equal(chain.cpu(), ops.match_matrix_batch(bx.cpu(),
                                                           by.cpu()))
    agg = backends.aggregate_match_matrix(backends.get_backend("cuda"))
    ops.reset_launch_counts()
    got = agg(bx_view, by)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ss_matmul"] == 1
    assert torch.equal(got.cpu(), agg(bx.cpu(), by.cpu()))


# ---------------------------------------------------------------------------
# serving: the kernels launched from pool and MapReduce threads
# ---------------------------------------------------------------------------

_SERVE_ROWS = [[f"E{i:04d}", ("Zorro", "Quinn", "Adam", "Eve")[i % 4],
                f"L{i % 7}", str(100 + 37 * i % 1900),
                ("Sale", "Legal")[i % 2]] for i in range(96)]


def _serve_db(cuda):
    from repro_torch.core import Codec, outsource
    return outsource(_SERVE_ROWS, n_shares=20,
                     column_names=["EmployeeId", "FirstName", "LastName",
                                   "Salary", "Department"],
                     codec=Codec(word_length=8), degree=1, seed=3,
                     numeric_columns={3: 13}, device=cuda)


def _serve_plans():
    from repro_torch import api
    return [api.Count(api.Eq("FirstName", "Quinn")),
            api.Select(api.Eq("FirstName", "Zorro"), strategy="one_round"),
            api.Select(api.Eq("LastName", "L3"), strategy="tree"),
            api.RangeCount(api.Between("Salary", 500, 1500),
                           reduce_every=8)]


def test_threaded_and_mapreduce_equal_serial_on_card(cuda):
    from repro_torch import api
    from repro_torch.core import ShardedRelation, ThreadedDispatcher
    from repro_torch.runtime import MapReduceRunner, WorkerPool, mapreduce
    db = _serve_db(cuda)
    want = api.QueryClient(db, 4).run_batch(_serve_plans())
    pool = ThreadedDispatcher(2)
    ops.reset_launch_counts()
    threaded = api.QueryClient(ShardedRelation(db, shards=2,
                                               dispatcher=pool.handle()),
                               4).run_batch(_serve_plans())
    pool.close()
    # worker 3 outsleeps the lease: every 4-split op re-executes tasks
    ex = api.MapReduceExecutor(MapReduceRunner(
        WorkerPool(4, dead_workers={2}, slow_workers={3: 0.6}),
        lease_s=0.3, max_attempts=8), n_splits=4)
    mapped = api.QueryClient(db, 4, executor=ex).run_batch(_serve_plans())
    for th in threading.enumerate():       # the stragglers' late copies
        if th.name == mapreduce.THREAD_NAME:
            th.join(timeout=10)
    torch.cuda.synchronize()
    for a, b, c in zip(want, threaded, mapped):
        for r in (b, c):
            assert (r.count, r.rows, r.addresses, r.strategy) == \
                (a.count, a.rows, a.addresses, a.strategy)
            assert r.ledger.as_dict() == a.ledger.as_dict()
    counts = ops.launch_counts()
    assert counts["aa_match_batch"] > 0 and counts["ripple_segment"] > 0
    assert counts["ss_matmul"] + counts["ss_matmul_tall"] > 0
    assert ex.runner.reexecutions > 0


def test_kernel_failure_on_pool_thread_is_the_requests_error(cuda):
    import _torch_serving as _serving
    from repro_torch import api
    from repro_torch.core import ThreadedDispatcher
    from repro_torch.launch import QueryServer
    db = _serve_db(cuda)
    seen = []
    raising = _serving.raising_backend()

    def ss_matmul(a, b):
        seen.append(a.device.type)
        return raising.ss_matmul(a, b)

    be = dataclasses.replace(raising, ss_matmul=ss_matmul)
    client = api.QueryClient(backend=be)
    pool = ThreadedDispatcher(2)
    client.attach(db, shards=2, dispatcher=pool.handle())
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        client.run_batch([_serve_plans()[1]])
    pool.close()
    srv = QueryServer(backend=be, pool_workers=2, max_wait_ms=5)
    srv.attach("emp", db, shards=2, key=1)
    with srv:
        bad = srv.submit(_serve_plans()[1], relation="emp")
        good = srv.submit(_serve_plans()[0], relation="emp")
        for r in (bad, good):
            r.wait(timeout=60)
    assert isinstance(bad.error, RuntimeError) and bad.result is None
    assert good.error is None and good.result.count == 24
    assert srv.client.backend is be and set(seen) == {cuda.type}


# ---------------------------------------------------------------------------
# private LM generation (slice 7)
# ---------------------------------------------------------------------------

def test_full_width_qwen_decode_matches_forward_on_card(cuda):
    """Two layers of Qwen1.5-4B at its full width (d 2,560, 20 heads, V
    151,936, bf16): prefill + one decode step equal the full forward at
    that position within the reference's bound (atol 0.12, rtol 0.05)."""
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = dataclasses.replace(configs.full("qwen1_5_4b"), n_layers=2)
    params = lm.init_params(0, cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    full = lm.forward(params, cfg, {"tokens": toks})
    _, cache = lm.prefill(params, cfg, {"tokens": toks[:, :16]}, max_len=24)
    step, _ = lm.decode_step(params, cfg, cache, 16, {"tokens": toks[:, 16:]})
    assert full.shape == (2, 17, cfg.vocab_size)
    assert bool(torch.isfinite(full).all())
    assert torch.allclose(step[:, 0], full[:, 16], atol=0.12, rtol=0.05)


def test_private_generation_equals_plaintext_on_card(cuda):
    """BatchServer with the private lookup (share_onehot + the matmul
    kernel every step) generates the tokens of a plaintext BatchServer
    over the dequantized quantized table, at smoke size."""
    from repro_torch import configs
    from repro_torch.core.queries import embed as eq
    from repro_torch.launch import BatchServer, Request
    from repro_torch.models import lm, private_embed as pe
    cfg = configs.smoke("qwen1_5_4b")
    params = lm.init_params(2, cfg)
    params["embed_shares"] = pe.setup_private_embed(
        (2, 1), params["embed"], n_shares=4).values
    plain = {k: v for k, v in params.items() if k != "embed_shares"}
    plain["embed"] = eq.dequantize_from_field(eq.quantize_to_field(
        params["embed"])).to(params["embed"].dtype)
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, (4, 12)).astype(np.int32)

    def serve(p, c):
        reqs = [Request(prompt=x.copy(), max_new=6) for x in prompts]
        return np.stack([r.out for r in BatchServer(p, c, max_len=24)
                         .serve(reqs)])

    ops.reset_launch_counts()
    priv = serve(params, dataclasses.replace(cfg, private_embed=True))
    counts = ops.launch_counts()
    assert np.array_equal(priv, serve(plain, cfg))
    assert counts["share_onehot"] == 6
    assert counts["ss_matmul"] + counts["ss_matmul_tall"] == 6


@pytest.mark.parametrize("strict", [False, True])
def test_mesh_dispatcher_equals_serial_on_card(cuda, strict):
    """MeshDispatcher(devices=None) — the current card — gives the serial
    dispatcher's rows and ledgers at 2 shards, and an EmbedLookup's
    embeddings; ``strict_transfers`` runs each cloud step under CUDA's
    sync debug mode "error", so a host copy inside one would raise."""
    from repro_torch import api
    from repro_torch.models import private_embed as pe
    db = _serve_db(cuda)
    serial = api.QueryClient(db, 4)
    serial.attach(shards=2)
    want = serial.run_batch(_serve_plans())
    mesh = api.MeshDispatcher(strict_transfers=strict)
    client = api.QueryClient(db, 4)
    plane = client.attach(shards=2, dispatcher=mesh)
    got = client.run_batch(_serve_plans())
    for a, b in zip(want, got):
        assert (b.count, b.rows, b.addresses, b.strategy) == \
            (a.count, a.rows, a.addresses, a.strategy)
        assert b.ledger.as_dict() == a.ledger.as_dict()
    placed = plane.stats.transfer_bytes
    client.run_batch(_serve_plans()[:1])
    assert plane.stats.transfer_bytes == placed > 0
    assert mesh.predicted_cost()["programs"] >= 1

    table = pe.setup_private_embed(5, torch.randn((4096, 64), device=cuda),
                                   n_shares=4)
    plan = api.EmbedLookup(tokens=(7, 4095, 7, 0))
    out = []
    for disp in (None, mesh):
        c = api.QueryClient(seed=1)
        c.attach(pe.as_embed_relation(table), name="emb", shards=2,
                 dispatcher=disp)
        out.append(c.run(plan, relation="emb"))
    assert np.array_equal(out[0].embeddings, out[1].embeddings)
    assert out[0].ledger.as_dict() == out[1].ledger.as_dict()


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def test_kernels_launch_on_their_operands_card(two_cards):
    """Every kernel on ``cuda:1`` tensors while ``cuda:0`` is current: the
    launcher makes the operands' card current, so the shared-memory limit,
    the occupancy query and the SM count are that card's, and the kernel
    runs in its stream; each result equals its plain version."""
    home, other = two_cards
    ops.reset_launch_counts()
    with torch.cuda.device(home):
        a, b = _field((3, 300, 700), 1, other), _field((3, 700, 90), 2, other)
        # K >= 1024 and >= 8·max(M, N): the tall entry
        t, tb = _field((3, 8, 1100), 3, other), _field((3, 1100, 90), 11,
                                                        other)
        col = _field((3, 2, 257, 8, 69), 4, other)
        pat, tile = _field((3, 2, 8, 69), 5, other), _field((3, 2, 3, 69), 6,
                                                            other)
        rel = _field((3, 257, 4, 8, 69), 7, other)
        x, y = _field((3, 4, 1027, 8), 8, other), _field((3, 4, 1027, 8), 9,
                                                         other)
        toks = torch.arange(16, device=other) * 61
        a1 = _field((16, 1000), 10, other)
        rows = dict(columns=[0, 3], starts=[0, 100], lengths=[257, 57],
                    height=257)
        cases = [
            (ops.ss_matmul(a, b), ss_matmul.ss_matmul_plain(a, b)),
            (ops.ss_matmul(t, tb), ss_matmul.ss_matmul_plain(t, tb)),
            (ops.aa_match_batch(col, pat),
             aa_match.aa_match_batch_plain(col, pat)),
            (ops.aa_match_rows(rel, pat=pat, **rows),
             aa_match.aa_match_rows_plain(rel, pat=pat, **rows)),
            (ops.aa_slide_batch(col, tile),
             aa_match.aa_slide_batch_plain(col, tile)),
            (ops.share_onehot(toks, a1, n_shares=4),
             ss_matmul.share_onehot_plain(toks, a1, n_shares=4))]
        for k in (8, 1):
            got = ops.ripple_segment(x[..., :k], y[..., :k], None)
            want = ripple.ripple_segment_plain(x[..., :k], y[..., :k], None)
            cases += list(zip(got, want))
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(other)
    for got, want in cases:
        assert got.device == other
        assert torch.equal(got, want)
    assert all(v > 0 for v in ops.launch_counts().values())
    assert all(set(c) == {1} for c in ops.card_launch_counts().values())


def test_mesh_dispatcher_on_two_cards_equals_serial(two_cards):
    """A (1, 2) grid of two cards: cloud group 1 on ``cuda:1``, its
    operands brought there, the groups assembled on ``cuda:0``; the rows
    and ledgers are the serial dispatcher's and no byte goes from one
    card's group to the other's."""
    from repro_torch import api
    from repro_torch.launch.mesh import make_dispatch_mesh
    home, _ = two_cards
    db = _serve_db(home)
    serial = api.QueryClient(db, 4, device=home)
    serial.attach(shards=2)
    want = serial.run_batch(_serve_plans())
    mesh = api.MeshDispatcher(make_dispatch_mesh(2), strict_transfers=True)
    client = api.QueryClient(db, 4, device=home)
    client.attach(shards=2, dispatcher=mesh)
    got = client.run_batch(_serve_plans())
    for a, b in zip(want, got):
        assert (b.count, b.rows, b.addresses) == (a.count, a.rows,
                                                  a.addresses)
        assert b.ledger.as_dict() == a.ledger.as_dict()
    assert mesh.cross_group_bytes() == 0


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    return [torch.device("cuda", i) for i in range(4)]


def test_mesh_dispatcher_on_four_cards_equals_serial(four_cards):
    """A 2 x 2 grid of four distinct cards (tuple shards over ``data``,
    cloud groups over ``model``) in strict mode: the rows and ledgers are
    the serial dispatcher's, no byte goes from one cloud group's card to
    the other's, and every kernel the serial run launches launches on
    each of the four cards."""
    from repro_torch import api
    from repro_torch.launch.mesh import make_dispatch_mesh
    home = four_cards[0]
    db = _serve_db(home)
    serial = api.QueryClient(db, 4, device=home)
    serial.attach(shards=2)
    ops.reset_launch_counts()
    want = serial.run_batch(_serve_plans())
    ran = {k for k, v in ops.launch_counts().items() if v}
    mesh = api.MeshDispatcher(make_dispatch_mesh(2, devices=four_cards),
                              strict_transfers=True)
    client = api.QueryClient(db, 4, device=home)
    client.attach(shards=2, dispatcher=mesh)
    ops.reset_launch_counts()
    got = client.run_batch(_serve_plans())
    torch.cuda.synchronize()
    by_card = ops.card_launch_counts()
    for a, b in zip(want, got):
        assert (b.count, b.rows, b.addresses) == (a.count, a.rows,
                                                  a.addresses)
        assert b.ledger.as_dict() == a.ledger.as_dict()
    assert mesh.cross_group_bytes() == 0
    assert ran
    for name in ran:
        assert sorted(by_card[name]) == [0, 1, 2, 3], (name, by_card)


def _nccl_rank(rank, world, port, root):
    """A rank started as ``torchrun`` starts one, through the port's
    ``init_ranks``: its card, the group's bound device, an all-reduce and
    a barrier on the cards."""
    import json
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        dev = init_ranks()
        x = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        dist.barrier()
        out = {"device": str(dev), "current": torch.cuda.current_device(),
               "bound": str(dist.group.WORLD.bound_device_id),
               "sum": x.tolist(), "on": str(x.device)}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def test_init_ranks_binds_each_nccl_rank_to_its_card(two_cards, tmp_path):
    """Two NCCL ranks from ``torchrun``'s environment through
    ``init_ranks``: each on ``cuda:LOCAL_RANK``, made current and bound to
    the process group (so NCCL's barrier need not guess a card); an
    all-reduce and a barrier across the two cards."""
    import json
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mp.spawn(_nccl_rank, args=(2, port, str(tmp_path)), nprocs=2, join=True)
    for r in range(2):
        out = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert out["device"] == out["bound"] == out["on"] == f"cuda:{r}"
        assert out["current"] == r
        assert out["sum"] == [3.0] * 4


def _mesh_rank(rank, world, port, root):
    """A rank started as ``torchrun`` starts one, through the port's
    ``init_ranks``, then ``make_mesh`` (2, 2) and (1, 4) over the world
    (each splits its groups from the world's communicator), an all-reduce
    over each mesh dim, the process group torn down and a normal exit."""
    import json
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks, make_mesh
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    dev = init_ranks()
    sums = {}
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh(shape, ("data", "model"))
        for dim, name in enumerate(mesh.mesh_dim_names):
            x = torch.ones(2, device=dev)
            dist.all_reduce(x, group=mesh.get_group(dim))
            sums[f"{shape} {name}"] = x.tolist()
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(sums, f)


def test_ranks_end_after_meshes_on_four_cards(four_cards, tmp_path):
    """The port's ranks on four cards, as ``torchrun`` then ``init_ranks``
    then ``make_mesh`` start them: every all-reduce sums over its mesh
    dim's group, and every rank tears its process group down and ends
    within 120 s."""
    import json
    import socket
    import time

    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.start_processes(_mesh_rank, args=(4, port, str(tmp_path)),
                             nprocs=4, join=False, start_method="spawn")
    end = time.perf_counter() + 120
    while not ctx.join(timeout=1):
        if time.perf_counter() > end:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail("the ranks did not end within 120 s")
    for r in range(4):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got == {"(2, 2) data": [2.0] * 2, "(2, 2) model": [2.0] * 2,
                       "(1, 4) data": [1.0] * 2, "(1, 4) model": [4.0] * 2}


# ---------------------------------------------------------------------------
# training (slices 10 and 23)
# ---------------------------------------------------------------------------

#: (vocabulary, d_model) of each family a card trains (``chip_smoke.py``
#: slices 10 and 23): Qwen1.5-4B, Gemma3-1B (K = 262,144), MiniCPM3-4B,
#: Mamba2-2.7B, Hymba-1.5B (K = 32,001: a last 64-wide K stage of one
#: column; N = 1,600, 25 column tiles) and SeamlessM4T-medium (K =
#: 256,206: a last stage of 14)
TRAIN_TABLES = [(151936, 2560), (262144, 1152), (73448, 2560),
                (50280, 2560), (32001, 1600), (256206, 1024)]


@pytest.mark.parametrize("v,d", TRAIN_TABLES)
def test_private_embed_train_shapes_equal_plain(cuda, v, d):
    """A private-embedding train step of 4 x 512 tokens at a family's
    width: ``share_onehot`` at M = 2,048, V, c = 4, and the general
    ``ss_matmul`` (M = 2,048 is not tall) against the (4, V, d) table,
    each launched once and equal to its plain version (the contraction a
    1,024-column block at a time)."""
    m, c = 2048, 4
    g = torch.Generator(device=cuda).manual_seed(10)
    toks = torch.randint(0, v, (m,), generator=g, device=cuda)
    a1 = _field((m, v), 11, cuda)
    ops.reset_launch_counts()
    shared = ops.share_onehot(toks, a1, n_shares=c)
    torch.cuda.synchronize()
    assert torch.equal(shared, ss_matmul.share_onehot_plain(toks, a1,
                                                            n_shares=c))
    del a1
    table = _field((c, v, d), 12, cuda)
    assert not ss_matmul.is_tall_skinny(m, v, d)
    got = ops.ss_matmul(shared, table)
    torch.cuda.synchronize()
    assert ops.launch_counts()["share_onehot"] == 1
    assert ops.launch_counts()["ss_matmul"] == 1
    for lo in range(0, d, 1024):
        want = ss_matmul.ss_matmul_plain(shared, table[..., lo:lo + 1024])
        assert torch.equal(got[..., lo:lo + 1024], want)


def test_train_step_on_card_equals_cpu(cuda):
    """One ``make_train_step`` step (grad_accum 2, compression on) of the
    qwen smoke config in float32 on the card against the same step on the
    CPU: loss, lr and grad_norm within 1e-5; parameters within ``lr`` (the
    first AdamW step is about sign(g)·lr, so an element whose gradient is
    within rounding of zero may move apart by up to lr) and 99 % of each
    leaf's elements within 1e-6."""
    from repro_torch import _tree, configs
    from repro_torch.data import TokenStream
    from repro_torch.data.pipeline import to_device
    from repro_torch.models import lm
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    cfg = dataclasses.replace(configs.smoke("qwen1_5_4b"), dtype="float32")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = TokenStream(cfg.vocab_size, 4, 16, seed=3).batch_at(0)
    batch = {k: a.reshape((2, -1) + a.shape[1:]) for k, a in batch.items()}
    out = {}
    for dev in ("cpu", cuda):
        params = lm.init_params(4, cfg, device="cpu")
        params = _tree.map_leaves(lambda t: t.to(dev), params)
        step = make_train_step(cfg, opt, grad_accum=2, compress=True)
        params, _, m = step(params, init_state(params),
                            to_device(batch, dev))
        out[str(dev)] = (_tree.map_leaves(lambda t: t.cpu(), params),
                         {k: float(v) for k, v in m.items()})
    (pc, mc), (pg, mg) = out["cpu"], out[str(cuda)]
    for k in ("loss", "lr", "grad_norm"):
        assert abs(mg[k] - mc[k]) <= 1e-5 * max(1.0, abs(mc[k])), k
    for a, b in zip(_tree.leaves(pg), _tree.leaves(pc)):
        d = (a - b).abs()
        assert float(d.max()) <= mc["lr"] * 1.001
        assert float((d > 1e-6).float().mean()) <= 0.01


def test_walker_prices_phase4_kernels_at_perf_md_bounds(cuda):
    """Each kernel launched under the cost walker at ``chip_smoke.py``
    phase 4's shapes (zero shares on the card) launches once, is priced
    once, and its bound is its PERF.md §6 row's "Bound ms" within 1 %."""
    import math

    from _torch_phase4 import phase4_calls
    from repro_torch.launch import hlo_cost

    calls = phase4_calls(lambda s, d: torch.zeros(s, dtype=d, device=cuda))
    for label, entry, args, kw, kernel, bound_ms in calls:
        ops.reset_launch_counts()
        with hlo_cost.CostMode(device="cuda") as mode:
            getattr(ops, entry)(*args, **kw)
        torch.cuda.synchronize()
        assert ops.launch_counts()[kernel] == 1, label
        assert mode.cost.kernels == {kernel: 1} and mode.cost.ops == 0
        t = mode.cost.roofline().t_bound * 1e3
        assert math.isclose(t, bound_ms, rel_tol=0.01), (label, t, bound_ms)
    del calls
    torch.cuda.empty_cache()
