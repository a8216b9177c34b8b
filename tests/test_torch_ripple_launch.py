"""The ripple kernel's launch plan (``kernels/ripple.py``), which is pure
Python and runs here, the bit-major operand layout (``bit_major``,
``bit_major_where``, ``on_planes``), and the operands the range phase and
the MIN/MAX tournament hand the kernel.

The plan picks one of two routes from the operands' pointers and strides:
``bit_major`` (lane stride 1, every row and bit plane 16-byte aligned) or
``strided`` (anything else). The kernel itself runs only on a GPU
(``tests/test_torch_kernels_cuda.py``); here a backend that plans each call
and then runs the plain version shows which route every launch of a path
would take.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.core import Codec, ShardedRelation, outsource  # noqa: E402
from repro_torch.core import shamir  # noqa: E402
from repro_torch.core.dataplane import as_dataplane  # noqa: E402
from repro_torch.kernels import ripple  # noqa: E402

P = 2**31 - 1
BASE = 1 << 20                     # a 16-byte-aligned stand-in address


def _route(t_a, t_b, carry=None):
    ops = [t_a, t_b] + ([] if carry is None else [carry])
    return ripple.plan([t.data_ptr() for t in ops], [t.stride() for t in ops],
                       tuple(t_a.shape[:-1]))


def _bm(shape, seed=0):
    x = torch.from_numpy(np.random.default_rng(seed).integers(
        0, P, size=shape).astype(np.int32))
    return ripple.bit_major([x], dim=1)


# -- the plan --------------------------------------------------------------

@pytest.mark.parametrize("strides,lanes,route", [
    # range rows [lo, x, hi] bit-major at n = 1,024: lhs is rows [0, 2)
    ([(3 * 13 * 1024, 13 * 1024, 1, 1024)] * 2, (20, 2, 1024), "bit_major"),
    # a column broadcast across the batch (B-stride 0), bit-major
    ([(13 * 1024, 0, 1, 1024)] * 2, (20, 4, 1024), "bit_major"),
    # planes of 1,027 lanes without the padding: planes off 16-byte bounds
    ([(13 * 1027, 1, 1027)] * 2, (20, 1027), "strided"),
    # interleaved (c, 2, n, 13) rows: a lane's bits contiguous
    ([(2 * 13 * 1000, 13 * 1000, 13, 1)] * 2, (20, 2, 1000), "strided"),
    # the tournament's pair views: of interleaved candidates (lane stride
    # 2t = 26) and of bit-major ones (lane stride 2)
    ([(26 * 500, 26, 1)] * 2, (20, 500), "strided"),
    ([(13 * 1000, 2, 1000)] * 2, (20, 500), "strided"),
    # rows of 80 words, lanes that overlap (lane stride 4, bit stride 1)
    ([(80 * 500, 80, 1)] * 2, (20, 500), "strided"),
    ([(4 * 500, 4, 1)] * 2, (20, 500), "strided"),
    # one operand bit-major, the other interleaved
    ([(13 * 1024, 1, 1024), (13 * 1024, 13, 1)], (20, 1024), "strided"),
    # one lane dim (the 1-D ripple_carry form), bit-major
    ([(1, 1024)] * 2, (1024,), "bit_major"),
])
def test_plan_route(strides, lanes, route):
    pl = ripple.plan([BASE, BASE + 4096], strides, lanes)
    assert pl.route == route


@pytest.mark.parametrize("offset,route", [(0, "bit_major"), (4, "strided"),
                                          (8, "strided"), (16, "bit_major"),
                                          (13 * 4, "strided")])
def test_plan_alignment_of_the_base(offset, route):
    """A shard slice [..., lo:hi, :] of bit-major planes moves the base by
    4·lo bytes: 16-byte bounds (lo % 4 == 0) keep the bit-major route."""
    st = [(2 * 13 * 1024, 13 * 1024, 1, 1024)] * 2
    pl = ripple.plan([BASE + offset, BASE], st, (3, 2, 300))
    assert pl.route == route


@pytest.mark.parametrize("strides,route", [
    ((2 * 13 * 1024, 13 * 1024, 1, 1026), "strided"),   # bit stride % 4
    ((2 * 13 * 1024, 13 * 1026, 1, 1024), "strided"),   # row stride % 4
    ((2 * 13 * 1026 + 2, 13 * 1024, 1, 1024), "strided"),
    ((2 * 13 * 1024, 13 * 1024, 1, 1024), "bit_major")])
def test_plan_alignment_of_the_strides(strides, route):
    st = [(2 * 13 * 1024, 13 * 1024, 1, 1024), strides]
    assert ripple.plan([BASE, BASE], st, (3, 2, 1000)).route == route


@pytest.mark.parametrize("k", range(1, 14))
def test_plan_every_k(k):
    """The bit slice [..., 13 − k:] of bit-major planes moves the base by
    whole planes and keeps the bit-major route at every k; the same slice
    of 13-word interleaved rows moves it by 4·(13 − k) bytes and reads
    through the strides at every k."""
    bm = _bm((3, 2, 1024, 13), seed=k)
    assert _route(bm[..., 13 - k:], bm[..., :k]).route == "bit_major"
    inter = torch.zeros((3, 2, 1024, 13), dtype=torch.int32)
    assert _route(inter[..., 13 - k:], inter[..., :k]).route == "strided"


@pytest.mark.parametrize("carry_strides,carry_ptr,lanes,vec_c,vec_out", [
    ((1024 * 2, 1024, 1), BASE, 1024, True, True),
    ((1027 * 2, 1027, 1), BASE, 1027, False, False),   # rows of 1,027
    ((1028 * 2, 1028, 1), BASE, 1027, True, False),    # padded carry rows
    ((1024 * 2, 1024, 1), BASE + 4, 1024, False, True)])
def test_plan_vector_carry_and_outputs(carry_strides, carry_ptr, lanes,
                                       vec_c, vec_out):
    """Carry and output rows off 16-byte bounds move in 4-byte words on
    the bit-major route; the route stays."""
    pad = -(-lanes // 4) * 4
    st = [(2 * 13 * pad, 13 * pad, 1, pad)] * 2 + [carry_strides]
    pl = ripple.plan([BASE, BASE, carry_ptr], st, (3, 2, lanes))
    assert (pl.route, pl.vec_carry, pl.vec_out) == ("bit_major", vec_c,
                                                    vec_out)
    assert pl.dims == [1, 6, lanes]


def test_plan_grids():
    """Bit-major rows collapse into two dims with the lanes last; strided
    lanes collapse as far as every operand steps evenly; lanes that need
    four uneven dims have no plan (the wrapper copies)."""
    a = _bm((3, 4, 50, 13))[:, :, :, 2:10]
    pl = _route(a, a)
    assert pl.route == "bit_major"
    assert pl.dims == [1, 12, 50] and pl.lane_strides[0] == [0, 13 * 52, 1]
    one = _bm((3, 4, 1, 13))[..., :5]                  # one-lane rows
    pl = _route(one, one, torch.zeros((3, 4, 1), dtype=torch.int32))
    assert (pl.route, pl.dims) == ("bit_major", [1, 12, 1])
    inter = torch.zeros((3, 4, 50, 13), dtype=torch.int32)
    pl = _route(inter[..., :8], inter[..., 5:])
    assert (pl.route, pl.dims) == ("strided", [1, 1, 600])
    odd = [(200 * 13, 50 * 13, 11 * 13, 2 * 13, 1)] * 2
    assert ripple.plan([BASE, BASE], odd, (2, 3, 4, 5)) is None


# -- bit_major --------------------------------------------------------------

@pytest.mark.parametrize("lanes,padded", [(50, 52), (52, 52), (1, 4),
                                          (1027, 1028)])
def test_bit_major_view_equals_its_sources(lanes, padded):
    """The view equals torch.cat of its sources; lane stride 1, bit stride
    the padded lanes, rows t·padded apart, clouds 3B·t·padded."""
    rng = np.random.default_rng(lanes)
    srcs = [torch.from_numpy(rng.integers(0, P, (3, b, lanes, 13))
                             .astype(np.int32)) for b in (1, 2, 1)]
    srcs[2] = srcs[2][:, :1].expand(3, 1, lanes, 13)     # a broadcast row
    out = ripple.bit_major(srcs, dim=1)
    assert torch.equal(out, torch.cat(srcs, dim=1))
    assert out.shape == (3, 4, lanes, 13)
    assert out.stride() == (4 * 13 * padded, 13 * padded, 1, padded)
    assert out.data_ptr() % 16 == 0


def test_bit_major_of_strided_sources():
    """Pair views (stride 2) and per-segment slices copy as values."""
    x = torch.arange(2 * 3 * 20 * 13, dtype=torch.int32).reshape(2, 3, 20, 13)
    for src in (x[:, :, 0::2], x[:, :, 1::2, 5:], x.transpose(0, 1)):
        out = ripple.bit_major([src], dim=1)
        assert torch.equal(out, src) and out.stride(-2) == 1


def test_bit_major_stacks_along_a_leading_axis_only():
    x = torch.zeros((2, 3, 20, 13), dtype=torch.int32)
    with pytest.raises(ValueError):
        ripple.bit_major([x, x], dim=2)
    with pytest.raises(ValueError):
        ripple.bit_major([x, x], dim=-1)
    assert ripple.bit_major([x, x], dim=-4).shape == (4, 3, 20, 13)


@pytest.mark.parametrize("layout", ["bit_major", "interleaved", "pairs"])
def test_bit_major_where_equals_torch_where(layout):
    """The tournament's per-row selection, written bit-major (padded
    planes, lane stride 1) from bit-major, interleaved and stride-2 pair
    sources alike."""
    rng = np.random.default_rng(5)
    src = torch.from_numpy(rng.integers(0, P, (3, 2, 22, 13))
                           .astype(np.int32))
    if layout == "bit_major":
        src = ripple.bit_major([src], dim=1)
    x, y = (src[:, :, 0::2], src[:, :, 1::2]) if layout == "pairs" \
        else (src, src.flip(2))
    cond = torch.tensor([True, False])[None, :, None, None]
    out = ripple.bit_major_where(cond, x, y)
    assert torch.equal(out, torch.where(cond, x, y))
    lanes = x.shape[2]
    padded = -(-lanes // 4) * 4
    assert out.stride() == (2 * 13 * padded, 13 * padded, 1, padded)
    assert out.data_ptr() % 16 == 0


def test_on_planes_returns_bit_major_planes():
    """A re-share run through on_planes sees (..., t, lanes) and hands
    back (..., lanes, t) planes with lane stride 1, sharing the same
    values as one run on the view itself."""
    rng = np.random.default_rng(6)
    v = torch.from_numpy(rng.integers(0, 2, (5, 1, 7, 13)).astype(np.int32))
    x = shamir.make_shares(v[0], n_shares=5, degree=2,
                           generator=torch.Generator().manual_seed(1))
    seen = []

    def reshare(w):
        seen.append(tuple(w.shape))
        return shamir.reduce_degree(shamir.Shares(w, 2), target_degree=1,
                                    generator=torch.Generator()).values

    out = ripple.on_planes(reshare, x)
    assert seen == [(5, 1, 13, 7)]
    assert out.shape == x.shape and out.stride(-2) == 1
    opened = shamir.interpolate(shamir.Shares(out, 1))
    assert torch.equal(opened, v[0])


# -- the paths' operands ----------------------------------------------------

N, C, T = 40, 20, 8
ROWS = [[f"e{i:02d}", str(v), "g" if i % 3 else "h"]
        for i, v in enumerate(np.random.default_rng(8).integers(-50, 51, N))]


@pytest.fixture(scope="module")
def db():
    return outsource(ROWS, n_shares=C, column_names=["Id", "V", "D"],
                     codec=Codec(alphabet="\0abcdefgh0123456789-",
                                 word_length=4),
                     numeric_columns={1: T}, device="cpu")


def _spy():
    """A backend that plans each ripple call as the CUDA wrapper would,
    records the route, and runs the plain version."""
    seen = []
    base = api.get_backend("torch")

    def segment(a, b, carry=None):
        pl = ripple.plan([t.data_ptr() for t in (a, b, carry)
                          if t is not None],
                         [t.stride() for t in (a, b, carry) if t is not None],
                         tuple(a.shape[:-1]))
        seen.append(pl.route)
        return base.ripple_segment(a, b, carry)

    return dataclasses.replace(base, name="spy", ripple_segment=segment), seen


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_paths_hand_the_kernel_bit_major_operands(db, shards):
    """Every ripple launch of range_count (reduce_every 8, 3 and 1) and of
    MIN/MAX tournaments (conditional and not, with odd levels) plans the
    bit-major route, except a shard slice whose first tuple is not a
    multiple of 4 (at S = 3 here), which plans the strided one. Answers
    equal numpy's."""
    be, seen = _spy()
    rel = ShardedRelation(db, shards=shards) if shards > 1 else db
    client = api.QueryClient(rel, 3, backend=be, device="cpu")
    v = np.array([int(r[1]) for r in ROWS])
    for every in (8, 3, 1):
        res = client.range_count("V", -10, 20, reduce_every=every)
        assert res.count == int(((v >= -10) & (v <= 20)).sum())
    ranges = len(seen)
    res = client.run_batch([api.Aggregate("min", "V", reduce_every=3),
                            api.Aggregate("max", "V", reduce_every=3,
                                          where=api.Eq("D", "g"))])
    assert res[0].value == v.min()
    assert res[1].value == max(x for x, r in zip(v, ROWS) if r[2] == "g")
    assert len(seen) > ranges
    los = [sh.lo for sh in as_dataplane(rel).shards]
    assert any(lo % 4 for lo in los) == (shards == 3)
    for i, route in enumerate(seen[:ranges]):     # one call a shard, in turn
        assert route == ("strided" if los[i % shards] % 4 else "bit_major")
    assert set(seen[ranges:]) == {"bit_major"}
