"""CPU parity of the port's SS-SUB ripple kernel module with the reference.

``ripple_segment_plain`` and the ``ops.ripple_segment`` /
``ops.ripple_carry`` wrappers (which take the plain version for CPU
tensors) are held bit for bit (tolerance 0: the arithmetic is exact mod p)
against the Pallas ``ripple_segment_pallas`` / ``ripple_carry_pallas`` run
in interpret mode and against the reference's jnp backend ops, on the same
uint32 inputs drawn from a numpy seed with ~1/8 of the entries at p−1.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.api.backends import (jnp_ripple_carry,  # noqa: E402
                                jnp_ripple_segment)
from repro.kernels.ripple import (ripple_carry_pallas,  # noqa: E402
                                  ripple_segment_pallas)
from repro_torch.api import backends  # noqa: E402
from repro_torch.kernels import ops, ripple  # noqa: E402
from repro_torch.kernels.ripple import _lane_grid  # noqa: E402

P = 2**31 - 1
LANES = (3, 2, 37)                  # (c, S, n): 222 lanes, not a power of 2


def _elems(seed: int, shape) -> np.ndarray:
    """Uniform [0, p) uint32 with ~1/8 of the entries at p−1."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, P, size=shape, dtype=np.uint64).astype(np.uint32)
    x[rng.random(shape) < 0.125] = P - 1
    return x


def _bits(seed: int, shape) -> np.ndarray:
    """Bit planes as the range engine sees them: 0/1 plus share noise."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2, size=shape).astype(np.uint32)
    noisy = rng.random(shape) < 0.5
    x[noisy] = _elems(seed + 1, shape)[noisy]
    return x


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.numpy().astype(np.uint32)


@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_ripple_segment_plain_matches_pallas_and_jnp(k, init):
    a, b = _elems(10 + k, LANES + (k,)), _bits(20 + k, LANES + (k,))
    carry = None if init else _elems(30 + k, LANES)
    got_rb, got_c = ripple.ripple_segment_plain(
        _t(a), _t(b), None if init else _t(carry))
    n = int(np.prod(LANES))
    flat_c = np.zeros(n, np.uint32) if init else carry.reshape(-1)
    p_rb, p_c = ripple_segment_pallas(a.reshape(n, k).T, b.reshape(n, k).T,
                                      flat_c, init=init, interpret=True)
    np.testing.assert_array_equal(_np(got_rb).reshape(-1), np.asarray(p_rb))
    np.testing.assert_array_equal(_np(got_c).reshape(-1), np.asarray(p_c))
    j_rb, j_c = jnp_ripple_segment(a, b, None if init else carry)
    np.testing.assert_array_equal(_np(got_rb), np.asarray(j_rb))
    np.testing.assert_array_equal(_np(got_c), np.asarray(j_c))
    o_rb, o_c = ops.ripple_segment(_t(a), _t(b),
                                   None if init else _t(carry))
    assert torch.equal(o_rb, got_rb) and torch.equal(o_c, got_c)


@pytest.mark.parametrize("init", [True, False])
def test_ripple_carry_matches_pallas_and_jnp(init):
    a, b = _elems(40, LANES), _bits(41, LANES)
    carry = None if init else _elems(42, LANES)
    got_rb, got_c = ops.ripple_carry(_t(a), _t(b),
                                     None if init else _t(carry))
    flat_c = np.zeros(a.size, np.uint32) if init else carry.reshape(-1)
    p_rb, p_c = ripple_carry_pallas(a.reshape(-1), b.reshape(-1), flat_c,
                                    init=init, interpret=True)
    np.testing.assert_array_equal(_np(got_rb).reshape(-1), np.asarray(p_rb))
    np.testing.assert_array_equal(_np(got_c).reshape(-1), np.asarray(p_c))
    j_rb, j_c = jnp_ripple_carry(a, b, None if init else carry)
    np.testing.assert_array_equal(_np(got_rb), np.asarray(j_rb))
    np.testing.assert_array_equal(_np(got_c), np.asarray(j_c))
    t_rb, t_c = backends.get_backend("torch").ripple_carry(
        _t(a), _t(b), None if init else _t(carry))
    assert torch.equal(t_rb, got_rb) and torch.equal(t_c, got_c)


def test_ripple_all_p_minus_one_and_zero_extremes():
    for fill in (0, 1, P - 1):
        a = np.full(LANES + (3,), fill, np.uint32)
        b = np.full(LANES + (3,), P - 1 - fill, np.uint32)
        carry = np.full(LANES, P - 1, np.uint32)
        got = ripple.ripple_segment_plain(_t(a), _t(b), _t(carry))
        want = jnp_ripple_segment(a, b, carry)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_segment_equals_stepping_bit_by_bit():
    """A k-bit segment is k chained single steps (the segmenter's
    fallback for a backend with only ``ripple_carry``)."""
    a, b = _t(_elems(50, LANES + (5,))), _t(_bits(51, LANES + (5,)))
    want = ops.ripple_segment(a, b)
    stepper = backends.Backend("steps", ss_matmul=None, aa_match_batch=None,
                               aa_match_rows=None,
                               ripple_carry=ops.ripple_carry)
    got = backends.ripple_segmenter(stepper)(a, b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_strided_views_match_their_copies():
    """The views the range engine passes: a per-shard, per-segment slice
    ``lhs[:, :, lo:hi, s0:s1]`` and a column broadcast across the batch
    (B-stride 0)."""
    full = _t(_elems(60, (3, 4, 50, 13)))
    other = _t(_bits(61, (3, 4, 50, 13)))
    a, b = full[:, :, 7:31, 8:13], other[:, :, 7:31, 8:13]
    carry = _t(_elems(62, (3, 4, 60)))[:, :, 11:35]
    got = ops.ripple_segment(a, b, carry)
    want = ops.ripple_segment(a.contiguous(), b.contiguous(),
                              carry.contiguous())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    col = _t(_elems(63, (3, 50, 8)))
    wide = col[:, None].expand(3, 2, 50, 8)
    assert wide.stride(1) == 0
    got = ops.ripple_segment(wide, other[:, :2, :, :8])
    want = ops.ripple_segment(wide.contiguous(), other[:, :2, :, :8])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_lane_grid_collapses_what_the_kernel_reads():
    """The CUDA wrapper hands the kernel at most three lane dims; views of
    the range engine collapse without a copy."""
    x = torch.zeros((3, 4, 50, 13), dtype=torch.int32)
    dims, st = _lane_grid((3, 4, 50), [x.stride()[:3]])
    assert dims == [1, 1, 600] and st == [[0, 0, 13]]
    v = x[:, :, 7:31]
    dims, st = _lane_grid((3, 4, 24), [v.stride()[:3]])
    assert dims == [1, 12, 24] and st == [[0, 650, 13]]
    col = torch.zeros((3, 50, 8), dtype=torch.int32)[:, None].expand(
        3, 2, 50, 8)
    dims, st = _lane_grid((3, 2, 50), [col.stride()[:3]])
    assert dims == [3, 2, 50] and st == [[400, 0, 8]]
    assert _lane_grid((2, 3, 4, 5), [(120, 40, 10, 2)]) is not None
    assert _lane_grid((2, 3, 4, 5), [(200, 50, 11, 2)]) is None


def test_ripple_rejects_bad_shapes():
    a = _t(_elems(70, (2, 3, 4)))
    with pytest.raises(ValueError):
        ops.ripple_segment(a, a[..., :3])
    with pytest.raises(ValueError):
        ops.ripple_segment(a, a, a[..., 0][:, :2])
    with pytest.raises(ValueError):
        ops.ripple_segment(a[..., :0], a[..., :0])


def test_cpu_ripple_counts_no_launch():
    ops.reset_launch_counts()
    a, b = _t(_elems(80, (2, 9, 4))), _t(_bits(81, (2, 9, 4)))
    ops.ripple_segment(a, b)
    ops.ripple_carry(a[..., 0], b[..., 0], a[..., 1])
    counts = ops.launch_counts()
    assert counts["ripple_segment"] == counts["ripple_carry"] == 0
