"""Parity of the port's field and Shamir layers with the JAX reference.

The same numpy uint32 inputs (seeded, with p−1 extremes) go through
``repro.core.field``/``repro.core.shamir`` and their ``repro_torch``
counterparts; results must be identical (tolerance 0: the arithmetic is
exact mod p). Randomness the port would draw itself is injected from the
reference's draws, so shares match bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import field as jfield  # noqa: E402
from repro.core import shamir as jshamir  # noqa: E402
from repro_torch.core import field, shamir  # noqa: E402

P = 2**31 - 1
EDGES = np.array([0, 1, 2, P - 2, P - 1, 2**30, 2**16, 2**16 - 1],
                 dtype=np.uint32)


def _elems(seed: int, shape) -> np.ndarray:
    """Uniform [0, p) uint32 with the edge values mixed in."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, P, size=shape, dtype=np.uint64).astype(np.uint32)
    flat = x.reshape(-1)
    flat[: min(flat.size, EDGES.size)] = EDGES[: flat.size]
    rng.shuffle(flat)
    return flat.reshape(shape)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def _np(x) -> np.ndarray:
    return field.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x).astype(np.uint32)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_reference(op):
    a = _elems(1, (64, 33))
    b = _elems(2, (64, 33))
    # every pair of edge values too
    ea, eb = np.meshgrid(EDGES, EDGES)
    a = np.concatenate([a.reshape(-1), ea.reshape(-1)])
    b = np.concatenate([b.reshape(-1), eb.reshape(-1)])
    want = np.asarray(getattr(jfield, op)(a, b))
    got = _np(getattr(field, op)(_t(a), _t(b)))
    np.testing.assert_array_equal(got, want)


def test_neg_and_from_signed_match_reference():
    a = _elems(3, (500,))
    np.testing.assert_array_equal(_np(field.neg(_t(a))),
                                  np.asarray(jfield.neg(a)))
    np.testing.assert_array_equal(field.from_signed(_t(a)).numpy(),
                                  np.asarray(jfield.from_signed(a)))


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_sum_and_dot_match_reference(axis):
    a = _elems(4, (7, 300))
    b = _elems(5, (7, 300))
    np.testing.assert_array_equal(_np(field.sum_(_t(a), dim=axis)),
                                  np.asarray(jfield.sum_(a, axis=axis)))
    np.testing.assert_array_equal(_np(field.dot(_t(a), _t(b), dim=axis)),
                                  np.asarray(jfield.dot(a, b, axis=axis)))


@pytest.mark.parametrize("shapes", [((5, 70), (70, 9)), ((1, 1), (1, 1)),
                                    ((3, 4, 129), (3, 129, 6)),
                                    ((0, 8), (8, 3))])
def test_matmul_matches_reference(shapes):
    sa, sb = shapes
    a, b = _elems(6, sa), _elems(7, sb)
    np.testing.assert_array_equal(_np(field.matmul(_t(a), _t(b))),
                                  np.asarray(jfield.matmul(a, b)))


def test_matmul_all_p_minus_one():
    a = np.full((4, 257), P - 1, np.uint32)
    b = np.full((257, 3), P - 1, np.uint32)
    np.testing.assert_array_equal(_np(field.matmul(_t(a), _t(b))),
                                  np.asarray(jfield.matmul(a, b)))


def test_pow_inv_match_reference():
    a = _elems(8, (64,))
    np.testing.assert_array_equal(_np(field.pow_(_t(a), 12345)),
                                  np.asarray(jfield.pow_(a, 12345)))
    nz = a[a != 0]
    np.testing.assert_array_equal(_np(field.inv(_t(nz))),
                                  np.asarray(jfield.inv(nz)))
    assert (_np(field.mul(_t(nz), field.inv(_t(nz)))) == 1).all()


def test_to_field_matches_reference():
    x = np.array([-5, -1, 0, 1, P - 1, P, P + 3, 2 * P + 7, -(2**40)],
                 dtype=np.int64)
    np.testing.assert_array_equal(_np(field.to_field(x)),
                                  np.asarray(jfield.to_field(x)))
    np.testing.assert_array_equal(_np(field.to_field(torch.from_numpy(x))),
                                  np.asarray(jfield.to_field(x)))


def test_uniform_range_and_spread():
    g = torch.Generator().manual_seed(0)
    u = field.uniform(g, (4096,))
    assert u.dtype == field.DTYPE
    assert int(u.min()) >= 0 and int(u.max()) < P
    assert len(torch.unique(u)) > 4000


# ---------------------------------------------------------------------------
# Shamir
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("degree,n_shares", [(1, 3), (2, 7), (3, 10)])
def test_make_shares_with_reference_coeffs_is_bit_identical(degree,
                                                            n_shares):
    key = jax.random.PRNGKey(degree * 10 + n_shares)
    secrets = _elems(9, (5, 6))
    want = np.asarray(jshamir.make_shares(key, secrets, n_shares=n_shares,
                                          degree=degree))
    coeffs = np.asarray(jfield.uniform(key, (degree,) + secrets.shape))
    got = shamir.make_shares(_t(secrets), n_shares=n_shares, degree=degree,
                             coeffs=_t(coeffs))
    np.testing.assert_array_equal(_np(got), want)


def test_make_shares_chunks_agree():
    """Generation in element chunks gives the same shares as one chunk."""
    secrets = _t(_elems(10, (1000,)))
    coeffs = _t(_elems(11, (2, 1000)))
    whole = shamir.make_shares(secrets, n_shares=5, degree=2, coeffs=coeffs)
    old = shamir._SHARE_CHUNK
    try:
        shamir._SHARE_CHUNK = 97
        chunked = shamir.make_shares(secrets, n_shares=5, degree=2,
                                     coeffs=coeffs)
    finally:
        shamir._SHARE_CHUNK = old
    assert torch.equal(whole, chunked)


def test_make_shares_needs_randomness():
    with pytest.raises(ValueError):
        shamir.make_shares(_t(np.zeros(3, np.uint32)), n_shares=3)


@pytest.mark.parametrize("degree,n_shares", [(1, 2), (2, 5), (4, 9)])
def test_interpolate_matches_reference(degree, n_shares):
    vals = _elems(12 + degree, (n_shares, 4, 5))
    want = np.asarray(jshamir.interpolate(jshamir.Shares(vals, degree)))
    got = shamir.interpolate(shamir.Shares(_t(vals), degree))
    np.testing.assert_array_equal(_np(got), want)


def test_share_roundtrip_with_own_generator():
    g = torch.Generator().manual_seed(3)
    secrets = _t(_elems(13, (6, 7)))
    sh = shamir.share(secrets, n_shares=6, degree=3, generator=g)
    assert torch.equal(shamir.interpolate(sh), secrets)
    with pytest.raises(ValueError):
        shamir.interpolate(shamir.Shares(sh.values[:3], 3))


def test_share_space_arithmetic_tracks_degree():
    g = torch.Generator().manual_seed(4)
    a, b = _t(_elems(14, (10,))), _t(_elems(15, (10,)))
    sa = shamir.share(a, n_shares=5, degree=1, generator=g)
    sb = shamir.share(b, n_shares=5, degree=1, generator=g)
    assert torch.equal(shamir.interpolate(sa + sb), field.add(a, b))
    assert torch.equal(shamir.interpolate(sa - sb), field.sub(a, b))
    prod = sa * sb
    assert prod.degree == 2
    assert torch.equal(shamir.interpolate(prod), field.mul(a, b))
    assert torch.equal(shamir.interpolate(sa.sum()), field.sum_(a))


def test_verify_consistency_matches_reference():
    key = jax.random.PRNGKey(5)
    secrets = _elems(16, (8,))
    vals = np.asarray(jshamir.make_shares(key, secrets, n_shares=6,
                                          degree=2))
    bad = vals.copy()
    bad[4, 3] = (int(bad[4, 3]) + 1) % P
    for v in (vals, bad):
        want = np.asarray(jshamir.verify_consistency(jshamir.Shares(v, 2)))
        got = shamir.verify_consistency(shamir.Shares(_t(v), 2)).numpy()
        np.testing.assert_array_equal(got, want)
    assert not got[3] and got.sum() == 7


def test_reduce_degree_with_injected_subshares_is_bit_identical():
    key = jax.random.PRNGKey(6)
    high = _elems(17, (5, 4, 3))                 # (c=5, 4, 3), degree 4
    want = jshamir.reduce_degree(key, jshamir.Shares(high, 4),
                                 target_degree=1)
    sub = np.asarray(jfield.uniform(key, (1,) + high.shape))
    got = shamir.reduce_degree(shamir.Shares(_t(high), 4), target_degree=1,
                               sub_coeffs=_t(sub))
    assert got.degree == want.degree == 1
    np.testing.assert_array_equal(_np(got.values), np.asarray(want.values))
    np.testing.assert_array_equal(
        _np(shamir.interpolate(got)),
        np.asarray(jshamir.interpolate(jshamir.Shares(high, 4))))


def test_lagrange_coeffs_match_reference():
    for pts in [(1, 2), (1, 2, 3, 4, 5), (2, 5, 9)]:
        np.testing.assert_array_equal(
            _np(shamir.lagrange_coeffs(len(pts), pts)),
            np.asarray(jshamir.lagrange_coeffs(len(pts), pts)))
