"""CPU emulation of the byte-limb arithmetic of the CUDA matmul kernels.

``src/repro_torch/kernels/csrc/ss_matmul.cu`` computes ``a @ b mod p`` on
the H100's int8 tensor cores: each operand splits into LIMB_BITS-bit limbs,
the 16 limb products of a pair sum by diagonal in s32 accumulators over at
most K_CHUNK terms, each chunk's 7 diagonal sums fold into the running
residue by 31-bit rotations (2³¹ ≡ 1 mod p), and a K split over blocks adds
its per-split residues in a last pass. This numpy emulation repeats that
arithmetic step by step with the constants the kernel is launched with
(``kernels/ss_matmul.py``) and holds it, bit for bit, against the port's
plain version, the reference's oracle and its Pallas kernel (interpret
mode). The card runs the kernel itself (``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ss_matmul import ss_matmul_pallas  # noqa: E402
from repro_torch.kernels import ss_matmul  # noqa: E402

P = 2**31 - 1
S32_MAX = 2**31 - 1
BITS = ss_matmul.LIMB_BITS
CHUNK = ss_matmul.K_CHUNK
LIMBS = -(-31 // BITS)
STAGE = 64            # K of one pipeline stage: a split is a multiple


def _limbs(x: np.ndarray) -> np.ndarray:
    """(..., ) integers -> (LIMBS, ...) int64 planes of BITS bits."""
    x = np.asarray(x, np.uint64)
    mask = np.uint64((1 << BITS) - 1)
    return np.stack([(x >> np.uint64(BITS * i)) & mask
                     for i in range(LIMBS)]).astype(np.int64)


def _diagonals(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The tensor cores' s32 accumulators of one K-chunk: (2·LIMBS − 1,
    M, N) sums of a_j·b_i over the limb pairs of diagonal i + j."""
    la, lb = _limbs(a), _limbs(b)
    d = np.zeros((2 * LIMBS - 1, a.shape[0], b.shape[1]), np.int64)
    for j in range(LIMBS):
        for i in range(LIMBS):
            d[i + j] += la[j] @ lb[i]
    return d


def _rot31(v: np.ndarray, e: int) -> np.ndarray:
    """v·2^e mod p, up to one p, for 0 <= v < 2³¹: a 31-bit rotation."""
    return ((v << e) & P) | (v >> (31 - e))


def _mod_p(x: np.ndarray) -> np.ndarray:
    x = (x & P) + (x >> 31)
    x = (x & P) + (x >> 31)
    return np.where(x >= P, x - P, x)


def emulate(a: np.ndarray, b: np.ndarray, ksplit: int = 1) -> np.ndarray:
    """The kernel's arithmetic on (M, K) @ (K, N) -> uint32 (M, N)."""
    m, k = a.shape
    n = b.shape[1]
    per = -(-(-(-k // ksplit)) // STAGE) * STAGE
    parts = []
    for s in range(ksplit):
        lo, hi = s * per, min(k, (s + 1) * per)
        res = np.zeros((m, n), np.int64)
        for c0 in range(lo, hi, CHUNK):
            d = _diagonals(a[:, c0:min(hi, c0 + CHUNK)],
                           b[c0:min(hi, c0 + CHUNK)])
            assert 0 <= d.min(initial=0) and d.max(initial=0) <= S32_MAX
            x = res.copy()
            for dd in range(d.shape[0]):
                x += _rot31(d[dd], (BITS * dd) % 31)
            res = _mod_p(x)
        parts.append(res)
    return _mod_p(np.sum(parts, axis=0)).astype(np.uint32)


def _elems(seed: int, shape) -> np.ndarray:
    """Uniform [0, p) with ~1/8 at p−1 and ~1/8 at 2³¹−1 (= p, ≡ 0)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, P, size=shape, dtype=np.uint64).astype(np.uint32)
    x[rng.random(shape) < 0.125] = P - 1
    x[rng.random(shape) < 0.125] = 2**31 - 1
    return x


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def test_constants_are_the_kernels():
    """u8 limbs (the tensor cores' int8 type) cover a 31-bit operand; the
    chunk is a whole number of pipeline stages."""
    assert BITS == 8 and LIMBS * BITS >= 31
    assert CHUNK % STAGE == 0 and CHUNK > 0


def test_diagonal_sums_fit_s32_at_the_chunk():
    """All-255 limbs, the most any limb can hold, at K = K_CHUNK: the fullest
    diagonal (LIMBS pairs) stays at most 2³¹ − 1."""
    ones = np.full((1, CHUNK), (1 << (BITS * LIMBS)) - 1, np.uint64)
    d = _diagonals(ones, ones.T.copy())
    assert (_limbs(ones) == (1 << BITS) - 1).all()
    assert d.max() == LIMBS * ((1 << BITS) - 1) ** 2 * CHUNK
    assert d.max() <= S32_MAX
    # and the real operands' headroom: the top limb of x < 2³¹ is < 128
    top = _limbs(np.array([2**31 - 1], np.uint64))[-1, 0]
    assert top == (1 << (31 - BITS * (LIMBS - 1))) - 1


@pytest.mark.parametrize("value", [P - 1, 2**31 - 1])
def test_extremes_at_two_chunks_and_one(value):
    """Constant operands at K = 2·K_CHUNK + 1: three chunks, the last of
    one term."""
    k = 2 * CHUNK + 1
    a = np.full((3, k), value, np.uint32)
    b = np.full((k, 5), value, np.uint32)
    got = emulate(a, b)
    np.testing.assert_array_equal(
        got, ss_matmul.ss_matmul_plain(_t(a), _t(b)).numpy().astype(
            np.uint32))
    assert (got == (k * value * value) % P).all()


@pytest.mark.parametrize("m,k,n", [(9, CHUNK - 1, 70), (3, CHUNK, 65),
                                   (5, CHUNK + 1, 33), (1, 300, 1)])
def test_emulation_matches_plain_reference_and_pallas(m, k, n):
    """Random operands with p−1 and 2³¹−1 extremes; K at the chunk edges;
    M and N not multiples of 8 or 64."""
    a, b = _elems(m * 31 + k, (m, k)), _elems(n * 17 + k, (k, n))
    got = emulate(a, b)
    np.testing.assert_array_equal(
        got, ss_matmul.ss_matmul_plain(_t(a), _t(b)).numpy().astype(
            np.uint32))
    np.testing.assert_array_equal(got, np.asarray(jref.ss_matmul(a, b)))
    np.testing.assert_array_equal(
        got, np.asarray(ss_matmul_pallas(a, b, interpret=True)))


@pytest.mark.parametrize("ksplit", [2, 3, 7])
def test_split_k_reduce(ksplit):
    """K split over blocks (each split a whole number of stages, chunks
    restarting at each split) and the reduce pass give the same residues."""
    k = CHUNK + 2 * STAGE + 5
    a, b = _elems(ksplit, (4, k)), _elems(ksplit + 50, (k, 9))
    np.testing.assert_array_equal(emulate(a, b, ksplit), emulate(a, b))
    np.testing.assert_array_equal(
        emulate(a, b, ksplit),
        ss_matmul.ss_matmul_plain(_t(a), _t(b)).numpy().astype(np.uint32))
