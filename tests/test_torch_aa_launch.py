"""The launch plan of the match and slide kernels (``kernels/aa_match.py``),
which is pure Python and runs here, and a numpy emulation of the kernel's
dot accumulation.

The plan groups batch rows that read one source, cuts groups into chunks
that fit in shared memory, picks 16- or 4-byte copies from the pointer,
strides and offsets, and sizes the staged tiles. The kernel itself runs
only on a GPU (``tests/test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import aa_match as aa  # noqa: E402

P = 2**31 - 1


def test_group_rows_by_source():
    groups = aa.group_rows([0, 552, 0, 0, 552], [10, 10, 10, 9, 10])
    assert groups == {(0, 10): [0, 2], (552, 10): [1, 4], (0, 9): [3]}
    assert list(groups) == [(0, 10), (552, 10), (0, 9)]    # first seen


@pytest.mark.parametrize("b,cap,sizes", [(1, 27, [1]), (27, 27, [27]),
                                         (28, 27, [27, 1]),
                                         (60, 27, [27, 27, 6])])
def test_chunk_groups_cap(b, cap, sizes):
    chunks = aa.chunk_groups({(0, 5): list(range(b)), (8, 5): [b]}, cap)
    assert [len(m) for _, _, m in chunks] == sizes + [1]
    assert [r for _, _, m in chunks[:-1] for r in m] == list(range(b))
    assert chunks[-1] == (8, 5, [b])


def test_pack_chunks_table():
    chunks = [(0, 10, [0, 2]), (552, 9, [1]), (0, 10, [3, 4, 5])]
    assert aa.pack_chunks(chunks) == [0, 552, 0, 10, 9, 10, 0, 2, 3,
                                      2, 1, 3, 0, 2, 1, 3, 4, 5]


@pytest.mark.parametrize("ptr,stride_c,stride_n,offsets,route", [
    (1024, 4 * 2760, 2760, [0, 552, 4 * 552], 16),    # Employee relation
    (1024, 0, 552, [0, 0, 0], 16),                    # B-stride-0 stack
    (1028, 2760, 2760, [0], 4),                       # base not 16-byte
    (1024, 825, 165, [0, 165], 4),                    # W = 5, A = 33
    (1024, 2760, 2760, [0, 552, 1], 4),               # one odd offset
    (1024, 2762, 2760, [0], 4)])                      # odd cloud stride
def test_copy_route(ptr, stride_c, stride_n, offsets, route):
    assert aa.copy_route(ptr, stride_c, stride_n, offsets) == route


def test_batch_plan_views():
    """The wrappers' own views: a broadcast column is one group; prefix
    views and a padded (5, 33) row keep 16-byte copies; a contiguous
    (5, 33) stack takes 4-byte ones."""
    rel = torch.zeros((2, 40, 5, 8, 69), dtype=torch.int32)
    one = rel[:, :, 1][:, None].expand(2, 8, 40, 8, 69)
    pl = aa.batch_plan(one)
    assert pl.chunks == [(0, 40, list(range(8)))] and pl.copy_bytes == 16
    for k in (1, 4):
        pl = aa.batch_plan(rel[..., :k, :][:, :, 2][:, None])
        assert pl.copy_bytes == 16 and pl.pitch % 4 == 0
    assert aa.batch_plan(torch.zeros((2, 3, 9, 5, 33),
                                     dtype=torch.int32)).copy_bytes == 4
    pad = torch.zeros((2, 3, 9, 168), dtype=torch.int32)
    pl = aa.batch_plan(pad[..., :165].unflatten(-1, (5, 33)), k=2)
    assert pl.copy_bytes == 16 and len(pl.chunks) == 3


def test_batch_plan_chunks_a_large_group():
    col = torch.zeros((2, 1, 50, 8, 69), dtype=torch.int32)
    for k in (0, 2):
        cap = aa.tile_layout(8, 69, k or 8, 10**6)[2]
        pl = aa.batch_plan(col.expand(2, cap + 5, 50, 8, 69), k)
        assert pl.patterns == cap
        assert [len(m) for _, _, m in pl.chunks] == [cap, 5]
        assert pl.smem <= aa._MAX_SMEM_BYTES


def test_row_pitch_spreads_banks():
    """At the Employee width (W = 8, A = 69) a warp's 4 tuples × 8
    positions read 32 distinct banks at every alphabet index."""
    pitch = aa.row_pitch(8, 69)
    assert pitch % 4 == 0 and pitch >= 552
    banks = {(r * pitch + j * 69) % 32 for r in range(4) for j in range(8)}
    assert len(banks) == 32


@pytest.mark.parametrize("w,a,k", [(8, 69, 8), (8, 69, 2), (8, 69, 5),
                                   (1, 69, 1), (4, 69, 4), (5, 33, 5),
                                   (5, 33, 2), (12, 69, 12), (12, 1024, 12),
                                   (12288, 1, 12288), (129, 11, 2),
                                   (200, 7, 73), (32, 69, 1),
                                   (1300, 1, 1173), (760, 2, 633)])
def test_tile_layout_fits(w, a, k):
    """Every shape the earlier warp-per-row kernels took (the match up to
    W·A = 12,288 words, the slide up to W·A ≈ 1,500 words and M = 128
    windows) still has a layout, within the H100's 227 KB a block; tile
    rows split into passes only where one tuple's dots do not fit."""
    for n_pat in (1, 8, 1000):
        pitch, rows, pats, k_pass = aa.tile_layout(w, a, k, n_pat)
        assert pitch % 4 == 0 and w * a <= pitch < w * a + 35
        assert rows >= 1 and rows & (rows - 1) == 0
        assert 1 <= pats <= n_pat and 1 <= k_pass <= k
        assert aa.smem_bytes(w, a, k, rows, pitch, pats, k_pass) \
            <= aa._MAX_SMEM_BYTES
        if pats < n_pat:               # one more pattern would not fit
            assert aa.smem_bytes(w, a, k, rows, pitch, pats + 1, k_pass) \
                > aa._MAX_SMEM_BYTES
        if k_pass < k:                 # the whole tile row list would not
            assert rows == 1 and aa.smem_bytes(w, a, k, 1, pitch, 1) \
                > aa._MAX_SMEM_BYTES


def test_tile_layout_passes_only_for_tiny_alphabets():
    """A slide of 1,173 tile rows over words of 1,300 one-symbol positions
    (M = 128) holds its dots in 4 passes; the Employee shapes in one."""
    assert aa.tile_layout(1300, 1, 1173, 1)[3] == 294
    for k in range(1, 9):
        assert aa.tile_layout(8, 69, k, 40)[3] == k


def test_tile_layout_employee():
    """The count stack: 32 tuples a tile (two tiles of 70,656 bytes staged)
    and every pattern of a B = 8 stack in one chunk."""
    assert aa.tile_layout(8, 69, 8, 8) == (552, 32, 8, 8)
    assert aa.smem_bytes(8, 69, 8, 32, 552, 1) == 144676


def test_tile_layout_rejects_oversize():
    with pytest.raises(ValueError, match="shared memory"):
        aa.tile_layout(64, 1000, 64, 1)


# ---------------------------------------------------------------------------
# the kernel's dot: 62-bit products in a 64-bit sum, folded every
# FOLD_EVERY products, one final reduction
# ---------------------------------------------------------------------------

def _kernel_dot(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Row-wise Σ x·y mod p in the kernel's order, in uint64 as the
    kernel holds it; asserts no partial sum reaches 2^64."""
    mask = np.uint64(P)

    def fold(v):
        return (v & mask) + (v >> np.uint64(31))

    s = np.zeros(x.shape[0], dtype=np.uint64)
    exact = np.zeros(x.shape[0], dtype=object)
    n = x.shape[1]
    for e in range(n):
        prod = x[:, e].astype(np.uint64) * y[:, e].astype(np.uint64)
        exact = s.astype(object) + prod.astype(object)
        assert max(exact) < 2**64
        s = s + prod
        if (e + 1) % aa.FOLD_EVERY == 0 and e + 1 <= n - n % aa.FOLD_EVERY:
            s = fold(s)
    s = fold(fold(s))
    return np.where(s >= mask, s - mask, s)


@pytest.mark.parametrize("a", [1, 2, 3, 4, 33, 69, 70])
@pytest.mark.parametrize("fill", ["p-1", "2^31-1", "random"])
def test_kernel_dot_emulation_exact(a, fill):
    rng = np.random.default_rng(a)
    if fill == "random":
        x = rng.integers(0, 2**31, (64, a), dtype=np.int64)
        y = rng.integers(0, 2**31, (64, a), dtype=np.int64)
    else:
        v = P - 1 if fill == "p-1" else 2**31 - 1
        x = np.full((4, a), v, dtype=np.int64)
        y = np.full((4, a), v, dtype=np.int64)
    got = _kernel_dot(x, y)
    want = [sum(int(p) * int(q) for p, q in zip(r, s)) % P
            for r, s in zip(x, y)]
    assert [int(v) for v in got] == want
