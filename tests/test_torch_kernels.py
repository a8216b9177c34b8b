"""CPU parity of the port's kernel modules with the reference kernels.

The plain PyTorch versions beside the CUDA kernels (``aa_match_batch``,
``aa_match_rows``, ``ss_matmul``) are held, bit for bit, against the Pallas
kernels run in interpret mode, the reference oracles in
``repro.kernels.ref`` and the port's own literal oracles in
``repro_torch.kernels.ref``. The wrappers in ``repro_torch.kernels.ops``
must take the plain version for CPU tensors and count no launch.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import automata as jautomata  # noqa: E402
from repro.core import encoding as jencoding  # noqa: E402
from repro.core.shamir import Shares as JShares  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.aa_match import (aa_match_batch_pallas,  # noqa: E402
                                    aa_match_pallas)
from repro.kernels.ss_matmul import ss_matmul_pallas  # noqa: E402
from repro_torch.api import backends  # noqa: E402
from repro_torch.core import automata, encoding  # noqa: E402
from repro_torch.core.shamir import Shares  # noqa: E402
from repro_torch.kernels import aa_match, ops, ref, ss_matmul  # noqa: E402

P = 2**31 - 1


def _elems(seed: int, shape) -> np.ndarray:
    """Uniform [0, p) uint32 with ~1/8 of the entries at p−1."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, P, size=shape, dtype=np.uint64).astype(np.uint32)
    x[rng.random(shape) < 0.125] = P - 1
    return x


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# ss_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (5, 130, 7), (17, 257, 129),
                                   (0, 9, 4), (3, 9, 0)])
def test_ss_matmul_plain_matches_pallas_and_refs(m, k, n):
    a, b = _elems(m * 7 + k, (m, k)), _elems(n * 11 + k, (k, n))
    got = _np(ss_matmul.ss_matmul_plain(_t(a), _t(b)))
    np.testing.assert_array_equal(
        got, np.asarray(ss_matmul_pallas(a, b, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jref.ss_matmul(a, b)))
    np.testing.assert_array_equal(got, _np(ref.ss_matmul(_t(a), _t(b))))


@pytest.mark.parametrize("form", ["3x3", "3x2"])
def test_ss_matmul_cloud_batch_forms(form):
    a = _elems(1, (3, 4, 65))
    b = _elems(2, (3, 65, 6)) if form == "3x3" else _elems(3, (65, 6))
    got = _np(ops.ss_matmul(_t(a), _t(b)))
    for z in range(3):
        bz = b[z] if form == "3x3" else b
        np.testing.assert_array_equal(got[z], np.asarray(
            ss_matmul_pallas(a[z], bz, interpret=True)))


def test_ss_matmul_all_p_minus_one():
    a = np.full((2, 3, 300), P - 1, np.uint32)
    b = np.full((2, 300, 5), P - 1, np.uint32)
    got = _np(ops.ss_matmul(_t(a), _t(b)))
    assert (got == (300 * (P - 1) ** 2) % P).all()


def test_ss_matmul_rejects_bad_shapes():
    with pytest.raises(ValueError):
        ops.ss_matmul(_t(_elems(1, (2, 3))), _t(_elems(2, (4, 5))))
    with pytest.raises(ValueError):
        ops.ss_matmul(_t(_elems(1, (2, 2, 3))), _t(_elems(2, (3, 3, 5))))


# ---------------------------------------------------------------------------
# aa_match
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,b,n,w,a", [(1, 1, 1, 1, 1), (2, 3, 13, 4, 9),
                                       (3, 2, 40, 3, 69), (1, 1, 9, 8, 5)])
def test_aa_match_batch_plain_matches_pallas_and_refs(c, b, n, w, a):
    col = _elems(c * 100 + n, (c, b, n, w, a))
    pat = _elems(w * 10 + a, (c, b, w, a))
    got = _np(aa_match.aa_match_batch_plain(_t(col), _t(pat)))
    want = np.asarray(aa_match_batch_pallas(
        col.reshape(c * b, n, w, a), pat.reshape(c * b, w, a),
        interpret=True)).reshape(c, b, n)
    np.testing.assert_array_equal(got, want)
    for z in range(c):
        for r in range(b):
            np.testing.assert_array_equal(
                got[z, r], np.asarray(jref.aa_match(col[z, r], pat[z, r])))
            np.testing.assert_array_equal(
                got[z, r], _np(ref.aa_match(_t(col[z, r]), _t(pat[z, r]))))


def test_aa_match_plain_chunks_agree(monkeypatch):
    col, pat = _t(_elems(5, (2, 2, 50, 4, 9))), _t(_elems(6, (2, 2, 4, 9)))
    whole = aa_match.aa_match_batch_plain(col, pat)
    monkeypatch.setattr(aa_match, "_PLAIN_CHUNK", 100)
    assert torch.equal(aa_match.aa_match_batch_plain(col, pat), whole)


def test_aa_match_broadcast_column_is_a_view():
    """A column broadcast across B (stride 0) matches like its copy."""
    col = _t(_elems(7, (2, 11, 4, 9)))
    pat = _t(_elems(8, (2, 3, 4, 9)))
    view = col[:, None].expand(2, 3, 11, 4, 9)
    assert view.stride(1) == 0
    got = ops.aa_match_batch(view, pat)
    assert torch.equal(got, ops.aa_match_batch(view.contiguous(), pat))


def test_aa_match_b1_wrappers():
    """B = 1 is the single-predicate match of ``aa_match_pallas``; both
    backends agree with it on CPU tensors."""
    col, pat = _elems(9, (2, 10, 4, 9)), _elems(10, (2, 4, 9))
    want = np.stack([np.asarray(aa_match_pallas(col[z], pat[z],
                                                interpret=True))
                     for z in range(2)])
    for name in ("torch", "cuda"):
        got = backends.get_backend(name).aa_match_batch(
            _t(col)[:, None], _t(pat)[:, None])[:, 0]
        np.testing.assert_array_equal(_np(got), want)


def test_aa_match_rows_equals_gathered_blocks():
    rel = _elems(11, (2, 30, 3, 4, 9))                  # (c, n, m, W, A)
    pat = _elems(12, (2, 4, 4, 9))
    columns, starts, lengths = [0, 2, 2, 1], [0, 5, 29, 10], [30, 7, 1, 0]
    got = _np(ops.aa_match_rows(_t(rel), columns, starts, lengths, _t(pat),
                                30))
    for r, (col, s, ln) in enumerate(zip(columns, starts, lengths)):
        want = np.zeros((2, 30), np.uint32)
        if ln:
            want[:, :ln] = np.asarray(aa_match_batch_pallas(
                rel[:, s:s + ln, col], pat[:, r], interpret=True))
        np.testing.assert_array_equal(got[:, r], want)
    with pytest.raises(ValueError):
        ops.aa_match_rows(_t(rel), [0], [0, 1], [1], _t(pat[:, :1]), 1)


def test_aa_match_rejects_bad_pattern_shape():
    col = _t(_elems(13, (1, 2, 5, 4, 9)))
    with pytest.raises(ValueError):
        ops.aa_match_batch(col, _t(_elems(14, (1, 2, 4, 8))))


def test_match_words_matches_reference_automaton():
    codec = jencoding.Codec(alphabet="\0abcdefgh", word_length=4)
    words = ["abc", "bad", "abc", "", "hhhh", "ab"]
    key = jax.random.PRNGKey(1)
    jcol = jencoding.share_encoded(key, codec.encode_column(words),
                                   n_shares=10)
    jpat = jencoding.share_encoded(jax.random.PRNGKey(2),
                                   codec.encode_word("abc"), n_shares=10)
    want = jautomata.match_words(jcol, jpat)
    got = automata.match_words(Shares(_t(np.asarray(jcol.values)), 1),
                               Shares(_t(np.asarray(jpat.values)), 1))
    assert got.degree == want.degree == 8
    np.testing.assert_array_equal(_np(got.values), np.asarray(want.values))
    cnt = automata.count_column(Shares(_t(np.asarray(jcol.values)), 1),
                                Shares(_t(np.asarray(jpat.values)), 1))
    from repro_torch.core import shamir
    assert int(shamir.interpolate(cnt)) == 2


# ---------------------------------------------------------------------------
# dispatch layer
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    ops.reset_launch_counts()
    ops.ss_matmul(_t(_elems(1, (2, 3))), _t(_elems(2, (3, 2))))
    ops.ss_matmul(_t(_elems(1, (2, 2048))), _t(_elems(2, (2048, 3))))
    ops.aa_match_batch(_t(_elems(3, (1, 1, 4, 2, 3))),
                       _t(_elems(4, (1, 1, 2, 3))))
    ops.aa_slide_batch(_t(_elems(3, (1, 1, 4, 2, 3))),
                       _t(_elems(4, (1, 1, 1, 3))))
    ops.ripple_segment(_t(_elems(5, (2, 3, 4))), _t(_elems(6, (2, 3, 4))))
    ops.share_onehot(torch.tensor([0, 2]), _t(_elems(7, (2, 5))), n_shares=3)
    assert ops.launch_counts() == {"aa_match_batch": 0, "aa_slide_batch": 0,
                                   "ss_matmul": 0, "ss_matmul_tall": 0,
                                   "share_onehot": 0, "ripple_segment": 0,
                                   "ripple_carry": 0}


def test_wrappers_reject_other_devices():
    """A device with no kernel and no plain route raises; meta takes the
    plain version, which yields shapes only."""
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError):
        ops.ss_matmul(other, other)
    a = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    out = ops.ss_matmul(a, a.T)
    assert out.device.type == "meta" and tuple(out.shape) == (2, 2)


def test_backend_registry():
    assert set(backends.available_backends()) >= {"torch", "cuda"}
    default = backends.get_backend(backends.DEFAULT_BACKEND)
    assert default.aa_match_batch is ops.aa_match_batch
    assert default.aa_match_rows is ops.aa_match_rows
    assert default.ss_matmul is ops.ss_matmul
    assert default.share_onehot is ops.share_onehot
    with pytest.raises(ValueError):
        backends.get_backend("nope")
    with pytest.raises(ValueError):
        backends.register_backend(backends.get_backend("torch"))


@pytest.mark.parametrize("kernel", ["aa_match", "ripple", "share_onehot",
                                    "ss_matmul"])
def test_kernel_sources_build_into_the_ignored_build_dir(kernel):
    from repro_torch.kernels import _build
    lib = _build._lib_path(kernel)
    assert lib.parent == _build.build_dir()
    assert lib.parent.relative_to(_build.build_dir().parents[1]).parts[0] \
        == "build"
    assert _build.SOURCES[kernel].exists()


# ---------------------------------------------------------------------------
# encoding (the relation the kernels read)
# ---------------------------------------------------------------------------

def test_codec_encodings_match_reference():
    jc = jencoding.Codec(word_length=8)
    tc = encoding.Codec(word_length=8)
    rows = [["E101", "Adam", "Smith"], ["E102", "", "Taylor"],
            ["x", "John", "Q.-_/@9"]]
    np.testing.assert_array_equal(tc.encode_relation(rows),
                                  jc.encode_relation(rows))
    np.testing.assert_array_equal(tc.encode_word("Eve"), jc.encode_word("Eve"))
    idx = tc.encode_indices(rows)
    np.testing.assert_array_equal(
        encoding.onehot(idx, tc.alphabet_size, "cpu").numpy(),
        jc.encode_relation(rows))
    assert tc.decode_row(jc.encode_relation(rows)[2]) == rows[2]
    for bad in (["toolongword"], ["é"]):
        with pytest.raises(ValueError):
            tc.encode_indices(bad)


def test_number_bits_match_reference():
    for x in (-8, -1, 0, 5, 7):
        np.testing.assert_array_equal(encoding.encode_number_bits(x, 4),
                                      jencoding.encode_number_bits(x, 4))
        assert encoding.decode_number_bits(
            encoding.encode_number_bits(x, 4)) == x
