"""CPU parity of the port's sliding-window matcher and tall-skinny routing.

``aa_slide_batch``'s plain version (and its relation form) is held, bit for
bit, against the reference's Pallas ``aa_slide_batch_pallas`` in interpret
mode and its jnp slide op, on uniform shares with p−1 extremes for every
tile length k = 1..W. The automata helpers built on it (window match,
suffix bit, window count, zero indicator) and the pattern encoders are held
against the reference's on identical shares; with the reference's
polynomial coefficients injected, pattern shares are identical too.
``is_tall_skinny`` must route exactly as the reference does. Tolerance 0:
the arithmetic is exact mod p.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.api.backends import jnp_aa_slide  # noqa: E402
from repro.core import automata as jautomata  # noqa: E402
from repro.core import encoding as jencoding  # noqa: E402
from repro.core import field as jfield  # noqa: E402
from repro.core import shamir as jshamir  # noqa: E402
from repro.kernels import ss_matmul as jssm  # noqa: E402
from repro.kernels.aa_match import aa_slide_batch_pallas  # noqa: E402
from repro_torch.core import automata, encoding, shamir  # noqa: E402
from repro_torch.core.shamir import Shares  # noqa: E402
from repro_torch.kernels import aa_match, ops, ss_matmul  # noqa: E402

P = 2**31 - 1
C, B, N, W, A = 2, 2, 13, 5, 7


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


@pytest.fixture(scope="module")
def col():
    return _elems(1, (C, B, N, W, A))


@pytest.mark.parametrize("k", range(1, W + 1))
def test_slide_plain_matches_pallas_and_jnp(col, k):
    pat = _elems(10 + k, (C, B, k, A))
    got = _np(aa_match.aa_slide_batch_plain(_t(col), _t(pat)))
    assert got.shape == (C, B, N, W - k + 1)
    want = np.asarray(aa_slide_batch_pallas(
        col.reshape(C * B, N, W, A), pat.reshape(C * B, k, A),
        interpret=True)).reshape(got.shape)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jnp_aa_slide(col, pat)))
    np.testing.assert_array_equal(_np(ops.aa_slide_batch(_t(col), _t(pat))),
                                  got)


def test_slide_all_p_minus_one():
    col = np.full((1, 1, 3, 4, 6), P - 1, np.uint32)
    pat = np.full((1, 1, 2, 6), P - 1, np.uint32)
    got = _np(aa_match.aa_slide_batch_plain(_t(col), _t(pat)))
    dot = (6 * (P - 1) ** 2) % P
    assert (got == (dot * dot) % P).all()
    np.testing.assert_array_equal(got, np.asarray(jnp_aa_slide(col, pat)))


def test_slide_plain_chunks_agree(col, monkeypatch):
    pat = _t(_elems(30, (C, B, 2, A)))
    whole = aa_match.aa_slide_batch_plain(_t(col), pat)
    monkeypatch.setattr(aa_match, "_PLAIN_CHUNK", 50)
    assert torch.equal(aa_match.aa_slide_batch_plain(_t(col), pat), whole)


def test_slide_broadcast_column_and_rows_form():
    rel = _elems(31, (C, 20, 3, W, A))                 # (c, n, m, W, A)
    pat = _elems(32, (C, 4, 3, A))
    view = _t(rel)[:, :, 1][:, None].expand(C, 4, 20, W, A)
    assert view.stride(1) == 0
    np.testing.assert_array_equal(
        _np(ops.aa_slide_batch(view, _t(pat))),
        _np(ops.aa_slide_batch(view.contiguous(), _t(pat))))
    columns, starts, lengths = [0, 2, 2, 1], [0, 5, 19, 10], [20, 7, 1, 0]
    got = _np(ops.aa_slide_rows(_t(rel), columns, starts, lengths, _t(pat),
                                20))
    for r, (c, s, ln) in enumerate(zip(columns, starts, lengths)):
        want = np.zeros((C, 20, W - 2), np.uint32)
        if ln:
            want[:, :ln] = np.asarray(jnp_aa_slide(
                rel[:, None, s:s + ln, c], pat[:, r:r + 1]))[:, 0]
        np.testing.assert_array_equal(got[:, r], want)


def test_slide_rejects_bad_tiles(col):
    with pytest.raises(ValueError):
        ops.aa_slide_batch(_t(col), _t(_elems(3, (C, B, W + 1, A))))
    with pytest.raises(ValueError):
        ops.aa_slide_batch(_t(col), _t(_elems(3, (C, B, 2, A + 1))))
    with pytest.raises(ValueError):
        ops.aa_slide_rows(_t(col[:, 0]), [0], [0, 1], [1],
                          _t(_elems(3, (C, 1, 2, A))), 1)


# ---------------------------------------------------------------------------
# automata helpers on identical shares
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shared_words():
    codec = jencoding.Codec(alphabet="\0abn", word_length=6)
    words = ["banana", "nab", "", "anna", "ban", "aaaaaa", "nnb"]
    jcol = jencoding.share_encoded(jax.random.PRNGKey(3),
                                   codec.encode_column(words), n_shares=16)
    return codec, words, jcol


@pytest.mark.parametrize("body", ["an", "a", "nab", "banana", "bb"])
def test_automata_helpers_match_reference(shared_words, body):
    codec, words, jcol = shared_words
    spec = jencoding.PatternSpec("contains", body)
    jpat = jencoding.share_encoded(
        jax.random.PRNGKey(4), jencoding.encode_pattern_tile(codec, spec),
        n_shares=16)
    tcol = Shares(_t(np.asarray(jcol.values)), 1)
    tpat = Shares(_t(np.asarray(jpat.values)), 1)
    for name in ("slide_windows", "match_suffix", "window_count"):
        want = getattr(jautomata, name)(jcol, jpat)
        got = getattr(automata, name)(tcol, tpat)
        assert got.degree == want.degree, name
        np.testing.assert_array_equal(_np(got.values),
                                      np.asarray(want.values), name)
    m = codec.word_length - len(body) + 1
    p_cnt = automata.window_count(tcol, tpat)
    np.testing.assert_array_equal(
        _np(automata.zero_indicator(p_cnt.values, m)),
        np.asarray(jautomata.zero_indicator(
            jautomata.window_count(jcol, jpat).values, m)))
    opened = _np(shamir.interpolate(automata.match_suffix(tcol, tpat)))
    assert list(opened) == [int(w.endswith(body)) for w in words]
    count = _np(shamir.interpolate(p_cnt))
    assert list(count) == [sum(w[o:o + len(body)] == body for o in range(m))
                           for w in words]


def test_zero_indicator_on_the_domain():
    for m in (1, 2, 5):
        p = torch.arange(0, m + 1, dtype=torch.int32)
        got = _np(automata.zero_indicator(p, m))
        assert list(got) == [1] + [0] * m
        np.testing.assert_array_equal(got, np.asarray(
            jautomata.zero_indicator(np.arange(m + 1, dtype=np.uint32), m)))


# ---------------------------------------------------------------------------
# pattern encodings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", ["ban%", "%ana", "%an%", "b_n%", "banana",
                                     "b_nd_na", "_", "a%", "%a", "%a%"])
def test_parse_like_and_encoders_match_reference(pattern):
    assert encoding.parse_like(pattern) == jencoding.parse_like(pattern)
    kind, body, wild = encoding.parse_like(pattern)
    if kind == "exact":
        return
    codec, jcodec = encoding.Codec(word_length=8), jencoding.Codec(
        word_length=8)
    spec = encoding.PatternSpec(kind, body, wild, pattern)
    jspec = jencoding.PatternSpec(kind, body, wild, pattern)
    assert spec.length == jspec.length and spec.windows(8) == jspec.windows(8)
    np.testing.assert_array_equal(encoding.encode_pattern_tile(codec, spec),
                                  jencoding.encode_pattern_tile(jcodec, jspec))
    np.testing.assert_array_equal(encoding.encode_pattern_word(codec, spec),
                                  jencoding.encode_pattern_word(jcodec, jspec))


@pytest.mark.parametrize("pattern", ["a%b%", "%a_b", "%%", "", "%", "_%_%"])
def test_parse_like_rejections(pattern):
    with pytest.raises(ValueError):
        jencoding.parse_like(pattern)
    with pytest.raises(ValueError):
        encoding.parse_like(pattern)


def test_pattern_spec_rejections():
    codec = encoding.Codec(word_length=4)
    for args in [("bogus", "ab"), ("prefix", ""), ("suffix", "a_", (1,)),
                 ("contains", "ab", (0,)), ("prefix", "ab", (2,)),
                 ("prefix", "a\0")]:
        with pytest.raises(ValueError):
            encoding.PatternSpec(*args)
    with pytest.raises(ValueError):                    # k > W
        encoding.encode_pattern_tile(codec,
                                     encoding.PatternSpec("suffix", "abcde"))
    with pytest.raises(ValueError):                    # not in the alphabet
        encoding.encode_pattern_tile(codec, encoding.PatternSpec("prefix",
                                                                 "é"))


def test_pattern_shares_with_reference_coeffs_are_identical():
    codec, jcodec = encoding.Codec(word_length=8), jencoding.Codec(
        word_length=8)
    key = jax.random.PRNGKey(12)
    for kind, body, wild in [("masked", "b_n", (1,)), ("suffix", "ana", ()),
                             ("prefix", "ba", ())]:
        spec = encoding.PatternSpec(kind, body, wild)
        jspec = jencoding.PatternSpec(kind, body, wild)
        enc = (jencoding.encode_pattern_word(jcodec, jspec)
               if kind == "masked" else
               jencoding.encode_pattern_tile(jcodec, jspec))
        want = jencoding.share_encoded(key, enc, n_shares=9, degree=2)
        coeffs = np.asarray(jfield.uniform(key, (2,) + enc.shape))
        got = encoding.share_pattern(codec, spec, n_shares=9, degree=2,
                                     coeffs=_t(coeffs))
        np.testing.assert_array_equal(_np(got.values), np.asarray(want.values))


def test_contains_reshare_with_injected_subshares_is_identical(shared_words):
    """The CONTAINS round: window count, degree-reduction re-share and zero
    test open the reference's exact shares when its sub-shares are
    injected."""
    codec, words, jcol = shared_words
    jpat = jencoding.share_encoded(
        jax.random.PRNGKey(5), jencoding.encode_pattern_tile(
            codec, jencoding.PatternSpec("contains", "an")), n_shares=16)
    jcnt = jautomata.window_count(jcol, jpat)
    key = jax.random.PRNGKey(6)
    jred = jshamir.reduce_degree(key, jcnt, target_degree=1)
    m = codec.word_length - 1
    want = jautomata.zero_indicator(jred.values, m)
    cnt = automata.window_count(Shares(_t(np.asarray(jcol.values)), 1),
                                Shares(_t(np.asarray(jpat.values)), 1))
    sub = np.asarray(jfield.uniform(key, (1, cnt.degree + 1) + cnt.shape))
    red = shamir.reduce_degree(cnt, target_degree=1, sub_coeffs=_t(sub))
    got = automata.zero_indicator(red.values, m)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    bits = _np(shamir.interpolate(Shares(got, m)))
    assert list(bits) == [int("an" not in w) for w in words]


# ---------------------------------------------------------------------------
# tall-skinny routing
# ---------------------------------------------------------------------------

def test_is_tall_skinny_agrees_with_reference():
    assert (ss_matmul.TALL_MAX_M, ss_matmul.TALL_MIN_K) == \
        (jssm.TALL_MAX_M, jssm.TALL_MIN_K)
    for m in (0, 1, 3, 69, 255, 256, 257, 1000):
        for k in (0, 512, 1023, 1024, 2048, 22080, 131072):
            for n in (1, 128, 2760, 5000):
                assert ss_matmul.is_tall_skinny(m, k, n) == \
                    jssm.is_tall_skinny(m, k, n), (m, k, n)


def test_tall_layout_covers_every_row():
    """Both matmul kernels' row layout (``row_layout``): a warpgroup takes
    nr rows (wgmma's N), a block wgs warpgroups; the slices cover M, none
    lies wholly past M, and two warpgroups come only with an even number
    of slices (every warpgroup of a block computes)."""
    for m in range(1, 1025):
        nr, wgs = ss_matmul.row_layout(m)
        slices = -(-m // nr)
        assert nr in (8, 16, 24, 32) and wgs in (1, 2)
        assert slices * nr >= m and (slices - 1) * nr < m
        assert slices % wgs == 0


@pytest.mark.parametrize("m,k,n", [(3, 1024, 5), (17, 1100, 1)])
def test_tall_shapes_plain_matches_pallas(m, k, n):
    a, b = _elems(40 + m, (m, k)), _elems(50 + n, (k, n))
    assert ss_matmul.is_tall_skinny(m, k, n)
    got = _np(ops.ss_matmul(_t(a)[None], _t(b))[0])
    np.testing.assert_array_equal(got, np.asarray(
        jssm.ss_matmul_tall_pallas(a, b, interpret=True)))
