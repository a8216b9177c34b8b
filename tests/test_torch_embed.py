"""The port's oblivious embedding lookup against the JAX reference, on the CPU.

Both packages get identical inputs through numpy: the reference's shared
table is carried over with ``table_from_arrays`` and the reference's
``token_coeffs`` feed the port's one-hot sharing as ``a1``. Integers (one-hot
shares, lookup shares) must then agree bit for bit and the opened
embeddings must be equal as float32 — tolerance 0, since every step is
exact mod p and the dequantization divides by a power of two. Sizes are
small: V = 64 or 200, D = 16, c = 3-5 clouds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.api.backends import get_backend as jget_backend  # noqa: E402
from repro.core import dataplane as jdataplane  # noqa: E402
from repro.core import field as jfield  # noqa: E402
from repro.core.costs import CostLedger as JLedger  # noqa: E402
from repro.core.queries import embed as jembed  # noqa: E402
from repro.kernels.ss_matmul import share_onehot_pallas  # noqa: E402
from repro.models import private_embed as jpe  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import Codec, ShardedRelation, outsource  # noqa: E402
from repro_torch.core.costs import CostLedger  # noqa: E402
from repro_torch.core.queries import embed  # noqa: E402
from repro_torch.kernels import ops, ss_matmul  # noqa: E402
from repro_torch.models import private_embed as pe  # noqa: E402

P = 2**31 - 1
V, D, C = 64, 16, 4


@pytest.fixture(scope="module")
def table():
    return np.random.default_rng(5).uniform(-2.0, 2.0, (V, D)).astype(
        np.float32)


@pytest.fixture(scope="module")
def tables(table):
    """(reference Shares, port Shares) holding identical table shares."""
    jsh = jpe.setup_private_embed(jax.random.PRNGKey(5), table, n_shares=C)
    tsh = pe.table_from_arrays(np.asarray(jsh.values), jsh.degree,
                               device="cpu")
    return jsh, tsh


def _a1(key, toks, vocab):
    """The reference's coefficients for ``toks`` as a port int32 tensor."""
    return torch.from_numpy(np.asarray(jembed.token_coeffs(
        key, jnp.asarray(toks, jnp.int32), vocab=vocab)).astype(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# share_onehot: the plain version, ops and both backends vs the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,c,toks", [
    (64, 4, [0, 5, 63, 5, 5, 17]),
    (200, 3, [-1, 0, 199, 199, -1, 100, 3]),
    (200, 4, list(np.random.default_rng(3).integers(0, 200, 70))),
    (64, 1, [-1]),
])
def test_share_onehot_plain_bit_identical_to_reference(vocab, c, toks):
    key = jax.random.PRNGKey(8)
    jtoks = jnp.asarray(toks, jnp.int32)
    a1 = _a1(key, toks, vocab)
    tt = torch.tensor(toks, dtype=torch.int32)
    got = _u32(ss_matmul.share_onehot_plain(tt, a1, n_shares=c))
    pallas = np.asarray(share_onehot_pallas(jtoks, jnp.asarray(_u32(a1)),
                                            n_shares=c, interpret=True))
    program = np.asarray(jembed.share_tokens(key, jtoks, vocab=vocab,
                                             n_shares=c).values)
    assert got.shape == (c, len(toks), vocab)
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, program)
    assert np.array_equal(_u32(ops.share_onehot(tt.long(), a1, n_shares=c)),
                          got)
    for name in ("torch", "cuda"):                    # both plain on the CPU
        sh = embed.share_tokens(None, tt, vocab=vocab, n_shares=c,
                                be=api.get_backend(name), a1=a1)
        assert sh.degree == 1 and np.array_equal(_u32(sh.values), got)


def test_share_onehot_p_minus_1_extremes():
    toks = [0, 9, -1, 200, 1]          # 200 is past V: a zero one-hot row
    a1 = torch.full((5, 33), P - 1, dtype=torch.int32)
    a1[1, ::2] = 0
    got = _u32(ss_matmul.share_onehot_plain(torch.tensor(toks), a1,
                                            n_shares=20))
    want = np.asarray(share_onehot_pallas(
        jnp.asarray(toks, jnp.int32), jnp.asarray(_u32(a1)), n_shares=20,
        interpret=True))
    assert np.array_equal(got, want)
    # literal formula in Python integers
    k = np.arange(1, 21, dtype=object)[:, None, None]
    onehot = (np.asarray(toks)[:, None] == np.arange(33)).astype(object)
    lit = (onehot[None] + a1.numpy().astype(object)[None] * k) % P
    assert np.array_equal(got.astype(object), lit)


def test_share_onehot_rejects_bad_operands():
    a1 = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.share_onehot(torch.zeros(2, dtype=torch.int32), a1, n_shares=3)
    with pytest.raises(TypeError):
        ops.share_onehot(torch.zeros(3), a1, n_shares=3)
    with pytest.raises(ValueError):
        ops.share_onehot(torch.zeros(3, dtype=torch.int32), a1, n_shares=0)
    assert ops.share_onehot(torch.zeros(0, dtype=torch.int32),
                            torch.zeros((0, 8), dtype=torch.int32),
                            n_shares=3).shape == (3, 0, 8)


def test_share_tokens_opens_to_onehot():
    from repro_torch.core import shamir
    toks = torch.tensor([0, 5, V - 1])
    sh = embed.share_tokens((8,), toks, vocab=V, n_shares=C,
                            be=api.get_backend("torch"), device="cpu")
    assert sh.values.shape == (C, 3, V)
    opened = shamir.interpolate(sh)
    assert torch.equal(opened, (toks[:, None] == torch.arange(V)).to(
        torch.int32))


# ---------------------------------------------------------------------------
# fixed-point codec: bit-identical to the reference's
# ---------------------------------------------------------------------------

def _both_round_trips(x):
    got_q = embed.quantize_to_field(x, device="cpu")
    want_q = np.asarray(jembed.quantize_to_field(x))
    assert np.array_equal(_u32(got_q), want_q)
    got = embed.dequantize_from_field(got_q).numpy()
    want = np.asarray(jembed.dequantize_from_field(jnp.asarray(want_q)))
    assert got.dtype == np.float32 and np.array_equal(got, want)
    return got


def test_fixed_point_round_trip_at_signed_edges():
    scale = embed.QUANT_SCALE
    edges = np.asarray([0.0, 1.0 / scale, -1.0 / scale, embed.QUANT_RANGE,
                        -embed.QUANT_RANGE, embed.QUANT_RANGE - 1.0 / scale,
                        -(embed.QUANT_RANGE - 1.0 / scale)], np.float32)
    assert np.array_equal(_both_round_trips(edges), edges)


def test_fixed_point_half_ulp_rounds_like_reference():
    ulp = 1.0 / embed.QUANT_SCALE
    x = np.asarray([0.49999 * ulp, 1.50001 * ulp, -0.49999 * ulp,
                    0.5 * ulp, 1.5 * ulp, 2.5 * ulp, -0.5 * ulp, -2.5 * ulp],
                   np.float32)
    back = _both_round_trips(x)
    # round half to even, as jnp.round
    assert np.array_equal(back, np.asarray(
        [0.0, 2 * ulp, 0.0, 0.0, 2 * ulp, 2 * ulp, 0.0, -2 * ulp],
        np.float32))


def test_fixed_point_random_and_float64_input():
    rng = np.random.default_rng(11)
    x = rng.uniform(-embed.QUANT_RANGE, embed.QUANT_RANGE, 1024)
    x32 = x.astype(np.float32)
    back = _both_round_trips(x32)
    assert np.abs(back - x32).max() <= 0.5 / embed.QUANT_SCALE + 1e-7
    _both_round_trips(x)                      # float64 casts to float32 first
    _both_round_trips(torch.from_numpy(x))


def test_overflow_guard_refuses_out_of_range_tables():
    for bad in (embed.QUANT_RANGE * 1.01, -embed.QUANT_RANGE * 1.01,
                float("nan"), float("inf")):
        with pytest.raises(ValueError, match="fixed-point range"):
            embed.quantize_to_field(np.asarray([0.0, bad], np.float32),
                                    device="cpu")
    with pytest.raises(ValueError, match="fixed-point range"):
        pe.setup_private_embed(0, np.full((4, 4), 100.0, np.float32),
                               device="cpu")


def test_setup_private_embed_bit_identical_with_injected_coeffs(table,
                                                                 tables):
    jsh, _ = tables
    coeffs = torch.from_numpy(np.asarray(jfield.uniform(
        jax.random.PRNGKey(5), (1, V, D))).astype(np.int32))  # as make_shares
    got = pe.setup_private_embed(None, table, n_shares=C, coeffs=coeffs,
                                 device="cpu")
    assert got.degree == jsh.degree == 1
    assert np.array_equal(_u32(got.values), np.asarray(jsh.values))
    own = pe.setup_private_embed(7, torch.from_numpy(table), n_shares=C,
                                 device="cpu")
    assert own.values.device.type == "cpu" and own.values.shape == (C, V, D)


# ---------------------------------------------------------------------------
# the engine: lookup shares bit-identical, openings and ledgers equal
# ---------------------------------------------------------------------------

JOB_TOKENS = [[3, 3, 17, V - 1, 0], [7], [1, 2, 60, 2]]


def _jobs(tables, verify=(False, False, False)):
    """Identical reference and port job lists (port a1 injected)."""
    jjobs, tjobs = [], []
    for i, (toks, ver) in enumerate(zip(JOB_TOKENS, verify)):
        key = jax.random.PRNGKey(100 + i)
        jjobs.append(jembed.EmbedJob(np.asarray(toks), key, JLedger(), ver))
        tjobs.append(embed.EmbedJob(np.asarray(toks), (100 + i,),
                                    CostLedger(), ver,
                                    a1=_a1(key, toks, V)))
    return jjobs, tjobs


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_lookup_shares_bit_identical(tables, shards):
    jsh, tsh = tables
    jjobs, tjobs = _jobs(tables)
    plane = ShardedRelation(pe.as_embed_relation(tsh), shards=shards)
    got, spans = embed.lookup_shares(api.get_backend("torch"), plane, tjobs)
    jbe = jget_backend("jnp")
    stacked = jnp.concatenate([jembed.share_tokens(
        j.key, jnp.asarray(j.tokens, jnp.int32), vocab=V, n_shares=C).values
        for j in jjobs], axis=1)
    want = np.asarray(jbe.ss_matmul(stacked, jsh.values))
    assert got.degree == 2
    assert spans == [(0, 5), (5, 6), (6, 10)]
    assert np.array_equal(_u32(got.values), want)
    assert plane.stats.dispatches == shards       # one per shard, all jobs


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_embed_phase_equals_reference(tables, table, shards):
    jsh, tsh = tables
    jjobs, tjobs = _jobs(tables, verify=(False, True, False))
    jrel = jdataplane.ShardedRelation(jpe.as_embed_relation(jsh),
                                      shards=shards)
    trel = ShardedRelation(pe.as_embed_relation(tsh), shards=shards)
    want = jembed.embed_phase(jget_backend("jnp"), jrel, jjobs)
    got = embed.embed_phase(api.get_backend("cuda"), trel, tjobs)
    quant = embed.dequantize_from_field(embed.quantize_to_field(
        table, device="cpu"))
    for toks, g, w, tj, jj in zip(JOB_TOKENS, got, want, tjobs, jjobs):
        assert g.dtype == np.float32 and np.array_equal(g, np.asarray(w))
        assert np.array_equal(g, quant.numpy()[toks])
        assert tj.ledger.as_dict() == jj.ledger.as_dict()


def test_private_lookups_equal_reference(tables, table):
    jsh, tsh = tables
    toks = np.asarray([[3, 3, 17], [V - 1, 0, 9]])
    key = jax.random.PRNGKey(1)
    a1 = _a1(key, toks.reshape(-1), V)
    want = np.asarray(jpe.private_lookup_batched(key, jsh, jnp.asarray(toks)))
    for backend in (None, "torch"):
        got = pe.private_lookup_batched(None, tsh, toks, a1=a1,
                                        backend=backend)
        assert got.shape == (2, 3, D) and np.array_equal(got.numpy(), want)
    assert np.array_equal(pe.private_lookup_batched(
        (4,), tsh, torch.from_numpy(toks), verify=True).numpy(), want)
    for i, t in enumerate(toks.reshape(-1)):
        jkey = jax.random.fold_in(jax.random.PRNGKey(2), i)
        coeffs = torch.from_numpy(np.asarray(jfield.uniform(
            jkey, (1, 1, V))).astype(np.int32))     # as make_shares draws
        one = pe.private_lookup(None, tsh, [int(t)], coeffs=coeffs)
        ref = np.asarray(jpe.private_lookup(jkey, jsh, jnp.asarray([t])))
        assert np.array_equal(one.numpy(), ref)
    quant = embed.dequantize_from_field(embed.quantize_to_field(
        table, device="cpu"))
    assert np.array_equal(want, quant.numpy()[toks])


# ---------------------------------------------------------------------------
# QueryClient: EmbedLookup plans against the reference client
# ---------------------------------------------------------------------------

def _clients(tables, shards):
    jsh, tsh = tables
    jc = japi.QueryClient(key=3)
    jc.attach(jpe.as_embed_relation(jsh), name="emb", shards=shards)
    plane = ShardedRelation(pe.as_embed_relation(tsh), shards=shards)
    return jc, api.QueryClient(plane, seed=3, device="cpu"), plane


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_client_embed_lookup_equals_reference(tables, shards):
    jc, tc, plane = _clients(tables, shards)
    toks = [tuple(int(t) for t in np.random.default_rng(7).integers(0, V, 12)),
            (1, 2), (V - 1,)]
    plans = [(japi.EmbedLookup(tokens=t, verify=i == 1),
              api.EmbedLookup(tokens=t, verify=i == 1))
             for i, t in enumerate(toks)]
    want = jc.run_batch([j for j, _ in plans], relation="emb")
    exp = tc.explain([t for _, t in plans])
    d0 = plane.stats.dispatches
    got = tc.run_batch([t for _, t in plans])
    assert plane.stats.dispatches - d0 == shards    # the batch: S dispatches
    for g, w in zip(got, want):
        assert g.strategy == w.strategy == "embed"
        assert np.array_equal(g.embeddings, np.asarray(w.embeddings))
        assert g.ledger.as_dict() == w.ledger.as_dict()
    (grp,) = exp.groups
    assert grp.family == "embed" and grp.size == 3
    assert exp.bits == sum(r.ledger.communication_bits for r in got)
    assert exp.rounds == max(r.ledger.rounds for r in got) == 2
    assert exp.dispatches == shards
    jexp = jc.explain([j for j, _ in plans], relation="emb")
    assert (exp.bits, exp.rounds) == (jexp.bits, jexp.rounds)
    one = tc.run(api.EmbedLookup(tokens=toks[1]))
    assert np.array_equal(one.embeddings, got[1].embeddings)


def test_estimate_embed_cost_equals_reference():
    for shards, n_tok, verify in ((1, 8, False), (2, 8, True), (3, 1, True)):
        kw = dict(n=V, m=D, c=C, w=8, a=64, shards=shards)
        got = api.estimate_embed_cost(api.DBStats(**kw), n_tokens=n_tok,
                                      verify=verify)
        want = japi.estimate_embed_cost(japi.DBStats(**kw), n_tokens=n_tok,
                                        verify=verify)
        assert (got.strategy, got.bits, got.rounds, got.dispatches) == (
            want.strategy, want.bits, want.rounds, want.dispatches)


# ---------------------------------------------------------------------------
# verification
# ---------------------------------------------------------------------------

def test_verify_passes_honest_and_prices_overhead(tables):
    _, tc, _ = _clients(tables, 1)
    base = tc.run(api.EmbedLookup(tokens=(1, 2, 3)))
    ver = tc.run(api.EmbedLookup(tokens=(1, 2, 3), verify=True))
    assert np.array_equal(ver.embeddings, base.embeddings)
    assert ver.ledger.rounds == base.ledger.rounds + 1
    assert ver.ledger.communication_bits > base.ledger.communication_bits


def test_verify_catches_tampered_table_share(table):
    jsh = jpe.setup_private_embed(jax.random.PRNGKey(5), table, n_shares=5)
    vals = np.asarray(jsh.values).copy()
    vals[4, 7, 3] ^= 1                      # cloud 4 lies about one word
    bad = pe.table_from_arrays(vals, jsh.degree, device="cpu")
    tc = api.QueryClient(pe.as_embed_relation(bad), seed=1, device="cpu")
    with pytest.raises(api.VerificationError):
        tc.run(api.EmbedLookup(tokens=(7,), verify=True))
    with pytest.raises(api.VerificationError):
        pe.private_lookup_batched(1, bad, [7], verify=True)
    tc.run(api.EmbedLookup(tokens=(7,)))    # without verify: unnoticed
    # too few clouds to cross-check a degree-2 opening
    three = pe.table_from_arrays(vals[:3], jsh.degree, device="cpu")
    with pytest.raises(api.VerificationError, match="clouds"):
        pe.private_lookup_batched(1, three, [7], verify=True)


# ---------------------------------------------------------------------------
# rejections
# ---------------------------------------------------------------------------

def test_rejects_out_of_range_tokens(tables):
    _, tsh = tables
    _, tc, _ = _clients(tables, 2)
    with pytest.raises(ValueError, match="out of range"):
        tc.run(api.EmbedLookup(tokens=(0, V)))
    with pytest.raises(ValueError, match="out of range"):
        pe.private_lookup_batched(1, tsh, [-1, 2])
    with pytest.raises(ValueError, match="out of range"):
        pe.private_lookup(1, tsh, [V])


def test_rejects_empty_and_negative_plans(tables):
    _, tsh = tables
    with pytest.raises(ValueError):
        api.EmbedLookup(tokens=())
    with pytest.raises(ValueError):
        api.EmbedLookup(tokens=(1, -2))
    assert api.EmbedLookup(tokens=[np.int64(3), 1]).tokens == (3, 1)
    with pytest.raises(ValueError, match="at least one token"):
        embed.embed_phase(api.get_backend("torch"),
                          pe.as_embed_relation(tsh),
                          [embed.EmbedJob([], (1,), CostLedger())])
    with pytest.raises(ValueError, match="at least one token"):
        embed.share_tokens((1,), [], vocab=V, n_shares=C,
                           be=api.get_backend("torch"), device="cpu")
    assert embed.embed_phase(api.get_backend("torch"),
                             pe.as_embed_relation(tsh), []) == []


def test_rejects_non_embedding_relation():
    db = outsource([["ab", "c"], ["b", "ca"]], n_shares=4,
                   codec=Codec(alphabet="\0abc", word_length=2),
                   device="cpu")
    with pytest.raises(ValueError, match="embedding relation"):
        api.QueryClient(db, seed=1, device="cpu").run(
            api.EmbedLookup(tokens=(1,)))
    with pytest.raises(ValueError, match="expected a"):
        pe.as_embed_relation(db.relation)
    with pytest.raises(ValueError, match="expected a"):
        pe.table_from_arrays(np.zeros((4, 8), np.uint32), 1, device="cpu")


def test_rejects_backend_without_share_onehot(tables):
    _, tsh = tables
    plain = api.get_backend("torch")
    bare = api.Backend("bare", ss_matmul=plain.ss_matmul,
                       aa_match_batch=plain.aa_match_batch,
                       aa_match_rows=plain.aa_match_rows)
    tc = api.QueryClient(pe.as_embed_relation(tsh), seed=1, device="cpu",
                         backend=bare)
    with pytest.raises(ValueError, match="share_onehot"):
        tc.run(api.EmbedLookup(tokens=(1,)))
    with pytest.raises(ValueError, match="share_onehot"):
        pe.private_lookup_batched(1, tsh, [1], backend=bare)
    with pytest.raises(ValueError, match="share_onehot"):
        api.onehot_sharer(bare)


def test_entry_points_default_to_cuda(table):
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pe.setup_private_embed(0, table)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pe.setup_private_embed(0, torch.from_numpy(table))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        embed.quantize_to_field(torch.from_numpy(table))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pe.table_from_arrays(np.zeros((4, 2, 2), np.uint32), 1)
