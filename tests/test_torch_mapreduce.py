"""The port's MapReduce runtime and executor against the JAX reference.

``repro_torch.runtime.MapReduceRunner`` must recover from crashed, dead and
slow workers (re-execution at lease expiry, speculative backups), and
``MapReduceExecutor.wrap`` must split every op of the port's ``Backend``
along a data axis without changing a bit: each wrapped op equals its base
op on random field tensors (the row-block ops through narrowed blocks, the
relation read in place), and a wrapped client opens the same counts, rows,
values and ``CostLedger``s as the unwrapped port client for every query
family (injected dead and slow workers included), as the reference's
wrapped client for one mixed batch of all of them, and through
``MapReduceDispatcher`` at S = 1-4 shards. ``share_onehot`` passes through
unsplit, so an embedding lookup through a wrapped client calls it once.
Sizes are small (``_torch_serving``); the tolerance is 0.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_serving as data  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.runtime import MapReduceRunner as JRunner  # noqa: E402
from repro.runtime import WorkerPool as JPool  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import backends  # noqa: E402
from repro_torch.core import ShardedRelation  # noqa: E402
from repro_torch.kernels import ops, ripple  # noqa: E402
from repro_torch.models import private_embed as pe  # noqa: E402
from repro_torch.runtime import MapReduceRunner, WorkerPool  # noqa: E402
from repro_torch.runtime import mapreduce  # noqa: E402

P = 2**31 - 1


@pytest.fixture(scope="module")
def rels():
    return data.relations(jax)


def _faulty(n_splits=4):
    """An executor whose worker 3 never answers and whose worker 2
    straggles: an op split 4 ways gets its last task from worker 3 and
    recovers it by a speculative backup once the other three are in (an
    op with fewer splits never reaches worker 3). The lease is long, so a
    task slowed by a loaded machine is not declared dead; the runner tests
    above exercise lease expiry."""
    pool = WorkerPool(4, dead_workers={3}, slow_workers={2: 0.01}, seed=3)
    return api.MapReduceExecutor(
        MapReduceRunner(pool, lease_s=5.0, max_attempts=8),
        n_splits=n_splits)


# ---------------------------------------------------------------------------
# the runner (as tests/test_substrate.py's MapReduce cases)
# ---------------------------------------------------------------------------

def test_runner_happy_path():
    runner = MapReduceRunner(WorkerPool(4), lease_s=5.0)
    assert runner.run(lambda x: x * x, list(range(20)), sum) == \
        sum(i * i for i in range(20))
    assert runner.reexecutions == 0 and runner.worker_deaths == 0


def test_runner_reexecutes_failed_tasks():
    runner = MapReduceRunner(WorkerPool(4, fail_prob=0.4, seed=1),
                             lease_s=0.05, max_attempts=50)
    assert runner.run(lambda x: x + 1, list(range(12)), sum) == \
        sum(range(1, 13))
    assert runner.reexecutions > 0


def test_runner_dead_worker_recovery():
    runner = MapReduceRunner(WorkerPool(3, dead_workers={1}, seed=2),
                             lease_s=0.05, max_attempts=20)
    assert runner.run(lambda x: 2 * x, list(range(9)), sum) == \
        sum(2 * i for i in range(9))
    assert runner.worker_deaths > 0 and runner.reexecutions > 0


def test_runner_speculative_backup_beats_straggler():
    # worker 0 sleeps far past the lease; the backup copy must win
    runner = MapReduceRunner(WorkerPool(4, slow_workers={0: 2.0}),
                             lease_s=0.3, spec_threshold=0.5,
                             max_attempts=10)
    t0 = time.time()
    assert runner.run(lambda x: x, list(range(8)), sum) == sum(range(8))
    assert time.time() - t0 < 2.0
    assert runner.speculative_launched > 0


def test_runner_relays_task_errors_and_caps_attempts():
    runner = MapReduceRunner(WorkerPool(2), lease_s=1.0)

    def boom(x):
        if x == 3:
            raise ValueError("split 3")
        return x
    with pytest.raises(ValueError, match="split 3"):
        runner.run(boom, list(range(6)))
    dead = MapReduceRunner(WorkerPool(1, dead_workers={0}), lease_s=0.02,
                           max_attempts=2)
    with pytest.raises(RuntimeError, match="exceeded max attempts"):
        dead.run(lambda x: x, [0])


def test_runner_threads_are_named():
    seen = []
    MapReduceRunner(WorkerPool(2)).run(
        lambda x: seen.append(threading.current_thread().name), [0, 1])
    assert seen == [mapreduce.THREAD_NAME] * 2


# ---------------------------------------------------------------------------
# every Backend field: wrapped == base on random field tensors
# ---------------------------------------------------------------------------

def _field(shape, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, P, shape, generator=g, dtype=torch.int32)
    return torch.where(torch.rand(shape, generator=g) < 0.1,
                       torch.full_like(x, P - 1), x)


def _bits(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2, shape, generator=g, dtype=torch.int32)


class _Spy:
    """Records the tensors the base ops see."""

    def __init__(self):
        self.rels = []
        self.onehot_calls = 0

    def backend(self):
        base = backends.get_backend("cuda")

        def rows(op):
            def run(rel, *a):
                self.rels.append(rel)
                return op(rel, *a)
            return run

        def onehot(tokens, a1, *, n_shares):
            self.onehot_calls += 1
            return base.share_onehot(tokens, a1, n_shares=n_shares)

        return backends.Backend(
            "spy", ss_matmul=base.ss_matmul,
            aa_match_batch=base.aa_match_batch,
            aa_match_rows=rows(base.aa_match_rows),
            ripple_segment=base.ripple_segment,
            ripple_carry=base.ripple_carry,
            aa_slide_batch=base.aa_slide_batch,
            aa_slide_rows=rows(base.aa_slide_rows),
            share_onehot=onehot, match_matrix=base.match_matrix,
            match_matrix_batch=base.match_matrix_batch)


@pytest.mark.parametrize("n_splits", [1, 3, 4])
def test_wrapped_ops_equal_base(n_splits):
    spy = _Spy()
    base = spy.backend()
    be = _faulty(n_splits).wrap(base)
    assert be.name == "spy+mapreduce"
    # ss_matmul: 2-D, cloud batch, shared right operand, zero rows
    for sa, sb in [((7, 30), (30, 5)), ((3, 6, 40), (3, 40, 9)),
                   ((2, 5, 33), (33, 4)), ((2, 0, 8), (2, 8, 3))]:
        a, b = _field(sa, 1), _field(sb, 2)
        assert torch.equal(be.ss_matmul(a, b), base.ss_matmul(a, b))
    # the stacked matchers, a broadcast column (B-stride 0) included
    col = _field((3, 2, 13, 4, 5), 3)
    wide = _field((3, 1, 13, 4, 5), 4).expand(3, 3, 13, 4, 5)
    for c in (col, wide):
        b = c.shape[1]
        pat = _field((3, b, 4, 5), 5)
        assert torch.equal(be.aa_match_batch(c, pat),
                           base.aa_match_batch(c, pat))
        tile = _field((3, b, 2, 5), 6)
        assert torch.equal(be.aa_slide_batch(c, tile),
                           base.aa_slide_batch(c, tile))
    # row blocks: ragged, zero-length, one row, a block at the very end
    rel = _field((3, 13, 3, 4, 5), 7)
    cols, starts, lens, height = [0, 2, 1, 2], [0, 5, 13, 12], \
        [13, 4, 0, 1], 13
    pat = _field((3, 4, 4, 5), 8)
    spy.rels.clear()
    assert torch.equal(be.aa_match_rows(rel, cols, starts, lens, pat, height),
                       base.aa_match_rows(rel, cols, starts, lens, pat,
                                          height))
    tile = _field((3, 4, 3, 5), 9)
    got = be.aa_slide_rows(rel, cols, starts, [6, 4, 0, 1], tile, 6)
    assert torch.equal(got, base.aa_slide_rows(rel, cols, starts,
                                               [6, 4, 0, 1], tile, 6))
    # the relation itself reached every task: never a stacked copy
    assert spy.rels and all(r is rel for r in spy.rels)
    # ripple: LSB start and carried, bit-major lanes and a k = 1 step
    a, b = _bits((3, 2, 17, 5), 10), _bits((3, 2, 17, 5), 11)
    carry = _bits((3, 2, 17), 12)
    for cin in (None, carry):
        for got, want in zip(be.ripple_segment(a, b, cin),
                             base.ripple_segment(a, b, cin)):
            assert torch.equal(got, want)
        for got, want in zip(be.ripple_carry(a[..., 0], b[..., 0], cin),
                             base.ripple_carry(a[..., 0], b[..., 0], cin)):
            assert torch.equal(got, want)
    planes = ripple.bit_major([_bits((3, 2, 17, 5), 13)], 0)
    for got, want in zip(be.ripple_segment(planes, planes),
                         base.ripple_segment(planes, planes)):
        assert torch.equal(got, want)
    # all-pairs word match: one pair and a stacked group
    bx, by = _bits((3, 9, 4, 5), 14), _bits((3, 6, 4, 5), 15)
    assert torch.equal(be.match_matrix(bx, by), base.match_matrix(bx, by))
    sx, sy = _bits((3, 2, 9, 4, 5), 16), _bits((3, 2, 6, 4, 5), 17)
    assert torch.equal(be.match_matrix_batch(sx, sy),
                       base.match_matrix_batch(sx, sy))
    # share_onehot passes through unsplit: the base op itself
    assert be.share_onehot is base.share_onehot


def test_wrap_keeps_absent_ops_absent():
    be = _faulty().wrap(backends.get_backend("torch"))
    assert be.match_matrix_batch is None
    assert be.share_onehot is backends.get_backend("torch").share_onehot
    # the registry steps the wrapped single-pair matcher over the group
    bx, by = _bits((3, 2, 9, 4, 5), 16), _bits((3, 2, 6, 4, 5), 17)
    assert torch.equal(backends.batched_match_matrix(be)(bx, by),
                       ops.match_matrix_batch(bx, by))


# ---------------------------------------------------------------------------
# wrapped clients: every family against the unwrapped port client and the
# reference's wrapped client
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("family", data.FAMILIES)
def test_wrapped_client_equals_unwrapped(rels, family, shards):
    (_, tx), (_, tk), (_, tt) = rels["X"], rels["K"], rels["T"]
    plans = data.plans(api, family, tk, tt)
    want = api.QueryClient(tx, 5, device="cpu").run_batch(plans)
    ex = _faulty()
    got = api.QueryClient(ShardedRelation(tx, shards=shards), 5,
                          device="cpu", executor=ex).run_batch(plans)
    for a, b in zip(want, got):
        data.same(a, b)
    assert ex.runner.speculative_launched > 0   # the dead worker's tasks


@pytest.fixture(scope="module")
def ref_mixed(rels):
    """The reference's wrapped client (jnp backend, 3 splits) over one mixed
    batch of every family."""
    jc = japi.QueryClient(rels["X"][0], key=5, backend="jnp",
                          executor=japi.MapReduceExecutor(
                              JRunner(JPool(2)), n_splits=3))
    return jc.run_batch(data.mixed(japi, rels, 0))


def test_wrapped_client_equals_reference_wrapped(rels, ref_mixed):
    ex = _faulty()
    tc = api.QueryClient(rels["X"][1], 5, device="cpu", executor=ex)
    assert tc.backend.name == "cuda+mapreduce" and tc.executor is ex
    for a, b in zip(ref_mixed, tc.run_batch(data.mixed(api, rels, 1))):
        data.same(a, b)
    assert ex.runner.speculative_launched > 0


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_mapreduce_dispatcher_places_shards(rels, ref_mixed, shards):
    """Each shard dispatch as one map task: the reference wrapped client's
    transcript (shard placement never changes one) at every S."""
    ex = _faulty()
    tc = api.QueryClient(device="cpu", seed=6)
    plane = tc.attach(rels["X"][1], shards=shards,
                      dispatcher=ex.dispatcher(), key=5)
    assert isinstance(plane.dispatcher, api.MapReduceDispatcher)
    for a, b in zip(ref_mixed, tc.run_batch(data.mixed(api, rels, 1))):
        data.same(a, b)
    assert plane.stats.dispatches == plane.stats.steps * plane.n_shards
    if plane.n_shards == 4:                     # worker 3 takes shard 3
        assert ex.runner.speculative_launched > 0


@pytest.mark.parametrize("shards", [1, 2])
def test_wrapped_embedding_lookup_passes_share_onehot_through(shards):
    table = np.random.default_rng(5).uniform(-2, 2, (64, 8)).astype(
        np.float32)
    rel = pe.as_embed_relation(pe.setup_private_embed(
        5, table, n_shares=4, device="cpu"))
    plans = [api.EmbedLookup(tokens=(3, 17, 3, 63)),
             api.EmbedLookup(tokens=(0, 5), verify=True)]
    want = api.QueryClient(ShardedRelation(rel, shards=shards), 2,
                           device="cpu").run_batch(plans)
    spy = _Spy()
    client = api.QueryClient(ShardedRelation(rel, shards=shards), 2,
                             device="cpu", backend=spy.backend(),
                             executor=_faulty())
    got = client.run_batch(plans)
    assert spy.onehot_calls == 1             # one fused sharing, unsplit
    for a, b in zip(want, got):
        assert np.array_equal(a.embeddings, b.embeddings)
        assert a.ledger.as_dict() == b.ledger.as_dict()
    assert np.array_equal(got[0].embeddings[0], got[0].embeddings[2])


def test_split_bounds_follow_the_partition_rule():
    ex = api.MapReduceExecutor(MapReduceRunner(WorkerPool(2)), n_splits=4)
    seen = []
    ex._split(131072, lambda lo, hi: seen.append((lo, hi)))
    assert sorted(seen) == [(0, 32768), (32768, 65536), (65536, 98304),
                            (98304, 131072)]
    assert all(lo % 4 == 0 for lo, _ in seen)    # ripple lanes stay aligned
