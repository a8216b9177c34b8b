"""The port's threaded dataplane against the JAX reference.

``ThreadedDispatcher`` and its weighted ``PoolHandle``s: deficit-round-robin
admission (a 3:1 weight split serves h h h c, a flood cannot starve a
neighbour, exceptions stay with their unit, ``close()`` drains queued
units), threaded shards opening the same counts, rows, values and
``CostLedger``s as serial shards and as the reference at S = 1, 2 and 4,
and ``fused_execute`` returning bit-identical combined tensors whether a
wave fuses or not. Sizes are small (``_torch_serving``); the tolerance is 0.
"""
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_serving as data  # noqa: E402
from repro import api as japi  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import ShardedRelation, dataplane  # noqa: E402
from repro_torch.core.dataplane import (PoolHandle,  # noqa: E402
                                        ThreadedDispatcher, fused_execute)

FAMILIES = ["count", "select", "pattern", "range", "join"]


@pytest.fixture(scope="module")
def rels():
    return data.relations(jax)


@pytest.fixture(scope="module")
def reference(rels):
    """The reference's serial transcript of one mixed batch."""
    return japi.QueryClient(rels["X"][0], key=9, backend="jnp").run_batch(
        data.mixed(japi, rels, 0, FAMILIES))


def _tagger(tag, log, lock, gate=None):
    def thunk():
        if gate is not None:
            gate.wait(5.0)
        with lock:
            log.append(tag)
        return tag
    return thunk


# ---------------------------------------------------------------------------
# weighted fair quotas (as tests/test_pool_quotas.py)
# ---------------------------------------------------------------------------

def test_weighted_service_is_proportional():
    """With the single worker gated, a 3:1 weight split serves exactly 3
    hot units per cold unit per round-robin visit."""
    pool = ThreadedDispatcher(max_workers=1)
    hot, cold = pool.handle(weight=3.0), pool.handle(weight=1.0)
    log, lock, gate = [], threading.Lock(), threading.Event()
    gate_f = pool.enqueue(pool.handle(), [_tagger("gate", log, lock, gate)])
    hot_f = pool.enqueue(hot, [_tagger("h", log, lock) for _ in range(24)])
    cold_f = pool.enqueue(cold, [_tagger("c", log, lock) for _ in range(8)])
    gate.set()
    for f in gate_f + hot_f + cold_f:
        assert f.result(timeout=10) in ("gate", "h", "c")
    pool.close()
    body = [t for t in log if t != "gate"]
    assert body[:16] == ["h", "h", "h", "c"] * 4
    assert body.count("h") == 24 and body.count("c") == 8


def test_flood_cannot_starve_neighbour():
    pool = ThreadedDispatcher(max_workers=1)
    hot, cold = pool.handle(), pool.handle()
    log, lock, gate = [], threading.Lock(), threading.Event()
    gate_f = pool.enqueue(pool.handle(), [_tagger("gate", log, lock, gate)])
    hot_f = pool.enqueue(hot, [_tagger("h", log, lock) for _ in range(40)])
    cold_f = pool.enqueue(cold, [_tagger("c", log, lock)])
    gate.set()
    for f in gate_f + hot_f + cold_f:
        f.result(timeout=10)
    pool.close()
    body = [t for t in log if t != "gate"]
    assert body.index("c") <= 2, body[:6]


def test_weight_validation():
    pool = ThreadedDispatcher(max_workers=1)
    for w in (0.0, -1.5):
        with pytest.raises(ValueError):
            pool.handle(weight=w)
    pool.close()


def test_exceptions_propagate_per_unit():
    pool = ThreadedDispatcher(max_workers=2)
    h = pool.handle()

    def boom():
        raise ValueError("unit failure")

    futs = pool.enqueue(h, [lambda: 1, boom, lambda: 3])
    assert futs[0].result(timeout=10) == 1
    with pytest.raises(ValueError, match="unit failure"):
        futs[1].result(timeout=10)
    assert futs[2].result(timeout=10) == 3
    with pytest.raises(ValueError, match="unit failure"):
        h.run_all([lambda: 1, boom])
    pool.close()


def test_close_drains_queued_units():
    pool = ThreadedDispatcher(max_workers=1)
    h = pool.handle()
    gate = threading.Event()
    slow_f = pool.enqueue(h, [lambda: gate.wait(5.0) and "slow"])
    queued = pool.enqueue(h, [lambda i=i: i for i in range(5)])
    gate.set()
    pool.close()
    assert slow_f[0].result(timeout=5) == "slow"
    assert [f.result(timeout=5) for f in queued] == [0, 1, 2, 3, 4]
    # handles of a closed pool run serially, still correct
    assert h.run_all([lambda: 7, lambda: 8]) == [7, 8]


def test_run_all_surface_and_detached_handle():
    pool = ThreadedDispatcher(max_workers=4)
    assert pool.run_all([lambda i=i: i * i for i in range(8)]) == \
        [i * i for i in range(8)]
    h = pool.handle()
    h.close()
    names = h.run_all([lambda: threading.current_thread().name] * 2)
    assert names == [threading.current_thread().name] * 2
    pool.close()


def test_drr_stress_no_lost_units():
    """More workers than cores, a short switch interval and four handles
    racing enqueue: every unit runs exactly once and the in-flight count
    returns to 0 (a lost update under the lock would break either)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pool = ThreadedDispatcher(max_workers=16)
        handles = [pool.handle(weight=w) for w in (0.5, 1.0, 2.0, 3.0)]
        hits, lock = [], threading.Lock()

        def unit(i):
            def run():
                with lock:
                    hits.append(i)
                return i
            return run

        futs, flock = [], threading.Lock()

        def submit(h, base):
            got = h._shared_pool.enqueue(h, [unit(base + i)
                                             for i in range(200)])
            with flock:
                futs.extend(got)

        threads = [threading.Thread(target=submit, args=(h, 1000 * k))
                   for k, h in enumerate(handles)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert sorted(f.result(timeout=30) for f in futs) == sorted(hits)
        assert len(hits) == 800 and len(set(hits)) == 800
        # a unit's future resolves just before its slot is released
        deadline = time.monotonic() + 10
        while pool._inflight and time.monotonic() < deadline:
            time.sleep(0.001)
        assert pool._inflight == 0
        pool.close()
    finally:
        sys.setswitchinterval(old)


# ---------------------------------------------------------------------------
# threaded shards == serial shards == the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("placement", ["serial", "threaded", "handle"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_threaded_equals_serial_and_reference(rels, reference, shards,
                                              placement):
    pool = ThreadedDispatcher(max_workers=4)
    disp = {"serial": None, "threaded": pool,
            "handle": pool.handle(weight=2.0)}[placement]
    plane = ShardedRelation(rels["X"][1], shards=shards, dispatcher=disp)
    got = api.QueryClient(plane, 9, device="cpu").run_batch(
        data.mixed(api, rels, 1, FAMILIES))
    pool.close()
    for a, b in zip(reference, got):
        data.same(a, b)
    assert plane.stats.dispatches == plane.stats.steps * shards
    assert plane.stats.fused_steps == 0


# ---------------------------------------------------------------------------
# fused_execute
# ---------------------------------------------------------------------------

def _sum_step(plane):
    """One cloud step: per-shard column sums of the relation (mod p)."""
    from repro_torch.core import field
    return plane.dispatch_set(
        lambda v, sh: field.sum_(v.relation.values[:, :, 1], dim=1),
        reduce="sum")


def _concat_step(plane):
    return plane.dispatch_set(lambda v, sh: v.relation.values[:, :, 0, 0],
                              reduce="concat", axis=1)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_fused_execute_bit_identity(rels, shards):
    x, k = rels["X"][1], rels["K"][1]
    pool = ThreadedDispatcher(max_workers=3)
    pa = ShardedRelation(x, shards=shards, dispatcher=pool.handle(2.0))
    pb = ShardedRelation(k, shards=shards, dispatcher=pool)
    pc = ShardedRelation(x, shards=shards)                # serial
    want = [ShardedRelation(r, shards=1).execute(step(
        ShardedRelation(r, shards=1))) for r, step in
        ((x, _sum_step), (k, _concat_step), (x, _concat_step))]
    got = fused_execute([(pa, _sum_step(pa)), (pb, _concat_step(pb)),
                         (pc, _concat_step(pc))])
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    # the two pooled planes fused into one wave, the serial one did not
    assert pa.stats.fused_steps == 1 and pb.stats.fused_steps == 1
    assert pc.stats.fused_steps == 0 and pc.stats.steps == 1
    assert pa.stats.dispatches == pa.n_shards
    # a lone pooled plane, a detached handle and a closed pool never fuse
    h = pool.handle()
    pd = ShardedRelation(x, shards=shards, dispatcher=h)
    assert dataplane._fusion_pool(pd) is pool
    h.close()
    assert dataplane._fusion_pool(pd) is None
    (alone,) = fused_execute([(pa, _sum_step(pa))])
    assert torch.equal(alone, want[0]) and pa.stats.fused_steps == 1
    pool.close()
    assert dataplane._fusion_pool(pa) is None
    got = fused_execute([(pa, _sum_step(pa)), (pb, _concat_step(pb))])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert pa.stats.fused_steps == 1


def test_fused_execute_relays_a_failing_shard():
    pool = ThreadedDispatcher(max_workers=2)
    x = data.pair(jax, 7, data.ROWS[:4], data.NAMES)[1]
    pa = ShardedRelation(x, shards=2, dispatcher=pool.handle())
    pb = ShardedRelation(x, shards=2, dispatcher=pool.handle())

    def bad(v, sh):
        raise RuntimeError("kernel launch failed")

    with pytest.raises(RuntimeError, match="kernel launch failed"):
        fused_execute([(pa, _sum_step(pa)),
                       (pb, pb.dispatch_set(bad, reduce="sum"))])
    pool.close()
    assert isinstance(pa.dispatcher, PoolHandle)
