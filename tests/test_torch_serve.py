"""The port's QueryServer against the JAX reference's, on the CPU.

The reference's model-free serving tests (``tests/test_serve_async.py``,
``test_serve_multi.py``, ``test_serve_overload.py``) run against
``repro_torch.launch.serve`` with ``device="cpu"``: deadline and fill
closes, fault isolation, draining and non-draining stops, stats read under
concurrent pumps, multi-tenant routing with per-relation batching policies
and key streams, adaptive deadline steering and the floored scheduler park.
Beyond them: the same plans through the reference ``QueryServer`` and the
port's (synchronous ``pump``) open the same counts, rows and ledgers and
close for the same reasons; two relations due in one scan run as one fused
wave; and a backend op that raises on a pool thread surfaces as the
request's ``error`` without the server switching backend. Every wait has a
timeout. Opened values and ledgers are exact, so the tolerance is 0.
"""
import threading
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_serving as data  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.core import Codec as JCodec  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import (Between, Count, Eq, RangeCount,  # noqa: E402
                             Select)
from repro_torch.core import ShardedRelation, ThreadedDispatcher  # noqa: E402
from repro_torch.core.queries import CardinalityError  # noqa: E402
from repro_torch.launch.serve import (MIN_PARK_S,  # noqa: E402
                                      MIN_STEER_WAIT_S, STEER_SHRINK,
                                      QueryRequest, QueryServer, ServeStats,
                                      ServerStopped, plan_family)

CODEC = JCodec(word_length=8)
EMP_COLUMNS = ["EmployeeId", "FirstName", "LastName", "Salary",
               "Department"]
EMPLOYEE = [
    ["E101", "Adam", "Smith", "1000", "Sale"],
    ["E102", "John", "Taylor", "2000", "Design"],
    ["E103", "Eve", "Smith", "500", "Sale"],
    ["E104", "John", "Williams", "5000", "Sale"],
]
ORD_COLUMNS = ["OrderId", "Customer", "Status"]
ORDERS = [
    ["O1", "acme", "open"], ["O2", "zeta", "open"], ["O3", "acme", "done"],
    ["O4", "gamma", "open"], ["O5", "acme", "done"], ["O6", "zeta", "done"],
]
PLAN = Count(Eq("FirstName", "John"))


def _pair(seed, rows, names, numeric=None):
    return data.pair(jax, seed, rows, names, numeric=numeric,
                     alphabet=CODEC.alphabet, word_length=8)


@pytest.fixture(scope="module")
def pairs():
    return {"emp": _pair(7, EMPLOYEE, EMP_COLUMNS, numeric={3: 14}),
            "ord": _pair(8, ORDERS, ORD_COLUMNS)}


@pytest.fixture(scope="module")
def employee_db(pairs):
    return pairs["emp"][1]


@pytest.fixture(scope="module")
def orders_db(pairs):
    return pairs["ord"][1]


def _server(*args, **kw):
    return QueryServer(*args, device="cpu", **kw)


def emp_plans(m):
    return [m.Count(m.Eq("FirstName", "John")),
            m.Select(m.Eq("Department", "Sale"), strategy="tree"),
            m.RangeCount(m.Between("Salary", 600, 4000), reduce_every=2),
            m.Count(m.Eq("LastName", "Smith"))]


def ord_plans(m):
    return [m.Count(m.Eq("Customer", "acme")),
            m.Select(m.Eq("Status", "open"), strategy="one_round"),
            m.Count(m.Eq("Status", "done")),
            m.Select(m.Eq("Customer", "zeta"), strategy="tree"),
            m.Count(m.Eq("Customer", "gamma"))]


EMP_PLANS, ORD_PLANS = emp_plans(api), ord_plans(api)


# ---------------------------------------------------------------------------
# the port against the reference server
# ---------------------------------------------------------------------------

def test_port_server_matches_reference_server(pairs):
    """The same submissions, pumped synchronously, through both servers:
    equal results, failures, close reasons and batch fills."""
    def drive(srv, m, emp, ords):
        srv.attach("emp", emp, key=3, max_batch=3)
        srv.attach("ord", ords, key=4, max_batch=2)
        reqs = [srv.submit(p, relation="emp") for p in emp_plans(m)]
        reqs += [srv.submit(p, relation="ord") for p in ord_plans(m)]
        reqs.append(srv.submit(m.Select(m.Eq("FirstName", "John"),
                                        strategy="one_tuple"),
                               relation="emp"))
        srv.pump("full", relation="emp")
        srv.pump("deadline", relation="ord")
        while srv.pending():
            srv.pump()
        return reqs, srv.stats.snapshot()

    ref, jsnap = drive(jserve.QueryServer(), japi, pairs["emp"][0],
                       pairs["ord"][0])
    got, snap = drive(_server(), api, pairs["emp"][1], pairs["ord"][1])
    for r, g in zip(ref, got):
        assert r.relation == g.relation and r.done() and g.done()
        if r.error is not None:
            assert type(g.error).__name__ == type(r.error).__name__
            assert g.result is None
        else:
            assert g.error is None
            data.same(r.result, g.result)
    for key in ("served", "failed", "batches", "batch_fill", "closes",
                "served_by_family"):
        assert snap[key] == jsnap[key], key
    for name in ("emp", "ord"):
        for key in ("served", "failed", "batches", "closes", "batch_fill",
                    "queue_depth", "served_by_family"):
            assert snap["relations"][name][key] == \
                jsnap["relations"][name][key], (name, key)
    assert [plan_family(r.plan) for r in got] == \
        [jserve.plan_family(r.plan) for r in ref]


def test_plan_families_match_reference():
    port = [Count(Eq("A", "x")), Select(api.Like("A", "x%")),
            RangeCount(Between("B", 1, 2)), api.Aggregate("sum", "B"),
            api.EmbedLookup(tokens=(1,)), Count(api.Suffix("A", "x"))]
    ref = [japi.Count(japi.Eq("A", "x")), japi.Select(japi.Like("A", "x%")),
           japi.RangeCount(japi.Between("B", 1, 2)),
           japi.Aggregate("sum", "B"), japi.EmbedLookup(tokens=(1,)),
           japi.Count(japi.Suffix("A", "x"))]
    assert [plan_family(p) for p in port] == \
        [jserve.plan_family(p) for p in ref]


@pytest.mark.parametrize("order_shards", [1, 3])
def test_fused_wave_when_relations_close_together(employee_db, orders_db,
                                                  order_shards):
    """Two relations due in one scheduler scan run as ONE run_batch_multi
    wave: on the shared pool its steps fuse (fused steps on both planes),
    and results equal each relation served alone. A one-shard relation is
    serial, as in the reference, so nothing fuses with it."""
    solo_e = _server()
    solo_e.attach("employees", employee_db, shards=2, key=11)
    want_e = solo_e.serve([QueryRequest(p, relation="employees")
                           for p in EMP_PLANS])
    solo_o = _server()
    solo_o.attach("orders", orders_db, shards=order_shards, key=13)
    want_o = solo_o.serve([QueryRequest(p, relation="orders")
                           for p in ORD_PLANS])
    srv = _server(pool_workers=2)
    srv.attach("employees", employee_db, shards=2, key=11, weight=2.0)
    srv.attach("orders", orders_db, shards=order_shards, key=13)
    pooled = order_shards > 1
    assert isinstance(srv.dataplane_of("orders").dispatcher,
                      api.PoolHandle) == pooled
    got_e = [srv.submit(p, relation="employees") for p in EMP_PLANS]
    got_o = [srv.submit(p, relation="orders") for p in ORD_PLANS]
    srv._pump_due([("employees", "full"), ("orders", "deadline")])
    for w, g in zip(want_e + want_o, got_e + got_o):
        assert g.error is None
        data.same(w.result, g.result)
    for name in ("employees", "orders"):
        assert (srv.dataplane_of(name).stats.fused_steps > 0) == pooled
    assert srv.stats.closes == {"full": 1, "deadline": 1}
    assert srv.stats.fused_fallbacks == 0
    srv.close()


def test_failing_fused_wave_is_counted_and_rerun_alone(employee_db,
                                                       orders_db):
    """A fused wave that raises re-runs each relation's batch alone: the
    fallback is counted with the fault's repr, and only the requests that
    need the failing op carry ``error``."""
    srv = _server(backend=data.raising_backend(), pool_workers=2)
    srv.attach("employees", employee_db, shards=2, key=11)
    srv.attach("orders", orders_db, shards=2, key=13)
    bad = [srv.submit(Select(Eq("FirstName", "John"), strategy="one_round"),
                      relation="employees"),
           srv.submit(Select(Eq("Customer", "acme"), strategy="one_round"),
                      relation="orders")]
    good = [srv.submit(PLAN, relation="employees"),
            srv.submit(Count(Eq("Customer", "acme")), relation="orders")]
    srv._pump_due([("employees", "full"), ("orders", "deadline")])
    assert srv.stats.fused_fallbacks == 1
    assert "kernel launch failed" in srv.stats.last_fused_error
    assert srv.stats.snapshot()["fused_fallbacks"] == 1
    assert all(isinstance(r.error, RuntimeError) for r in bad)
    assert [r.result.count for r in good] == [2, 3]
    srv.close()


def test_pool_thread_failure_is_the_requests_error(employee_db):
    """An op that raises on a pool thread makes run_batch raise; the server
    re-runs per request, marks only the requests that need the op, and
    never switches to another backend."""
    be = data.raising_backend()
    client = api.QueryClient(device="cpu", backend=be)
    pool = ThreadedDispatcher(2)
    client.attach(employee_db, shards=2, dispatcher=pool.handle())
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        client.run_batch([Select(Eq("FirstName", "John"),
                                 strategy="one_round")])
    pool.close()
    srv = _server(backend=be, pool_workers=2, max_wait_ms=5)
    srv.attach("emp", employee_db, shards=2, key=1)
    with srv:
        bad = srv.submit(Select(Eq("FirstName", "John"),
                                strategy="one_round"), relation="emp")
        good = srv.submit(PLAN, relation="emp")
        for r in (bad, good):
            r.wait(timeout=30)
    assert isinstance(bad.error, RuntimeError) and bad.result is None
    assert good.error is None and good.result.count == 2
    assert srv.client.backend is be
    assert srv.stats.failed == 1 and srv.stats.served == 1


# ---------------------------------------------------------------------------
# the reference's model-free serving tests, on the port
# ---------------------------------------------------------------------------

def _solo_results(db, seed, plans, shards):
    server = _server(db, seed, shards=shards)
    reqs = server.serve([QueryRequest(p) for p in plans])
    server.close()
    assert all(r.error is None for r in reqs)
    return [r.result for r in reqs]


def test_deadline_closes_partial_batch(employee_db):
    """max_batch is far above the traffic: the batch must close by the
    oldest submission's deadline, not wait for fill."""
    with _server(employee_db, 11, max_batch=64,
                     max_wait_ms=25) as server:
        reqs = [server.submit(QueryRequest(Count(Eq("FirstName", "John"))))
                for _ in range(3)]
        for r in reqs:
            r.wait(timeout=30)
    assert [r.result.count for r in reqs] == [2, 2, 2]
    assert server.stats.closes.get("deadline", 0) >= 1
    assert server.stats.closes.get("full", 0) == 0
    assert all(r.queue_wait_s >= 0 for r in reqs)
    assert len(server.stats.queue_waits_s) == 3
    assert sum(server.stats.batch_fill.values()) == server.stats.batches


def test_full_batch_closes_before_deadline(employee_db):
    """With max_batch=2 and a long deadline, fill must close batches."""
    with _server(employee_db, 12, max_batch=2,
                     max_wait_ms=10_000) as server:
        reqs = [server.submit(QueryRequest(Count(Eq("FirstName", "Eve"))))
                for _ in range(4)]
        for r in reqs:
            r.wait(timeout=30)
    assert all(r.result.count == 1 for r in reqs)
    assert server.stats.closes.get("full", 0) >= 2
    assert server.stats.batch_fill.get(2, 0) >= 2


def test_async_results_match_sync_client(employee_db):
    """The scheduler thread serves the same answers a synchronous client
    derives for the same plans (keys assign in pop order, so compare
    values, not transcripts)."""
    plans = [Count(Eq("FirstName", "John")),
             Select(Eq("Department", "Sale"), strategy="tree"),
             Count(Eq("Department", "Design"))]
    with _server(employee_db, 13, max_batch=8,
                     max_wait_ms=15) as server:
        reqs = [server.submit(QueryRequest(p)) for p in plans]
        for r in reqs:
            r.wait(timeout=30)
    assert reqs[0].result.count == 2
    assert len(reqs[1].result.rows) == 3
    assert reqs[2].result.count == 1


def test_async_soak_concurrent_submitters_stats_monotone(employee_db):
    """Soak: several submitter threads race the scheduler; served counts
    only grow, every request finishes exactly once, failures stay
    isolated to the bad plans."""
    server = _server(employee_db, 17, max_batch=4, max_wait_ms=5,
                         shards=2)
    server.start()
    good_per_thread, n_threads = 6, 3
    all_reqs = []
    lock = threading.Lock()

    def submitter(tid):
        for i in range(good_per_thread):
            plan = (Select(Eq("FirstName", "John"), strategy="one_tuple")
                    if (tid == 0 and i == 2)     # ℓ=2 -> CardinalityError
                    else Count(Eq("FirstName", "John")))
            r = server.submit(QueryRequest(plan))
            with lock:
                all_reqs.append(r)
            time.sleep(0.003)

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(n_threads)]
    observed = []
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        observed.append(server.stats.served)
        time.sleep(0.002)
    for t in threads:
        t.join()
    for r in all_reqs:
        r.wait(timeout=60)
    server.stop()
    observed.append(server.stats.served)

    total = good_per_thread * n_threads
    assert len(all_reqs) == total
    assert server.stats.served == total - 1
    assert server.stats.failed == 1
    # fault isolation: exactly the poisoned request errored
    errored = [r for r in all_reqs if r.error is not None]
    assert len(errored) == 1
    assert isinstance(errored[0].error, CardinalityError)
    good = [r for r in all_reqs if r.error is None]
    assert all(r.result.count == 2 for r in good)
    # stats monotonicity under concurrency
    assert all(a <= b for a, b in zip(observed, observed[1:]))
    assert server.stats.batches == sum(server.stats.batch_fill.values())
    d = server.stats.as_dict()
    assert d["served"] == total - 1 and d["closes"]


def test_stop_drains_queue(employee_db):
    server = _server(employee_db, 19, max_batch=4,
                         max_wait_ms=10_000)
    # no scheduler running: stop() must still drain pending work
    reqs = [server.submit(QueryRequest(Count(Eq("FirstName", "Eve"))))
            for _ in range(3)]
    server.stop()
    assert all(r.done() and r.result.count == 1 for r in reqs)
    assert server.stats.closes.get("drain", 0) >= 1


def test_stop_with_scheduler_serves_parked_requests(employee_db):
    """Regression: requests parked in the queue when stop() is called must
    be SERVED (a final drain batch closes inside the scheduler thread),
    not silently dropped."""
    server = _server(employee_db, 29, max_batch=64,
                         max_wait_ms=60_000)      # deadline far away
    server.start()
    reqs = [server.submit(QueryRequest(Count(Eq("FirstName", "John"))))
            for _ in range(3)]
    server.stop()                                # parked: deadline not due
    assert all(r.done() and r.result.count == 2 for r in reqs)
    assert server.stats.closes.get("drain", 0) >= 1


def test_stop_without_drain_raises_server_stopped(employee_db):
    """Regression: stop(drain=False) used to leave parked requests undone
    forever — wait() must raise ServerStopped, never hang."""
    server = _server(employee_db, 31, max_batch=64,
                         max_wait_ms=60_000)
    server.start()
    reqs = [server.submit(QueryRequest(Count(Eq("FirstName", "Eve"))))
            for _ in range(2)]
    server.stop(drain=False)
    for r in reqs:
        assert r.done()
        assert isinstance(r.error, ServerStopped)
        with pytest.raises(ServerStopped):
            r.wait(timeout=1)
    assert server.stats.failed == 2
    # a racer submitting AFTER stop(drain=False) fails fast too — it must
    # never be parked on a queue nothing will pump...
    late = server.submit(QueryRequest(Count(Eq("FirstName", "Eve"))))
    assert late.done()
    with pytest.raises(ServerStopped):
        late.wait(timeout=1)
    # ...and start() lifts the rejection (the server stays restartable):
    # the new submission parks normally (deadline is 60 s out) and the
    # draining stop() serves it
    server.start()
    again = server.submit(QueryRequest(Count(Eq("FirstName", "Eve"))))
    assert again.error is None and not again.done()
    server.stop()
    assert again.wait(timeout=1).result.count == 1
    # sync mode too: no scheduler thread, queued work still fails loudly
    server2 = _server(employee_db, 32)
    r2 = server2.submit(QueryRequest(Count(Eq("FirstName", "Eve"))))
    server2.stop(drain=False)
    with pytest.raises(ServerStopped):
        r2.wait(timeout=1)


def test_stats_snapshot_consistent_under_concurrent_pumps(employee_db):
    """Regression: snapshot()/quantiles used to read the histograms with
    no lock — a reader racing the scheduler could see a torn deque
    (RuntimeError mid-sort). Hammer both sides."""
    server = _server(employee_db, 33, max_batch=2, max_wait_ms=2)
    server.start()
    stop_reading = threading.Event()
    errors = []

    def reader():
        while not stop_reading.is_set():
            try:
                snap = server.stats.snapshot()
                assert snap["served"] >= 0
                server.stats.queue_wait_quantile(0.5)
                server.stats.latency_quantile(0.95)
            except Exception as e:  # noqa: BLE001 — the regression signal
                errors.append(e)
                return

    t = threading.Thread(target=reader)
    t.start()
    reqs = [server.submit(QueryRequest(Count(Eq("FirstName", "John"))))
            for _ in range(30)]
    for r in reqs:
        r.wait(timeout=60)
    stop_reading.set()
    t.join()
    server.stop()
    assert errors == []
    snap = server.stats.snapshot()
    assert snap["served"] == 30
    assert sum(snap["batch_fill"].values()) == snap["batches"]


def test_empty_and_unknown_histograms_quantile_zero():
    """queue_wait_quantile on an empty deque (or an unknown relation) is
    0.0, never an exception."""
    stats = ServeStats()
    assert stats.queue_wait_quantile(0.5) == 0.0
    assert stats.latency_quantile(0.95) == 0.0
    assert stats.queue_wait_quantile(0.5, relation="nope") == 0.0
    assert stats.latency_quantile(0.5, relation="nope") == 0.0
    snap = stats.snapshot()
    assert snap["p50_queue_wait_s"] == 0.0 and snap["relations"] == {}


def test_start_is_idempotent_and_restartable(employee_db):
    server = _server(employee_db, 21, max_batch=2, max_wait_ms=5)
    server.start()
    server.start()                               # no second thread
    r = server.submit(QueryRequest(Count(Eq("FirstName", "Adam"))))
    r.wait(timeout=30)
    server.stop()
    assert r.result.count == 1
    # restart after stop
    server.start()
    r2 = server.submit(QueryRequest(Count(Eq("FirstName", "Eve"))))
    r2.wait(timeout=30)
    server.stop()
    assert r2.result.count == 1


def test_wait_timeout_raises(employee_db):
    server = _server(employee_db, 23)    # scheduler not started
    r = server.submit(QueryRequest(Count(Eq("FirstName", "Eve"))))
    with pytest.raises(TimeoutError):
        r.wait(timeout=0.01)
    server.pump()
    assert r.wait(timeout=1).result.count == 1


def test_server_adopts_presharded_plane(employee_db):
    """A ShardedRelation handed to the server keeps its partitioning, with
    or without an explicit dispatcher; close() releases the owned pool."""
    plane = ShardedRelation(employee_db, shards=3)
    srv = _server(plane, 5, max_wait_ms=5,
                      dispatcher=ThreadedDispatcher(max_workers=3))
    assert srv.dataplane.n_shards == 3
    with srv:
        r = srv.submit(QueryRequest(Count(Eq("FirstName", "John"))))
        r.wait(timeout=30)
    assert r.result.count == 2

    srv2 = _server(employee_db, 5, max_wait_ms=5, shards=2)
    assert srv2.dataplane.n_shards == 2
    with srv2:
        r2 = srv2.submit(QueryRequest(Count(Eq("FirstName", "Eve"))))
        r2.wait(timeout=30)
    assert r2.result.count == 1
    # __exit__ -> close(): the owned pool is released; a late pump still
    # works (serial fallback)
    assert srv2._owned_dispatcher is not None
    r3 = srv2.submit(QueryRequest(Count(Eq("FirstName", "John"))))
    srv2.pump()
    assert r3.result.count == 2


def test_sync_pump_surface_unchanged(employee_db):
    """No scheduler thread: submit/pump/serve behave exactly as before."""
    server = _server(employee_db, 2, max_batch=8)
    assert server.pump() == []
    server.submit(QueryRequest(Count(Eq("FirstName", "Eve"))))
    server.submit(QueryRequest(Count(Eq("FirstName", "John"))))
    assert server.pending() == 2
    out = server.pump()
    assert server.pending() == 0
    assert [r.result.count for r in out] == [1, 2]
    assert all(r.done() for r in out)


def test_mixed_workload_matches_solo_servers(employee_db, orders_db):
    """THE acceptance test: two relations, different shard counts, served
    interleaved by one scheduler == each served alone (rows, ledgers)."""
    solo_emp = _solo_results(employee_db, 11, EMP_PLANS, shards=2)
    solo_ord = _solo_results(orders_db, 13, ORD_PLANS, shards=3)

    server = _server(pool_workers=4)
    server.attach("employees", employee_db, shards=2, key=11)
    server.attach("orders", orders_db, shards=3, key=13)
    assert server.relations == ("employees", "orders")
    assert server.dataplane_of("employees").n_shards == 2
    assert server.dataplane_of("orders").n_shards == 3

    # interleave the two relations' traffic through one scheduler thread
    with server:
        emp_reqs = []
        ord_reqs = []
        for i in range(max(len(EMP_PLANS), len(ORD_PLANS))):
            if i < len(EMP_PLANS):
                emp_reqs.append(
                    server.submit(EMP_PLANS[i], relation="employees"))
            if i < len(ORD_PLANS):
                ord_reqs.append(
                    server.submit(ORD_PLANS[i], relation="orders"))
        for r in emp_reqs + ord_reqs:
            r.wait(timeout=60)

    for solo, req in zip(solo_emp, emp_reqs):
        data.same(solo, req.result)
    for solo, req in zip(solo_ord, ord_reqs):
        data.same(solo, req.result)

    # per-relation breakdown is exposed and adds up
    snap = server.stats.snapshot()
    emp, ords = snap["relations"]["employees"], snap["relations"]["orders"]
    assert emp["served"] == len(EMP_PLANS)
    assert ords["served"] == len(ORD_PLANS)
    assert server.stats.served == len(EMP_PLANS) + len(ORD_PLANS)
    assert emp["served_by_family"]["count"] == 2
    assert emp["served_by_family"]["range_count"] == 1
    assert ords["served_by_family"]["select"] == 2
    assert sum(emp["batch_fill"].values()) == emp["batches"]
    # one shared pool backs both dataplanes, via separate handles
    assert server._owned_dispatcher is not None
    ha = server.dataplane_of("employees").dispatcher
    hb = server.dataplane_of("orders").dispatcher
    assert ha is not hb
    assert ha._shared_pool is hb._shared_pool is server._owned_dispatcher


def test_tenant_results_independent_of_neighbour_traffic(employee_db,
                                                         orders_db):
    """A relation's transcript never depends on what (or whether) other
    tenants submit: per-relation key streams."""
    alone = _server()
    alone.attach("employees", employee_db, key=5)
    only = alone.serve([QueryRequest(p, relation="employees")
                        for p in EMP_PLANS])

    noisy = _server()
    noisy.attach("employees", employee_db, key=5)
    noisy.attach("orders", orders_db, key=6)
    mixed = []
    for i, p in enumerate(EMP_PLANS):
        mixed.append(noisy.submit(p, relation="employees"))
        noisy.submit(ORD_PLANS[i % len(ORD_PLANS)], relation="orders")
    while noisy.pending():
        noisy.pump()
    for a, b in zip(only, mixed):
        data.same(a.result, b.result)


def test_per_relation_batching_policy(employee_db, orders_db):
    """Per-relation max_batch/max_wait_ms overrides shape THAT relation's
    batches only; batches never mix relations."""
    server = _server(max_batch=16, max_wait_ms=10_000)
    server.attach("employees", employee_db, key=1, max_batch=2)
    server.attach("orders", orders_db, key=2, max_batch=4,
                  max_wait_ms=5.0)
    with server:
        emp = [server.submit(Count(Eq("FirstName", "John")),
                             relation="employees") for _ in range(4)]
        ords = [server.submit(Count(Eq("Customer", "acme")),
                              relation="orders") for _ in range(4)]
        for r in emp + ords:
            r.wait(timeout=60)
    snap = server.stats.snapshot()
    emp_s, ord_s = snap["relations"]["employees"], \
        snap["relations"]["orders"]
    # employees: max_batch=2 -> fills of exactly 2, closed by fill
    assert emp_s["batch_fill"].get(2, 0) >= 2
    assert emp_s["closes"].get("full", 0) >= 2
    assert max(emp_s["batch_fill"]) <= 2
    # orders: fills of <= 4, and every one of its requests served
    assert ord_s["served"] == 4
    assert max(ord_s["batch_fill"]) <= 4
    assert all(r.result.count == 2 for r in emp)
    assert all(r.result.count == 3 for r in ords)


def test_fault_isolation_across_relations(employee_db, orders_db):
    """A poisoned plan on one relation fails alone — batch-mates AND the
    other relation's concurrent batch are unaffected."""
    server = _server(max_wait_ms=15)
    server.attach("employees", employee_db, key=3)
    server.attach("orders", orders_db, key=4)
    with server:
        bad = server.submit(                    # ℓ=2 -> CardinalityError
            Select(Eq("FirstName", "John"), strategy="one_tuple"),
            relation="employees")
        good_emp = [server.submit(Count(Eq("FirstName", "John")),
                                  relation="employees") for _ in range(3)]
        good_ord = [server.submit(Count(Eq("Customer", "acme")),
                                  relation="orders") for _ in range(3)]
        for r in [bad] + good_emp + good_ord:
            r.wait(timeout=60)
    assert isinstance(bad.error, CardinalityError)
    assert all(r.error is None and r.result.count == 2 for r in good_emp)
    assert all(r.error is None and r.result.count == 3 for r in good_ord)
    snap = server.stats.snapshot()
    assert snap["relations"]["employees"]["failed"] == 1
    assert snap["relations"]["orders"]["failed"] == 0
    assert server.stats.failed == 1


def test_routing_validation_and_default_relation(employee_db, orders_db):
    server = _server(employee_db, 9)      # default tenant
    server.attach("orders", orders_db, key=10)
    # unknown relation: loud, listing what IS attached
    with pytest.raises(KeyError, match="unknown relation"):
        server.submit(Count(Eq("Customer", "acme")), relation="nope")
    # no relation: routed to the default tenant
    r_def = server.submit(Count(Eq("FirstName", "Eve")))
    r_ord = server.submit(Count(Eq("Customer", "zeta")),
                          relation="orders")
    while server.pending():
        server.pump()
    assert r_def.relation == "default" and r_def.result.count == 1
    assert r_ord.relation == "orders" and r_ord.result.count == 2
    # an empty server refuses submissions with a clear error
    empty = _server()
    with pytest.raises(ValueError, match="no relation attached"):
        empty.submit(Count(Eq("FirstName", "Eve")))
    # shards=/dispatcher= are per-relation: without a db they would be
    # silently dropped, so the constructor refuses them
    with pytest.raises(ValueError, match="per-relation"):
        _server(shards=4)


def test_concurrent_submitters_two_relations_stats_monotone(employee_db,
                                                            orders_db):
    """Soak across relations: racing submitters on both tenants; served
    counts stay monotone, every request finishes exactly once, and the
    per-relation slices add up to the aggregate."""
    server = _server(max_batch=4, max_wait_ms=5, pool_workers=4)
    server.attach("employees", employee_db, key=21, shards=2)
    server.attach("orders", orders_db, key=22, shards=3)
    server.start()
    per_thread, reqs, lock = 5, [], threading.Lock()

    def submitter(tid):
        for i in range(per_thread):
            if (tid + i) % 2 == 0:
                r = server.submit(Count(Eq("FirstName", "John")),
                                  relation="employees")
            else:
                r = server.submit(Count(Eq("Customer", "acme")),
                                  relation="orders")
            with lock:
                reqs.append(r)
            time.sleep(0.002)

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(4)]
    observed = []
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        snap = server.stats.snapshot()          # torn-read regression
        observed.append((snap["served"],
                         snap["relations"].get("employees",
                                               {}).get("served", 0)))
        time.sleep(0.002)
    for t in threads:
        t.join()
    for r in reqs:
        r.wait(timeout=60)
    server.close()

    assert len(reqs) == 4 * per_thread
    assert server.stats.served == len(reqs) and server.stats.failed == 0
    for r in reqs:
        want = 2 if r.relation == "employees" else 3
        assert r.result.count == want
    assert all(a[0] <= b[0] and a[1] <= b[1]
               for a, b in zip(observed, observed[1:]))
    snap = server.stats.snapshot()
    assert (snap["relations"]["employees"]["served"]
            + snap["relations"]["orders"]["served"]) == len(reqs)
    assert (snap["relations"]["employees"]["batches"]
            + snap["relations"]["orders"]["batches"]) == snap["batches"]


def test_full_closes_shrink_wait_monotonically(employee_db):
    """Every full close multiplies the effective wait by STEER_SHRINK;
    the snapshot trajectory is strictly decreasing."""
    srv = _server(employee_db, 21, max_batch=2, max_wait_ms=40)
    t = srv._tenant(None)
    base = t.wait_s
    for _ in range(4):
        srv.submit(PLAN)
        srv.submit(PLAN)
        srv.pump("full")
    assert t.base_wait_s == base
    assert t.wait_s == pytest.approx(base * STEER_SHRINK ** 4)
    rel = srv.stats.snapshot()["relations"][api.DEFAULT_RELATION]
    traj = rel["wait_trajectory_ms"]
    assert len(traj) == 4
    assert all(b < a for a, b in zip(traj, traj[1:]))
    assert rel["steered_wait_ms"] == pytest.approx(traj[-1])


def test_deadline_underfilled_grows_back_to_cap(employee_db):
    """Deadline closes below max_batch grow the wait by STEER_GROW, but
    never past the configured cap."""
    srv = _server(employee_db, 22, max_batch=4, max_wait_ms=30)
    t = srv._tenant(None)
    base = t.wait_s
    for _ in range(6):           # dive first
        srv.submit(PLAN)
        srv.submit(PLAN)
        srv.submit(PLAN)
        srv.submit(PLAN)
        srv.pump("full")
    dived = t.wait_s
    assert dived < base
    for _ in range(40):          # recover: underfilled deadline closes
        srv.submit(PLAN)
        srv.pump("deadline")
    assert t.wait_s == base      # capped exactly at the configured wait
    rel = srv.stats.snapshot()["relations"][api.DEFAULT_RELATION]
    assert rel["steered_wait_ms"] == pytest.approx(base * 1e3)


def test_steering_floor_and_inert_reasons(employee_db):
    """The steered wait never drops below MIN_STEER_WAIT_S, and
    manual/drain pumps do not steer."""
    srv = _server(employee_db, 23, max_batch=1, max_wait_ms=10)
    t = srv._tenant(None)
    for _ in range(80):
        srv.submit(PLAN)
        srv.pump("full")
    assert t.wait_s == pytest.approx(MIN_STEER_WAIT_S)
    w = t.wait_s
    srv.submit(PLAN)
    srv.pump()                   # "manual"
    srv.submit(PLAN)
    srv.pump("drain")
    assert t.wait_s == w
    # a full deadline close (fill == max_batch) does not grow either
    srv.submit(PLAN)
    srv.pump("deadline")
    assert t.wait_s == w


def test_zero_wait_relation_never_steers(employee_db):
    """max_wait_ms=0 pins the wait at zero — there is no cap to steer
    inside, and the grow rule must not resurrect a nonzero deadline."""
    srv = _server(employee_db, 24, max_batch=2, max_wait_ms=0)
    t = srv._tenant(None)
    for reason in ("full", "deadline", "full"):
        srv.submit(PLAN)
        srv.submit(PLAN)
        srv.pump(reason)
    assert t.wait_s == 0.0


def test_queue_depth_gauge(employee_db):
    """queue_depth reports what was still parked right after the close."""
    srv = _server(employee_db, 25, max_batch=2, max_wait_ms=1000)
    for _ in range(5):
        srv.submit(PLAN)
    srv.pump()
    rel = srv.stats.snapshot()["relations"][api.DEFAULT_RELATION]
    assert rel["queue_depth"] == 3
    while srv.pending():
        srv.pump()
    rel = srv.stats.snapshot()["relations"][api.DEFAULT_RELATION]
    assert rel["queue_depth"] == 0


def test_attach_weight_plumbs_to_pool_handle(employee_db):
    srv = _server(pool_workers=2)
    srv.attach("emp", employee_db, shards=2, key=1, weight=2.5)
    plane = srv.dataplane_of("emp")
    assert plane.dispatcher.weight == 2.5
    assert plane.dispatcher._shared_pool is srv._owned_dispatcher
    with pytest.raises(ValueError):
        srv.attach("bad", employee_db, shards=2, key=2, weight=0.0)
    srv.close()


class _TickClock:
    """The scheduler module's ``time`` with a clock that advances a fixed
    ``tick`` per ``time()`` read and nothing else (the rest is the real
    module). A sub-millisecond deadline then passes after a set number of
    reads, not after however long a loaded machine took between them."""

    def __init__(self, tick: float):
        self._lock = threading.Lock()
        self._now = time.time()
        self._tick = tick

    def time(self) -> float:
        with self._lock:
            self._now += self._tick
            return self._now

    def __getattr__(self, name):
        return getattr(time, name)


def test_scheduler_park_is_floored(employee_db, monkeypatch):
    """Sub-millisecond deadlines must park the scheduler at least
    MIN_PARK_S per wait — never a ~0s spin-wait.

    The scheduler's clock advances 0.1 ms a read, so a 0.5 ms deadline is
    always still ahead when the scheduler first scans a fresh submission
    and the park is taken on any machine load (on the real clock a
    loaded machine could find every deadline already past)."""
    from repro_torch.launch import serve as serve_mod
    monkeypatch.setattr(serve_mod, "time", _TickClock(1e-4))
    srv = _server(employee_db, 26, max_batch=64, max_wait_ms=0.5)
    recorded = []
    real_wait = srv._cond.wait

    def spy(timeout=None):
        if timeout is not None:
            recorded.append(timeout)
        return real_wait(timeout)

    srv._cond.wait = spy
    with srv:
        reqs = []
        for _ in range(40):
            reqs.append(srv.submit(QueryRequest(PLAN)))
            time.sleep(0.002)
        for r in reqs:
            r.wait(timeout=30)
    assert recorded, "scheduler never took a timed park"
    assert min(recorded) >= MIN_PARK_S - 1e-9
    assert all(r.result.count == 2 for r in reqs)


def test_first_deadline_close_uses_configured_wait(employee_db):
    """Steering only reacts to history: a fresh relation's first deadline
    close parks the full configured max_wait_ms."""
    with _server(employee_db, 27, max_batch=64,
                     max_wait_ms=60) as srv:
        t0 = time.time()
        r = srv.submit(QueryRequest(PLAN))
        r.wait(timeout=30)
        waited = time.time() - t0
    assert waited >= 0.055
    rel = srv.stats.snapshot()["relations"][api.DEFAULT_RELATION]
    assert rel["wait_trajectory_ms"][-1] == pytest.approx(60.0)


def test_stats_consistent_under_attach_churn(employee_db):
    """snapshot()/quantile reads race live attach() calls and a pumping
    scheduler without torn state; a relation attached mid-soak serves and
    exposes its own quantiles."""
    srv = _server(employee_db, 28, max_batch=4, max_wait_ms=2)
    errors = []
    stop = threading.Event()

    def churn():
        try:
            for i in range(12):
                srv.attach(f"r{i}", employee_db, key=100 + i,
                           max_batch=2, max_wait_ms=3)
                time.sleep(0.005)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def read():
        try:
            while not stop.is_set():
                snap = srv.stats.snapshot()
                assert snap["served"] >= 0
                for rel in snap["relations"].values():
                    assert rel["queue_depth"] >= 0
                    assert isinstance(rel["wait_trajectory_ms"], list)
                srv.stats.latency_quantile(0.95)
                srv.stats.queue_wait_quantile(0.5, relation="r3")
                srv.pending()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    with srv:
        threads = [threading.Thread(target=churn),
                   threading.Thread(target=read)]
        for th in threads:
            th.start()
        reqs = [srv.submit(QueryRequest(PLAN)) for _ in range(30)]
        threads[0].join()
        # mid-soak attach serves its own traffic with its own quantiles
        late = [srv.submit(QueryRequest(PLAN), relation="r11")
                for _ in range(4)]
        for r in reqs + late:
            r.wait(timeout=30)
        stop.set()
        threads[1].join()
    assert not errors, errors
    assert srv.stats.queue_wait_quantile(0.95, relation="r11") >= 0.0
    assert srv.stats.snapshot()["relations"]["r11"]["served"] == 4
    assert all(r.result.count == 2 for r in late)
