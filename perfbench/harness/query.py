"""Query serving: a closed loop of client threads against the program's
``QueryServer``, and the check of every answer against the reference.

Set-up outsources the configuration's relation from the seed onto the
device (``repro_torch.core.outsource``), attaches it to a started
``QueryServer`` at the configuration's shards and batching, and serves
every kind of query the mix sends once. In the window each client sends
its next query when its last one has returned, timed from
``QueryServer.submit`` to the opened result on its own clock, and stops
sending when the window closes; a query in flight then is waited for (up
to ``GRACE_S``) and counts in the tail. Once every client has returned,
each answer is held to the configuration's plain reference.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import threading
import time
import traceback
from types import SimpleNamespace
from typing import List, Optional

import numpy as np

from . import traffic as tr
from .trace import Tracer

RELATION = "employees"
GRACE_S = 60.0
SHOWN = 5                        # queries not correct shown on stderr


@dataclasses.dataclass
class Record:
    """One query of the window, as its client saw it."""
    query: tr.Query
    t_sub: float                 # client clock (perf_counter)
    t_done: float
    latency_s: float
    answer: object = None        # the reference module's Answer, or None
    error: Optional[str] = None
    rounds: int = 0
    bits: int = 0
    close_at: float = 0.0        # the program's clock at its batch's close
    ok: bool = False
    in_window: bool = False      # returned before the window closed


def to_plan(q: tr.Query):
    """The program's plan for a query."""
    from repro_torch import api
    if q.plan == "aggregate":
        return api.Aggregate(q.op, q.column, reduce_every=q.reduce_every)
    if q.plan in ("range_count", "range_select"):
        where = api.Between(q.column, q.lo, q.hi)
        cls = api.RangeCount if q.plan == "range_count" else api.RangeSelect
        return cls(where, reduce_every=q.reduce_every)
    where = api.Eq(q.column, q.value)
    if q.plan == "count":
        return api.Count(where)
    return api.Select(where, strategy=q.strategy)


def outsource(ref, sizes: dict, rows: np.ndarray, seed: int, device):
    from repro_torch.core import Codec, outsource as program_outsource
    codec = Codec(word_length=sizes["word_length"])
    if codec.alphabet_size != sizes["alphabet"]:
        raise ValueError(f"the program's alphabet has {codec.alphabet_size}"
                         f" letters, the configuration {sizes['alphabet']}")
    numeric = {ref.NAMES.index(c): b for c, b in sizes["numeric"].items()}
    return program_outsource(rows.tolist(), n_shares=sizes["clouds"],
                             column_names=ref.NAMES, codec=codec,
                             degree=sizes["degree"], seed=seed,
                             numeric_columns=numeric, device=device)


def p95(values: List[float]) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def run(cell, seed: int, seconds: float, trace: bool, device,
        smoke: bool, clock, control: bool = False):
    """One run; with ``control``, the configuration's control reference
    also answers the window's queries in the program's place, held to
    the reference as the program's answers are."""
    import torch
    from repro_torch.launch import QueryServer

    ref = cell.reference
    sizes = cell.sizes(smoke)
    mix_spec = cell.mix(smoke)
    serving = sizes["serving"]
    rows = ref.make_rows(sizes, seed)
    data = ref.Data(rows, sizes["numeric"])
    db = outsource(ref, sizes, rows, seed, device)
    srv = QueryServer(max_batch=serving["max_batch"],
                      max_wait_ms=serving["max_wait_ms"],
                      pool_workers=serving["pool_workers"], seed=seed,
                      device=device)
    srv.attach(RELATION, db, shards=serving["shards"])
    mix = tr.QueryMix(mix_spec, data, seed)
    srv.start()
    try:
        warm = [srv.submit(to_plan(q), relation=RELATION) for q in
                tr.warmup_queries(mix, mix_spec["warmup_per_entry"])]
        for r in warm:                   # judged in the window, not here
            try:
                r.wait(timeout=GRACE_S)
            except TimeoutError:
                pass
        clients = mix_spec["clients"]
        # the loop itself, on streams of its own, until the allocator and
        # the scheduler are steady
        _window(srv, lambda i: mix.stream(clients + i), clients,
                mix_spec["warmup_s"], False, clock)
        if device != "cpu":
            torch.cuda.synchronize()
        window = _window(srv, mix.stream, clients, seconds, trace, clock)
        snap = srv.stats.snapshot()
        queue_wait = srv.stats.queue_wait_quantile(0.95)
        dispatched = srv.dataplane_of(RELATION).stats.dispatches \
            - window.dispatches0
    finally:
        srv.close()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    del srv, db
    if device != "cpu":
        torch.cuda.empty_cache()

    t_check = clock()
    recs = window.records
    reference = ref.Reference(data, sizes["word_length"])
    wrong = missing = 0
    for r in recs:
        if r.answer is None:
            missing += 1
        else:
            r.ok = ref.agrees(r.query, r.answer, reference.answer(r.query))
            wrong += not r.ok
        if not r.ok and missing + wrong <= SHOWN:
            print(f"not correct: {r.query} after {r.latency_s:.3f} s: "
                  f"{r.error or 'a wrong answer'}", file=sys.stderr)
    if control:
        broken = ref.control_reference(data, sizes["word_length"])
        broken_wrong = sum(not ref.agrees(r.query, broken.answer(r.query),
                                          reference.answer(r.query))
                           for r in recs)
    print(f"the check took {clock() - t_check:.2f} s", file=sys.stderr)
    for r in recs:
        r.in_window = r.t_done <= window.t_end
    done_in_window = sum(1 for r in recs if r.ok and r.in_window)
    served = snap["served"] + snap["failed"]
    record = SimpleNamespace(
        kind="query", config=sizes, traffic=mix_spec, records=recs,
        window_s=seconds, trace=window.trace, dispatches=dispatched,
        serve=dict(queue_wait_p95_s=queue_wait, served=served,
                   mean_batch_size=snap["mean_batch_size"],
                   batches=snap["batches"]))
    out = dict(
        attempted=len(recs), failed=wrong + missing,
        first_request=window.t_start, memory_peak_bytes=peak,
        end_to_end={"queries_per_s": done_in_window / seconds,
                    "query_p95_ms": p95([r.latency_s for r in recs]) * 1e3
                    if recs else float("nan")},
        compared={"wrong_answers": wrong, "missing_answers": missing},
        record=record)
    if control:
        out["control"] = {"wrong_answers": broken_wrong,
                          "missing_answers": 0}
    return out


def _window(srv, stream_of, clients: int, seconds: float, trace: bool,
            clock):
    """The closed loop: ``clients`` threads, client i sending the queries
    of ``stream_of(i)``."""
    out = SimpleNamespace(records=[], t_start=0.0, t_end=0.0, trace=None,
                          dispatches0=0)
    per_client: List[List[Record]] = [[] for _ in range(clients)]
    go = threading.Barrier(clients + 1)
    errors: List[BaseException] = []

    def client(i: int) -> None:
        stream = stream_of(i)
        try:
            go.wait()
            while True:
                q = next(stream)
                plan = to_plan(q)
                t_sub = clock()
                if t_sub >= out.t_end:
                    return
                req = srv.submit(plan, relation=RELATION)
                rec = Record(q, t_sub, 0.0, 0.0)
                try:
                    req.wait(timeout=max(0.0, out.t_end + GRACE_S - t_sub))
                except TimeoutError:
                    rec.error = "no answer within the grace after the window"
                rec.t_done = clock()
                rec.latency_s = rec.t_done - t_sub
                if rec.error is None and req.error is not None:
                    rec.error = "".join(traceback.format_exception(
                        req.error))
                if rec.error is None:
                    res = req.result
                    rec.answer = opened(res)
                    rec.rounds = res.ledger.rounds
                    rec.bits = res.ledger.communication_bits
                    rec.close_at = req.enqueued_at + req.queue_wait_s
                per_client[i].append(rec)
                if rec.t_done >= out.t_end + GRACE_S:
                    return
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,), daemon=True,
                                name=f"bench-client-{i}")
               for i in range(clients)]
    for th in threads:
        th.start()
    plane = srv.dataplane_of(RELATION)
    with Tracer(trace) as tracer:
        srv.reset()
        out.dispatches0 = plane.stats.dispatches
        with tracer.span():
            out.t_start = clock()
            out.t_end = out.t_start + seconds
            go.wait()
            time.sleep(max(0.0, out.t_end - clock()))
        for th in threads:
            th.join(timeout=seconds + GRACE_S + 30)
    if errors or any(th.is_alive() for th in threads):
        raise RuntimeError(f"client threads failed: {errors[:3]}")
    out.trace = tracer.summary
    out.records = [r for recs in per_client for r in recs]
    return out


def opened(res) -> SimpleNamespace:
    """The program's opened result, as the fields the reference compares."""
    return SimpleNamespace(count=res.count, addresses=res.addresses,
                           rows=res.rows, value=res.value)
