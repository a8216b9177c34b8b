"""Serving drivers: batched LM inference and oblivious query serving.

``BatchServer`` — prefill + greedy decode of a batch of equal-length
prompts through ``models.lm``: one prefill, then one ``decode_step`` a
token against the in-place cache, all eager. The sampled tokens stay on
the device until the batch ends and come to the host in one copy. With
``cfg.private_embed`` every step's embeddings are the paper's oblivious
selection (``models.private_embed.private_lookup_inline``).

``QueryServer`` serves logical query plans (``repro_torch.api.plans``) over
any number of attached secret-shared relations (the paper's owner
outsources a *database* — plural relations — once; users then query any of
them). ``attach(name, relation, shards=S)`` registers a relation with its
own dataplane, batching policy and query-key stream; ``submit(plan,
relation=...)`` (thread-safe; each request carries a ``wait()``-able
completion event) enqueues into that relation's FIFO batch group. ONE
background scheduler thread (``start``/``stop``) closes each relation's
group independently — by *fill* when its queue reaches ``max_batch``, by
*deadline* when its oldest request's *steered* wait expires — and runs the
group through ``QueryClient.run_batch(plans, relation=...)``, which
executes every protocol round once for the whole group. With ``shards=S`` a
relation's cloud steps fan out S tuple-axis shard dispatches, and all
relations share ONE server-owned thread pool through detachable, weighted
handles, so the global fan-out stays bounded (results stay bit-identical:
mod-p reduction is exact and batches never mix relations).

Three overload behaviours tune themselves:

  * **adaptive deadline steering** — a batch that closes *full* shrinks the
    relation's wait (``STEER_SHRINK``), a batch that closes by *deadline*
    underfilled grows it back (``STEER_GROW``) up to ``max_wait_ms``;
  * **weighted fair pool quotas** — ``attach(..., weight=w)`` sets the
    relation's deficit-round-robin share of the pool
    (``core.dataplane.PoolHandle``);
  * **cross-relation fused closes** — relations whose batches close in the
    same scheduler scan run as ONE ``QueryClient.run_batch_multi`` wave:
    their fetch ``ss_matmul`` dispatches co-schedule on the shared pool
    (keys, rounds and ledgers stay per relation).

``ServeStats`` keeps latency (enqueue -> result), queue-wait and batch-fill
histograms, close reasons, batch and throughput counters and a per-family
breakdown, in aggregate and per relation; ``snapshot()`` reads them
consistently under the stats lock. The synchronous ``pump``/``serve``
surface and the scheduler thread share one code path.

On a GPU, a request is done when its results are on the host (every query
opens its answer there), so latency and ``busy_s`` include device time.
A kernel that raises on a pool thread surfaces as the request's ``error``
after the per-request re-run; the server never switches backend.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import _device
from ..api import (DEFAULT_RELATION, MapReduceExecutor, Plan, QueryClient,
                   QueryResult)
from ..api.plans import PATTERN_PREDICATES
from ..core.dataplane import (Dispatcher, ShardedRelation,
                              ThreadedDispatcher)
from ..core.engine import SecretSharedDB
from ..models import lm
from ..models.config import ModelConfig


@dataclasses.dataclass
class Request:
    prompt: np.ndarray             # (T,) int32
    max_new: int = 16
    out: Optional[np.ndarray] = None
    latency_s: float = 0.0


class BatchServer:
    """Serves equal-length-prompt batches (the common benchmark setting).

    ``params`` must lie on ``device`` (default CUDA; ``device="cpu"`` for
    the CPU). ``max_len`` is the cache capacity: a batch needs
    prompt length + max_new − 1 positions, and a longer one raises. A
    batch is its prompts' tokens only, as the reference's: a ViT model
    serves text without its prefix, and an encoder-decoder raises
    ``KeyError`` for the frames it lacks."""

    def __init__(self, params, cfg: ModelConfig, *, max_len: int = 256,
                 device=None):
        self.device = _device.resolve(device)
        held = params["final_norm"].device
        if held.type != self.device.type:
            raise ValueError(f"params live on {held}, the server was asked "
                             f"for {self.device}")
        self.params = params
        self.cfg = cfg
        self.max_len = max_len

    @torch.no_grad()
    def serve(self, requests: List[Request]) -> List[Request]:
        t0 = time.time()
        prompts = np.stack([r.prompt for r in requests])   # (B, T)
        b, t = prompts.shape
        max_new = max(r.max_new for r in requests)
        if t + max_new - 1 > self.max_len:
            raise ValueError(f"{t} prompt tokens + {max_new} new need "
                             f"{t + max_new - 1} cache positions, max_len "
                             f"is {self.max_len}")
        dev = self.params["final_norm"].device
        logits, cache = lm.prefill(
            self.params, self.cfg,
            {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                       device=dev)},
            max_len=self.max_len)
        gen = torch.empty((b, max_new), dtype=torch.int64, device=dev)
        toks = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        gen[:, :1] = toks
        for i in range(max_new - 1):
            logits, cache = lm.decode_step(self.params, self.cfg, cache,
                                           t + i, {"tokens": toks})
            toks = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            gen[:, i + 1:i + 2] = toks
        out = gen.cpu().numpy().astype(np.int32)        # the one copy back
        dt = time.time() - t0
        for i, r in enumerate(requests):
            r.out = out[i, :r.max_new]
            r.latency_s = dt
        return requests


# ---------------------------------------------------------------------------
# oblivious query serving (the paper's workload behind the same queue idiom)
# ---------------------------------------------------------------------------

class ServerStopped(RuntimeError):
    """The server was stopped before this request could be served.

    Raised by :meth:`QueryRequest.wait` when ``QueryServer.stop`` dropped
    the still-queued request (``drain=False``) — a dropped submission must
    fail loudly, never hang its waiter.
    """


@dataclasses.dataclass
class QueryRequest:
    plan: Plan
    relation: Optional[str] = None   # registry name; filled in by submit()
    result: Optional[QueryResult] = None
    error: Optional[Exception] = None
    latency_s: float = 0.0           # enqueue -> result available
    enqueued_at: float = 0.0
    queue_wait_s: float = 0.0        # enqueue -> batch close
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> "QueryRequest":
        """Block until the scheduler finished this request (async mode).

        A request the server dropped on shutdown raises
        :class:`ServerStopped`; protocol-level failures (bad cardinality
        hint, invalid padding, …) stay on :attr:`error` for the caller to
        inspect, exactly as before.
        """
        if not self._done.wait(timeout):
            raise TimeoutError(f"request not served within {timeout}s")
        if isinstance(self.error, ServerStopped):
            raise self.error
        return self


#: latency samples kept for quantile estimates (a sliding window, so a
#: long-running server stays O(1) memory; counters remain exact).
LATENCY_WINDOW = 4096

#: adaptive deadline steering: multiplicative shrink on a *full* close
#: (traffic hot — stop waiting for stragglers), gentler grow on a
#: *deadline underfilled* close (traffic cooled — park longer, refill),
#: AIMD-style so a hot tenant's deadline converges down fast and recovers
#: smoothly. The steered wait never exceeds the configured ``max_wait_ms``
#: (the cap) and never drops below ``MIN_STEER_WAIT_S``.
STEER_SHRINK = 0.7
STEER_GROW = 1.3
MIN_STEER_WAIT_S = 1e-4

#: steered-wait samples kept per relation (the snapshot trajectory).
TRAJECTORY_WINDOW = 64

#: floor on the scheduler's timed condition-variable park. Without it a
#: sub-millisecond (or steered-to-tiny) deadline turns the scheduler loop
#: into a busy-spin: wait(~0) returns immediately, the scan re-runs, the
#: deadline is still a hair away, repeat at MHz. Flooring trades ≤ 1 ms of
#: deadline overshoot for a quiescent loop.
MIN_PARK_S = 1e-3


def plan_family(plan: Plan) -> str:
    """Telemetry bucket for a logical plan (count/select/range_*/join/
    aggregate/embed; Count/Select under a LIKE/prefix/suffix/substring
    predicate bucket as pattern_count/pattern_select — the pattern engine
    shares the families' fused rounds, but an operator watching
    served_by_family wants to see the matcher mix)."""
    name = type(plan).__name__
    base = {"Count": "count", "Select": "select",
            "RangeCount": "range_count", "RangeSelect": "range_select",
            "Join": "join", "Aggregate": "aggregate",
            "EmbedLookup": "embed"}.get(name, name.lower())
    if base in ("count", "select") and isinstance(
            getattr(plan, "where", None), PATTERN_PREDICATES):
        return f"pattern_{base}"
    return base


def _quantile(xs, q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


def _window() -> "Deque[float]":
    return collections.deque(maxlen=LATENCY_WINDOW)


@dataclasses.dataclass
class RelationStats:
    """One relation's slice of the serving telemetry.

    ``dispatches`` / ``dispatch_s`` / ``transfer_bytes`` mirror the
    relation dataplane's :class:`~repro_torch.core.dataplane.DispatchStats`
    deltas, accumulated per served batch — so the measured cloud-step
    wall-time and staged bytes (zero after placement for a device-resident
    dispatcher) are visible to monitoring code, not only dispatch counts.

    ``queue_depth`` and ``steered_wait_ms`` are *gauges* (last observed
    value, refreshed each served batch, not accumulated):
    ``queue_depth`` is how many requests were still parked right after the
    batch closed, ``steered_wait_ms`` the relation's adaptively-steered
    effective deadline; ``wait_trajectory_ms`` keeps the recent steering
    history so a monitor can see the deadline dive under load and recover.
    """
    served: int = 0
    failed: int = 0
    batches: int = 0
    busy_s: float = 0.0
    dispatches: int = 0
    dispatch_s: float = 0.0
    transfer_bytes: int = 0
    queue_depth: int = 0
    steered_wait_ms: float = 0.0
    wait_trajectory_ms: "Deque[float]" = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=TRAJECTORY_WINDOW))
    latencies_s: "Deque[float]" = dataclasses.field(default_factory=_window)
    queue_waits_s: "Deque[float]" = dataclasses.field(
        default_factory=_window)
    batch_fill: Dict[int, int] = dataclasses.field(default_factory=dict)
    closes: Dict[str, int] = dataclasses.field(default_factory=dict)
    served_by_family: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    def as_dict(self) -> dict:
        return dict(served=self.served, failed=self.failed,
                    batches=self.batches, busy_s=self.busy_s,
                    dispatches=self.dispatches,
                    dispatch_s=self.dispatch_s,
                    transfer_bytes=self.transfer_bytes,
                    queue_depth=self.queue_depth,
                    steered_wait_ms=self.steered_wait_ms,
                    wait_trajectory_ms=list(self.wait_trajectory_ms),
                    p50_latency_s=_quantile(list(self.latencies_s), 0.50),
                    p95_latency_s=_quantile(list(self.latencies_s), 0.95),
                    p50_queue_wait_s=_quantile(list(self.queue_waits_s),
                                               0.50),
                    p95_queue_wait_s=_quantile(list(self.queue_waits_s),
                                               0.95),
                    batch_fill=dict(self.batch_fill),
                    closes=dict(self.closes),
                    served_by_family=dict(self.served_by_family))


@dataclasses.dataclass
class ServeStats:
    """Aggregate scheduling telemetry (reset with ``QueryServer.reset``).

    Top-level counters/histograms aggregate over every relation (the
    pre-multi-tenant surface, unchanged); :attr:`relations` carries the
    per-relation breakdown — served_by_family, queue-wait and batch-fill
    histograms keyed by registry name.

    Writers and readers run on different threads (scheduler vs monitoring
    code), so every mutation goes through the ``note_*``/``record_batch``
    helpers and every read that touches a histogram goes through
    :meth:`snapshot`/the quantile helpers — all serialized on one internal
    lock. Bare field reads of the integer counters stay safe (atomic
    loads) and monotone.
    """
    served: int = 0
    failed: int = 0
    batches: int = 0
    busy_s: float = 0.0              # wall time spent inside run_batch
    dispatches: int = 0              # shard dispatches (dataplane deltas)
    dispatch_s: float = 0.0          # cloud-step wall-time (dataplane)
    transfer_bytes: int = 0          # staged bytes (dataplane)
    fused_fallbacks: int = 0         # fused waves re-run as solo batches
    last_fused_error: Optional[str] = None  # repr of the latest such fault
    latencies_s: "Deque[float]" = dataclasses.field(default_factory=_window)
    queue_waits_s: "Deque[float]" = dataclasses.field(
        default_factory=_window)
    batch_fill: Dict[int, int] = dataclasses.field(
        default_factory=dict)       # batch size -> how many batches
    closes: Dict[str, int] = dataclasses.field(
        default_factory=dict)       # why batches closed: full/deadline/...
    served_by_family: Dict[str, int] = dataclasses.field(
        default_factory=dict)       # which protocol groups the traffic hits
    relations: Dict[str, RelationStats] = dataclasses.field(
        default_factory=dict)       # per-relation breakdown
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    @property
    def mean_batch_size(self) -> float:
        return self.served / self.batches if self.batches else 0.0

    @property
    def throughput_qps(self) -> float:
        return self.served / self.busy_s if self.busy_s > 0 else 0.0

    def _rel_locked(self, relation: Optional[str]) -> RelationStats:
        rs = self.relations.get(relation or "")
        if rs is None:
            rs = self.relations[relation or ""] = RelationStats()
        return rs

    # -- locked writers (called from the pump, any thread) ------------------
    def note_queue_wait(self, wait_s: float,
                        relation: Optional[str] = None) -> None:
        with self._lock:
            self.queue_waits_s.append(wait_s)
            if relation is not None:
                self._rel_locked(relation).queue_waits_s.append(wait_s)

    def note_result(self, latency_s: float, family: Optional[str],
                    relation: Optional[str] = None) -> None:
        """One finished request: ``family`` is its plan family, or None
        for a failure."""
        with self._lock:
            rs = (self._rel_locked(relation) if relation is not None
                  else None)
            self.latencies_s.append(latency_s)
            if rs is not None:
                rs.latencies_s.append(latency_s)
            if family is None:
                self.failed += 1
                if rs is not None:
                    rs.failed += 1
                return
            self.served += 1
            self.served_by_family[family] = \
                self.served_by_family.get(family, 0) + 1
            if rs is not None:
                rs.served += 1
                rs.served_by_family[family] = \
                    rs.served_by_family.get(family, 0) + 1

    def note_fused_fallback(self, error: BaseException) -> None:
        """A fused multi-relation wave raised; its batches re-run alone."""
        with self._lock:
            self.fused_fallbacks += 1
            self.last_fused_error = repr(error)

    def note_dropped(self, relation: Optional[str] = None) -> None:
        """A request dropped unserved on shutdown (counts as failed)."""
        with self._lock:
            self.failed += 1
            if relation is not None:
                self._rel_locked(relation).failed += 1

    def record_batch(self, fill: int, reason: str,
                     relation: Optional[str] = None,
                     busy_s: float = 0.0, dispatches: int = 0,
                     dispatch_s: float = 0.0,
                     transfer_bytes: int = 0,
                     queue_depth: Optional[int] = None,
                     steered_wait_ms: Optional[float] = None) -> None:
        """One closed batch. ``queue_depth``/``steered_wait_ms`` refresh
        the relation's gauges (and the steering trajectory) when given."""
        with self._lock:
            for st in ([self] if relation is None
                       else [self, self._rel_locked(relation)]):
                st.batches += 1
                st.busy_s += busy_s
                st.batch_fill[fill] = st.batch_fill.get(fill, 0) + 1
                st.closes[reason] = st.closes.get(reason, 0) + 1
                st.dispatches += dispatches
                st.dispatch_s += dispatch_s
                st.transfer_bytes += transfer_bytes
            if relation is not None:
                rs = self._rel_locked(relation)
                if queue_depth is not None:
                    rs.queue_depth = queue_depth
                if steered_wait_ms is not None:
                    rs.steered_wait_ms = steered_wait_ms
                    rs.wait_trajectory_ms.append(steered_wait_ms)

    # -- locked readers -----------------------------------------------------
    def latency_quantile(self, q: float,
                         relation: Optional[str] = None) -> float:
        with self._lock:
            xs = list(self.latencies_s if relation is None else
                      self.relations.get(relation, _EMPTY_REL).latencies_s)
        _yield_to_writers()
        return _quantile(xs, q)

    def queue_wait_quantile(self, q: float,
                            relation: Optional[str] = None) -> float:
        """Queue-wait quantile; an empty (or unknown-relation) histogram
        is 0.0, never an error."""
        with self._lock:
            xs = list(self.queue_waits_s if relation is None else
                      self.relations.get(relation, _EMPTY_REL).queue_waits_s)
        _yield_to_writers()
        return _quantile(xs, q)

    def snapshot(self) -> dict:
        """A consistent deep copy of every counter and histogram.

        Taken under the stats lock, so a monitoring thread never observes
        a torn histogram (a deque mid-append, a dict mid-insert) while the
        scheduler records a batch — the concurrent-submitter soak test
        reads this under load.
        """
        with self._lock:
            snap = dict(served=self.served, failed=self.failed,
                        batches=self.batches,
                        mean_batch_size=self.mean_batch_size,
                        busy_s=self.busy_s,
                        dispatches=self.dispatches,
                        dispatch_s=self.dispatch_s,
                        transfer_bytes=self.transfer_bytes,
                        fused_fallbacks=self.fused_fallbacks,
                        last_fused_error=self.last_fused_error,
                        throughput_qps=self.throughput_qps,
                        p50_latency_s=_quantile(list(self.latencies_s),
                                                0.50),
                        p95_latency_s=_quantile(list(self.latencies_s),
                                                0.95),
                        p50_queue_wait_s=_quantile(
                            list(self.queue_waits_s), 0.50),
                        p95_queue_wait_s=_quantile(
                            list(self.queue_waits_s), 0.95),
                        batch_fill=dict(self.batch_fill),
                        closes=dict(self.closes),
                        served_by_family=dict(self.served_by_family),
                        relations={name: rs.as_dict()
                                   for name, rs in self.relations.items()})
        _yield_to_writers()
        return snap

    def as_dict(self) -> dict:
        return self.snapshot()


_EMPTY_REL = RelationStats()


def _yield_to_writers() -> None:
    """Hand the interpreter lock to a waiting thread after a stats read.

    A batch is thousands of short torch calls, and each one releases the
    GIL and must win it back. A monitor that polls the stats in a tight
    loop never blocks, so without this each of those calls would wait out
    the interpreter's switch interval (5 ms) and one batch would take
    seconds. ``time.sleep(0)`` releases the GIL at once."""
    time.sleep(0)


@dataclasses.dataclass
class _Tenant:
    """Scheduler-side state of one attached relation.

    ``wait_s`` is the *effective* (adaptively steered) deadline the
    scheduler parks on; ``base_wait_s`` the configured cap it may grow
    back to. Both mutate only under the server's condition lock.
    """
    name: str
    queue: "Deque[QueryRequest]"
    max_batch: int
    wait_s: float
    base_wait_s: float = -1.0       # <0: default to the initial wait_s
    weight: float = 1.0             # shared-pool DRR weight (attach())

    def __post_init__(self) -> None:
        if self.base_wait_s < 0:
            self.base_wait_s = self.wait_s

    def steer(self, reason: str, fill: int) -> float:
        """Update the effective wait after a close; returns it in ms.

        AIMD-flavoured: a *full* close means traffic filled ``max_batch``
        before the deadline — waiting longer only adds latency, so shrink
        multiplicatively. A *deadline* close below ``max_batch`` means the
        wait was too short to fill a batch — grow back toward (never past)
        the configured cap. Manual/drain pumps don't steer.
        """
        if self.base_wait_s > 0:
            if reason == "full":
                self.wait_s = max(MIN_STEER_WAIT_S,
                                  self.wait_s * STEER_SHRINK)
            elif reason == "deadline" and fill < self.max_batch:
                self.wait_s = min(self.base_wait_s,
                                  self.wait_s * STEER_GROW)
        return self.wait_s * 1e3


class QueryServer:
    """Deadline-batched scheduler for query plans over attached relations.

    The server is **multi-tenant**: :meth:`attach` registers any number of
    relations (the paper's data owner shares a *database*; users then
    query any relation without the owner), each with its own dataplane,
    plan namespace and per-relation batching policy, all driven by ONE
    scheduler thread. ``QueryServer(db, seed)`` is the single-relation
    surface: it attaches ``db`` under the default name. ``device`` and
    ``backend`` go to the server's :class:`QueryClient` (the CUDA
    kernels by default; ``device="cpu"`` runs their plain versions).

    ``submit`` enqueues (thread-safe; the returned request is
    ``wait()``-able) into the target relation's FIFO queue — pass a bare
    plan plus ``relation="orders"``, or a :class:`QueryRequest`; ``pump``
    drains one micro-batch (≤ the relation's ``max_batch``) through
    ``QueryClient.run_batch(plans, relation=...)`` — the client groups
    compatible strategies so each protocol round is issued once per group,
    not once per request. Two driving modes:

      * synchronous — the caller pumps (``serve`` is the convenience loop:
        enqueue everything, pump until every queue is dry);
      * async — ``start()`` spawns the scheduler thread: each relation's
        submissions park up to its ``max_wait_ms`` to fill its
        ``max_batch``, then that relation's batch closes (by *fill* or by
        *deadline* — counted in ``stats.closes``, also per relation) and
        runs. Relations close independently: a deep queue on "orders"
        never delays a deadline on "users", and requests never batch
        across relations. ``stop()`` drains every queue (closing a final
        batch per relation) *before* the thread exits; ``stop(
        drain=False)`` instead fails still-parked requests with
        :class:`ServerStopped` so no waiter ever hangs. The server is a
        context manager: ``with QueryServer(..., max_wait_ms=5) as srv``.

    ``shards=S`` (per attach) partitions that relation as a tuple-axis
    :class:`ShardedRelation`; all relations' shard dispatches share ONE
    server-owned thread pool (``pool_workers`` bounds the global fan-out),
    each through its own detachable :class:`~repro_torch.core.dataplane.
    PoolHandle` — pass ``dispatcher=`` to override placement per relation
    (e.g. ``MapReduceExecutor.dispatcher()``). Sharding and batching are
    both pure execution policy, and per-relation key streams are
    independent, so every relation's rows and ledgers are bit-identical
    to a solo single-relation server (the multi-tenant acceptance test).
    """

    def __init__(self, db: Union[SecretSharedDB, ShardedRelation,
                                 None] = None, seed: int = 0, *,
                 backend=None,
                 executor: Optional[MapReduceExecutor] = None,
                 max_batch: int = 32,
                 max_wait_ms: float = 20.0,
                 shards: int = 1,
                 dispatcher: Optional[Dispatcher] = None,
                 pool_workers: Optional[int] = None,
                 device=None):
        self.max_batch = max(1, max_batch)
        self.max_wait_ms = max(0.0, max_wait_ms)
        self.client = QueryClient(db, seed, backend=backend,
                                  executor=executor, device=device)
        self._owned_dispatcher: Optional[ThreadedDispatcher] = None
        self._pool_workers = pool_workers
        self._tenants: Dict[str, _Tenant] = {}
        self._rr_last: Optional[str] = None     # round-robin pump cursor
        self.stats = ServeStats()
        self._cond = threading.Condition()
        self._pump_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._drain_on_stop = True
        self._rejecting = False     # stop(drain=False) .. next start()
        if db is None and (shards > 1 or dispatcher is not None):
            raise ValueError(
                "shards=/dispatcher= are per-relation policies — with no "
                "db to attach they would be silently dropped; pass them "
                "to attach(name, relation, shards=..., dispatcher=...) "
                "instead")
        if db is not None:
            if shards > 1 or dispatcher is not None:
                if dispatcher is None:
                    plane = self.client.dataplane
                    workers = max(shards,
                                  plane.n_shards if plane else 1)
                    dispatcher = self._pool_handle(workers)
                self.client.attach(shards=shards, dispatcher=dispatcher)
            self._tenants[DEFAULT_RELATION] = _Tenant(
                DEFAULT_RELATION, collections.deque(), self.max_batch,
                self.max_wait_ms / 1e3)

    # -- relation registry --------------------------------------------------
    def _pool_handle(self, want_workers: int,
                     weight: float = 1.0) -> Dispatcher:
        """A per-relation handle on the ONE server-owned shard pool.

        The pool is created on first demand, sized by ``pool_workers``
        (falling back to the first requester's shard count), and shared by
        every relation attached afterwards — the global dispatch fan-out
        stays bounded no matter how many tenants are registered.
        ``weight`` is the handle's deficit-round-robin share of that
        bounded fan-out (see :class:`~repro_torch.core.dataplane.PoolHandle`).
        """
        if self._owned_dispatcher is None:
            self._owned_dispatcher = ThreadedDispatcher(
                max_workers=self._pool_workers or max(1, want_workers))
        return self._owned_dispatcher.handle(weight=weight)

    def attach(self, name: str,
               relation: Union[SecretSharedDB, ShardedRelation,
                               None] = None, *,
               shards: int = 1,
               dispatcher: Optional[Dispatcher] = None,
               key=None,
               max_batch: Optional[int] = None,
               max_wait_ms: Optional[float] = None,
               weight: float = 1.0) -> "QueryServer":
        """Register (or re-shard) relation ``name`` on this server.

        ``relation`` may be omitted to re-configure an already-attached
        name. ``key`` seeds the relation's private query-key stream (so a
        tenant replays a solo server bit-for-bit); ``max_batch`` /
        ``max_wait_ms`` override the server defaults for this relation's
        batch group only (``max_wait_ms`` also resets the steering cap).
        With ``shards > 1`` and no explicit ``dispatcher``, the relation's
        shard dispatches join the shared server pool through their own
        detachable handle, weighted ``weight`` in the pool's
        deficit-round-robin (a tenant with weight 2 gets twice the shard
        slots of a weight-1 neighbour under contention; fairness is pure
        scheduling policy, transcripts stay bit-identical). A one-shard
        relation stays serial, so its fetch never joins a fused wave.
        """
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        if shards > 1 and dispatcher is None:
            dispatcher = self._pool_handle(shards, weight)
        self.client.attach(relation, name=name, shards=shards,
                           dispatcher=dispatcher, key=key)
        with self._cond:
            t = self._tenants.get(name)
            if t is None:
                t = self._tenants[name] = _Tenant(
                    name, collections.deque(), self.max_batch,
                    self.max_wait_ms / 1e3)
            if max_batch is not None:
                t.max_batch = max(1, max_batch)
            if max_wait_ms is not None:
                t.wait_s = t.base_wait_s = max(0.0, max_wait_ms) / 1e3
            t.weight = float(weight)
            self._cond.notify_all()
        return self

    @property
    def relations(self) -> Tuple[str, ...]:
        """Attached relation names, in registration order."""
        with self._cond:                # vs a racing live attach()
            return tuple(self._tenants)

    @property
    def dataplane(self) -> Optional[ShardedRelation]:
        return self.client.dataplane

    def dataplane_of(self, relation: str) -> Optional[ShardedRelation]:
        return self.client.dataplane_of(relation)

    def _tenant(self, relation: Optional[str]) -> _Tenant:
        if relation is None:
            t = self._tenants.get(DEFAULT_RELATION)
            if t is not None:
                return t
            if len(self._tenants) == 1:
                return next(iter(self._tenants.values()))
            if not self._tenants:
                raise ValueError("no relation attached — construct with a "
                                 "db or call attach(name, db)")
            raise ValueError(f"several relations attached "
                             f"({list(self._tenants)}) — pass relation=")
        try:
            return self._tenants[relation]
        except KeyError:
            raise KeyError(f"unknown relation {relation!r}; attached: "
                           f"{list(self._tenants)}") from None

    # -- scheduling ---------------------------------------------------------
    def submit(self, request: Union[QueryRequest, Plan],
               relation: Optional[str] = None) -> QueryRequest:
        """Enqueue one request (thread-safe) into its relation's queue.

        Accepts a bare :class:`~repro_torch.api.plans.Plan` for convenience;
        ``relation`` (or ``request.relation``) routes it — omitted, the
        default/sole relation takes it.

        From the moment ``stop(drain=False)`` begins until the next
        ``start()``, submissions are failed immediately with
        :class:`ServerStopped` (their ``wait()`` raises) — a racer must
        never be parked on a queue nothing will ever pump.
        """
        if isinstance(request, Plan):
            request = QueryRequest(request)
        tenant = self._tenant(relation if relation is not None
                              else request.relation)
        request.relation = tenant.name
        request.enqueued_at = time.time()
        with self._cond:
            if self._rejecting:
                request.error = ServerStopped(
                    f"QueryServer stopped (drain=False) — not accepting "
                    f"submissions for relation {tenant.name!r} until "
                    f"start()")
                request._done.set()
            else:
                tenant.queue.append(request)
                self._cond.notify_all()
        if request.error is not None:
            self.stats.note_dropped(tenant.name)
        return request

    def pending(self, relation: Optional[str] = None) -> int:
        with self._cond:                # vs a racing live attach()
            if relation is not None:
                return len(self._tenant(relation).queue)
            return sum(len(t.queue) for t in self._tenants.values())

    def _rotation(self) -> List[str]:
        """Tenant names rotated past the last-pumped one — the shared
        round-robin order of the sync pump and the async scheduler scan
        (so a chatty relation cannot starve its neighbours)."""
        names = list(self._tenants)
        start = (names.index(self._rr_last) + 1
                 if self._rr_last in names else 0)
        return names[start:] + names[:start]

    def _next_tenant(self) -> Optional[_Tenant]:
        for name in self._rotation():
            if self._tenants[name].queue:
                return self._tenants[name]
        return None

    def pump(self, reason: str = "manual",
             relation: Optional[str] = None) -> List[QueryRequest]:
        """Drain one relation's micro-batch and execute it.

        ``relation`` picks the batch group; omitted, the round-robin
        cursor finds the next relation with queued work. Batches NEVER mix
        relations — each closes and runs against its own dataplane with
        its own key stream, so per-relation results are independent of
        neighbour traffic.

        Fault isolation: a plan that raises (bad cardinality hint, invalid
        padding, …) must not take its batch-mates down, so on a batch
        failure the micro-batch is re-run per request and only the
        offending request(s) carry ``error`` (result stays None).
        """
        with self._pump_lock:
            with self._cond:
                tenant = (self._tenant(relation) if relation is not None
                          else self._next_tenant())
                if tenant is None:
                    return []
                self._rr_last = tenant.name
                batch = self._close_locked(tenant)
            if not batch:
                return []
            self._run_closed([(tenant, reason, batch)])
            return batch

    @staticmethod
    def _close_locked(tenant: _Tenant) -> List[QueryRequest]:
        """Pop one micro-batch (≤ max_batch) off a tenant's queue.

        Caller holds ``_cond`` — the pop and the close decision that
        triggered it are one atomic scheduling step.
        """
        batch: List[QueryRequest] = []
        while tenant.queue and len(batch) < tenant.max_batch:
            batch.append(tenant.queue.popleft())
        return batch

    def _run_closed(self, closed: List[Tuple[_Tenant, str,
                                             List[QueryRequest]]]) -> None:
        """Execute already-closed batches (caller holds ``_pump_lock``).

        One entry runs the classic ``run_batch`` path. Several entries —
        the scheduler found several relations due in ONE scan — run as one
        ``QueryClient.run_batch_multi`` wave: per-relation rounds stay
        separate (keys, rounds, ledgers untouched, results bit-identical
        to solo closes) but every batch's cloud-side fetch ``ss_matmul``
        co-schedules on the shared pool as a single fused dispatch wave.
        Fault isolation is layered: a failing fused wave falls back per
        relation (counted in ``stats.fused_fallbacks``), a failing relation
        batch per request, so only the offending request(s) carry
        ``error``.

        After each batch the tenant's deadline is steered
        (:meth:`_Tenant.steer`) and its ``queue_depth`` /
        ``steered_wait_ms`` gauges are refreshed.
        """
        t0 = time.time()
        for tenant, _reason, batch in closed:
            for r in batch:
                r.queue_wait_s = t0 - (r.enqueued_at or t0)
                self.stats.note_queue_wait(r.queue_wait_s, tenant.name)
        planes = {t.name: self.client.dataplane_of(t.name)
                  for t, _, _ in closed}
        d0s = {name: dataclasses.replace(p.stats) if p else None
               for name, p in planes.items()}
        fused: Optional[List[List[QueryResult]]] = None
        if len(closed) > 1:
            try:
                fused = self.client.run_batch_multi(
                    [(t.name, [r.plan for r in batch])
                     for t, _, batch in closed])
            except Exception as e:  # noqa: BLE001 — isolate relation(s)
                self.stats.note_fused_fallback(e)
                fused = None
        t_prev = t0
        for i, (tenant, reason, batch) in enumerate(closed):
            if fused is not None:
                outcomes: List[Union[QueryResult, Exception]] = \
                    list(fused[i])
            else:
                try:
                    outcomes = list(self.client.run_batch(
                        [r.plan for r in batch], relation=tenant.name))
                except Exception:  # noqa: BLE001 — isolate request(s)
                    outcomes = []
                    for r in batch:
                        try:
                            outcomes.append(self.client.run_batch(
                                [r.plan], relation=tenant.name)[0])
                        except Exception as e:  # noqa: BLE001
                            outcomes.append(e)
            t1 = time.time()
            # busy accounting: a fused wave's wall is split across its
            # relations (the aggregate stays the wall actually spent);
            # sequential fallbacks charge their own span.
            busy = ((t1 - t0) / len(closed) if fused is not None
                    else t1 - t_prev)
            t_prev = t1
            for r, res in zip(batch, outcomes):
                r.latency_s = t1 - (r.enqueued_at or t0)
                if isinstance(res, Exception):
                    r.error = res
                    self.stats.note_result(r.latency_s, None, tenant.name)
                else:
                    r.result = res
                    self.stats.note_result(r.latency_s,
                                           plan_family(r.plan), tenant.name)
                r._done.set()
            plane, d0 = planes[tenant.name], d0s[tenant.name]
            d = plane.stats if plane else None
            with self._cond:
                depth = len(tenant.queue)
                steered = tenant.steer(reason, len(batch))
            self.stats.record_batch(
                len(batch), reason, tenant.name, busy_s=busy,
                dispatches=(d.dispatches - d0.dispatches) if d else 0,
                dispatch_s=(d.dispatch_s - d0.dispatch_s) if d else 0.0,
                transfer_bytes=(d.transfer_bytes - d0.transfer_bytes)
                if d else 0,
                queue_depth=depth, steered_wait_ms=steered)

    # -- async driver -------------------------------------------------------
    def start(self) -> "QueryServer":
        """Spawn the deadline-batching scheduler thread (idempotent)."""
        with self._cond:
            if self._thread is not None:
                return self
            self._stopping = False
            self._drain_on_stop = True
            self._rejecting = False
            self._thread = threading.Thread(target=self._scheduler_loop,
                                            name="query-server",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the scheduler thread.

        ``drain=True`` (default): the scheduler closes a final batch per
        relation — pending submissions are *served*, then the thread
        joins; a late racer still in a queue after the join is pumped
        inline. ``drain=False``: still-parked requests are failed with
        :class:`ServerStopped` (their ``wait()`` raises instead of
        hanging forever).
        """
        with self._cond:
            thread = self._thread
            self._stopping = True
            self._drain_on_stop = drain
            if not drain:
                # close the race window NOW: anything already queued is
                # swept by _fail_pending below; anything submitted after
                # this point fails fast inside submit().
                self._rejecting = True
            self._cond.notify_all()
        if thread is not None:
            thread.join()
        with self._cond:
            self._thread = None
        if drain:
            while self.pending():
                self.pump("drain")
        else:
            self._fail_pending()

    def _fail_pending(self) -> None:
        """Drop every queued request with a loud ServerStopped error."""
        with self._cond:
            dropped = [(t.name, r) for t in self._tenants.values()
                       for r in t.queue]
            for t in self._tenants.values():
                t.queue.clear()
        for name, r in dropped:
            r.error = ServerStopped(
                f"QueryServer stopped (drain=False) before serving this "
                f"request (relation {name!r})")
            self.stats.note_dropped(name)
            r._done.set()

    def close(self) -> None:
        """Stop the scheduler and release the server-owned shard pool.

        Terminal: after ``close()`` the shared pool's handles fall back to
        serial shard execution (still correct) if reused.
        """
        self.stop()
        if self._owned_dispatcher is not None:
            self._owned_dispatcher.close()

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _pump_due(self, todos: List[Tuple[str, str]]) -> None:
        """Close and run every due ``(relation, reason)`` from one scan.

        A single due relation takes the classic pump path; several close
        together and run as one fused dispatch wave.
        """
        if len(todos) == 1:
            self.pump(todos[0][1], relation=todos[0][0])
            return
        with self._pump_lock:
            closed: List[Tuple[_Tenant, str, List[QueryRequest]]] = []
            with self._cond:
                for name, reason in todos:
                    t = self._tenants.get(name)
                    if t is None:        # racing live detach/re-attach
                        continue
                    batch = self._close_locked(t)
                    if batch:
                        self._rr_last = t.name
                        closed.append((t, reason, batch))
            if closed:
                self._run_closed(closed)

    def _scheduler_loop(self) -> None:
        while True:
            todos: List[Tuple[str, str]] = []
            with self._cond:
                while not self._stopping and not any(
                        t.queue for t in self._tenants.values()):
                    self._cond.wait()       # submit()/stop()/attach notify
                if self._stopping:
                    break
                # per-relation close decisions: a batch group closes by
                # *fill* when its queue reaches the relation's max_batch,
                # by *deadline* when its OLDEST submission's (steered)
                # wait expires — latency is bounded per relation by
                # max_wait_ms, fusion by max_batch; relations never delay
                # one another. The scan ROTATES past the last-pumped
                # tenant (same cursor as the sync pump) so a tenant kept
                # permanently full by hot traffic cannot starve a
                # neighbour's expired deadline. EVERY relation due in the
                # same scan closes together — the batches then run as one
                # fused dispatch wave (see _run_closed).
                now = time.time()
                earliest: Optional[float] = None
                for name in self._rotation():
                    t = self._tenants[name]
                    if not t.queue:
                        continue
                    if len(t.queue) >= t.max_batch:
                        todos.append((t.name, "full"))
                        continue
                    deadline = t.queue[0].enqueued_at + t.wait_s
                    if deadline <= now:
                        todos.append((t.name, "deadline"))
                        continue
                    earliest = (deadline if earliest is None
                                else min(earliest, deadline))
                if not todos:
                    # floored park: a sub-ms (or steered-to-tiny) deadline
                    # must not degrade the loop into a busy-spin.
                    self._cond.wait(max(MIN_PARK_S, earliest - now))
                    continue
            self._pump_due(todos)
        # drain-before-exit: close a final batch per relation so stop()
        # never drops parked submissions on the floor (drain=False skips
        # this — stop() then fails them loudly instead).
        if self._drain_on_stop:
            while self.pending():
                self.pump("drain")

    def serve(self, requests: Sequence[QueryRequest]) -> List[QueryRequest]:
        """Enqueue ``requests`` and finish them all.

        With the scheduler running this blocks on the requests' completion
        events; otherwise it pumps inline until every queue is dry.
        """
        for r in requests:
            self.submit(r)
        if self._thread is not None:
            for r in requests:
                r.wait()
            return list(requests)
        done: List[QueryRequest] = []
        while self.pending():
            done += self.pump()
        return done

    def reset(self) -> None:
        self.stats = ServeStats()
