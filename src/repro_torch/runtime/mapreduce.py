"""Fault-tolerant MapReduce runtime — the paper's execution substrate.

The paper runs its oblivious queries as MapReduce jobs: a *master* assigns
map tasks over input splits; the original MapReduce fault model (Dean &
Ghemawat, OSDI'04) re-executes lost tasks and launches **speculative backup
tasks** for stragglers. This module is that master:

  * a worker pool with leases; a worker that misses its lease deadline is
    declared dead and its in-flight task re-queued;
  * injected fault hooks (``fail_prob``, ``slow_workers``,
    ``dead_workers``) so tests can kill workers and create stragglers
    deterministically;
  * speculative execution: when ≥ ``spec_threshold`` of the tasks have
    finished, backup copies of the stragglers are issued and the first
    result wins (map tasks are pure share-space programs, so duplicate
    execution is safe).

Workers are host threads. On a GPU a map task returns once its kernels are
queued on the device, so a lease and ``TaskResult.duration_s`` measure host
time, not device time, and a speculative backup queues the same kernels a
second time; both are harmless because tasks are pure.

Two callers sit on top of this runner: ``repro_torch.api.executor.
MapReduceExecutor.wrap`` (each backend op splits its own data axis into map
tasks) and ``MapReduceDispatcher`` (each shard dispatch of a
``ShardedRelation`` becomes one map task). ``splits`` is any sequence of
task payloads — split bounds for the wrapper, zero-argument thunks for the
dispatcher.
"""
from __future__ import annotations

import dataclasses
import queue
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

#: name of every map-task thread (callers that must not let a straggler's
#: late launch run into their next step join the threads by this name).
THREAD_NAME = "mapreduce-task"


@dataclasses.dataclass
class TaskResult:
    task_id: int
    value: Any
    worker: int
    attempt: int
    duration_s: float


@dataclasses.dataclass
class _Attempt:
    task_id: int
    attempt: int
    worker: int
    started: float
    deadline: float


class WorkerPool:
    """Worker threads with injected failures and slowness."""

    def __init__(self, n_workers: int, *, fail_prob: float = 0.0,
                 slow_workers: Optional[Dict[int, float]] = None,
                 dead_workers: Optional[set] = None, seed: int = 0):
        self.n = n_workers
        self.fail_prob = fail_prob
        self.slow = slow_workers or {}
        self.dead = dead_workers or set()
        self.rng = random.Random(seed)


class MapReduceRunner:
    """run(map_fn, splits, reduce_fn) with re-execution + backup tasks."""

    def __init__(self, pool: WorkerPool, *, lease_s: float = 2.0,
                 spec_threshold: float = 0.75, max_attempts: int = 4,
                 poll_s: float = 0.01):
        self.pool = pool
        self.lease_s = lease_s
        self.spec_threshold = spec_threshold
        self.max_attempts = max_attempts
        self.poll_s = poll_s
        # telemetry the tests and the chip smoke read
        self.reexecutions = 0
        self.speculative_launched = 0
        self.worker_deaths = 0

    def _exec(self, map_fn, splits, task_id: int, attempt: int, worker: int,
              out_q: "queue.Queue"):
        t0 = time.time()
        slow = self.pool.slow.get(worker, 0.0)
        if slow:
            time.sleep(slow)
        if worker in self.pool.dead:
            return  # silent death: no result -> lease expiry
        if self.pool.rng.random() < self.pool.fail_prob:
            return  # crashed mid-task
        try:
            value = map_fn(splits[task_id])
        except Exception as e:  # noqa: BLE001 — relayed to the master
            out_q.put(("error", task_id, attempt, worker, e))
            return
        out_q.put(("ok", TaskResult(task_id, value, worker, attempt,
                                    time.time() - t0)))

    def run(self, map_fn: Callable[[Any], Any], splits: Sequence[Any],
            reduce_fn: Optional[Callable[[List[Any]], Any]] = None) -> Any:
        n = len(splits)
        results: Dict[int, TaskResult] = {}
        attempts: Dict[int, int] = {i: 0 for i in range(n)}
        inflight: List[_Attempt] = []
        out_q: "queue.Queue" = queue.Queue()
        next_worker = [0]

        def launch(task_id: int):
            w = next_worker[0] % self.pool.n
            next_worker[0] += 1
            attempts[task_id] += 1
            att = attempts[task_id]
            if att > self.max_attempts:
                raise RuntimeError(f"task {task_id} exceeded max attempts")
            now = time.time()
            inflight.append(_Attempt(task_id, att, w, now,
                                     now + self.lease_s))
            threading.Thread(
                target=self._exec, name=THREAD_NAME,
                args=(map_fn, splits, task_id, att, w, out_q),
                daemon=True).start()

        for task_id in range(n):
            launch(task_id)

        spec_done = False
        while len(results) < n:
            # drain every queued result per poll: taking one per poll would
            # add up to poll_s of latency per finished task
            ready = []
            try:
                ready.append(out_q.get(timeout=self.poll_s))
                while True:
                    ready.append(out_q.get_nowait())
            except queue.Empty:
                pass
            for kind, *payload in ready:
                if kind != "ok":
                    raise payload[3]
                res: TaskResult = payload[0]
                if res.task_id not in results:      # first result wins
                    results[res.task_id] = res
                inflight[:] = [a for a in inflight
                               if a.task_id != res.task_id]
            now = time.time()
            # lease expiry -> declare the worker dead, re-execute
            expired = [a for a in inflight if a.deadline < now
                       and a.task_id not in results]
            for a in expired:
                inflight.remove(a)
                self.worker_deaths += 1
                self.reexecutions += 1
                launch(a.task_id)
            # speculative backups for stragglers
            if not spec_done and len(results) >= self.spec_threshold * n:
                for t in {a.task_id for a in inflight
                          if a.task_id not in results}:
                    self.speculative_launched += 1
                    launch(t)
                spec_done = True
        ordered = [results[i].value for i in range(n)]
        return reduce_fn(ordered) if reduce_fn else ordered
