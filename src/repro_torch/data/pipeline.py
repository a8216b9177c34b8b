"""Data pipeline: deterministic synthetic sources and a device feed.

Two producers, the reference's numpy code unchanged, so both packages
give the same rows and batches for the same seed:

* ``synthetic_relation``: Employee-style string relations for the
  secret-shared query engine (names, departments, salaries, with a skew
  that makes a predicate hit many tuples, the paper's ℓ > 1 regime);
* ``TokenStream`` / ``make_lm_batches``: reproducible LM token batches.
  ``batch_at(i)`` is a pure function of (seed, i), so a restarted job
  re-derives batch i exactly.

``Prefetcher`` makes host batches on a background thread, ``depth``
ahead, and with ``device=`` uploads them there (pinned memory, copied
without making the host wait: ``_device.upload``).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np
import torch

from .. import _device

FIRST = ["Adam", "John", "Eve", "Mia", "Noah", "Lily", "Omar", "Zoe",
         "Ivan", "Nina"]
LAST = ["Smith", "Taylor", "Williams", "Brown", "Lee", "Patel", "Cohen",
        "Garcia"]
DEPT = ["Sale", "Design", "HR", "R-D"]


def synthetic_relation(n: int, *, seed: int = 0, skew: float = 0.0
                       ) -> List[List[str]]:
    """Employee-style relation (EmployeeId, FirstName, LastName, Salary,
    Department). skew > 0 biases FirstName toward FIRST[1] ("John") so
    predicates hit multiple tuples."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        if skew and rng.random() < skew:
            first = FIRST[1]
        else:
            first = FIRST[rng.integers(len(FIRST))]
        rows.append([
            f"E{100 + i}",
            first,
            LAST[rng.integers(len(LAST))],
            str(int(rng.integers(500, 8000))),
            DEPT[rng.integers(len(DEPT))],
        ])
    return rows


class TokenStream:
    """Counter-based deterministic token batches: batch(i) is a pure
    function of (seed, i), restartable mid-stream with no state."""

    def __init__(self, vocab_size: int, batch: int, seq: int, *,
                 seed: int = 0):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = seed

    def batch_at(self, index: int) -> Dict[str, np.ndarray]:
        """{"tokens", "labels"}: int32 (batch, seq) each, labels the
        tokens shifted by one."""
        rng = np.random.default_rng((self.seed, index))
        toks = rng.integers(0, self.vocab, size=(self.batch, self.seq + 1),
                            dtype=np.int32)
        # learnable structure: next token correlated with current
        toks[:, 1:] = (toks[:, :-1] + rng.integers(
            0, 7, size=(self.batch, self.seq), dtype=np.int32)) % self.vocab
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1


def make_lm_batches(cfg, shape_batch: int, seq: int, *, seed: int = 0
                    ) -> TokenStream:
    return TokenStream(cfg.vocab_size, shape_batch, seq, seed=seed)


def to_device(batch: Dict[str, np.ndarray], device, *, mesh=None,
              specs=None) -> Dict[str, torch.Tensor]:
    """A host batch's arrays -> tensors of their dtypes on ``device``.

    With ``mesh`` (a ``DeviceMesh``) and ``specs`` (an entry's spec tuple,
    as ``sharding.batch_spec`` gives them, by key), ``batch`` is the global
    batch and each entry becomes a ``DTensor``: this rank uploads only its
    own block (its data-axis rows), and the other axes, a microbatch-major
    batch's accumulation axis included, stay whole."""
    from .. import sharding
    out = {}
    for k, v in batch.items():
        arr = np.ascontiguousarray(v)
        if mesh is None:
            t = torch.from_numpy(arr)
            out[k] = _device.upload(t, t.dtype, device)
            continue
        from torch.distributed.tensor import DTensor
        pls = sharding.placements(specs[k], mesh)
        block = torch.from_numpy(np.ascontiguousarray(
            arr[sharding.local_block(arr.shape, mesh, pls)]))
        local = _device.upload(block, block.dtype, device)
        out[k] = DTensor.from_local(
            local, mesh, pls, run_check=False, shape=arr.shape,
            stride=_device.contiguous_strides(arr.shape))
    return out


class Prefetcher:
    """Depth-k background prefetch of host batches (uploaded to
    ``device`` when it is given)."""

    def __init__(self, it: Iterator, depth: int = 2, device=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._device = None if device is None else _device.resolve(device)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._device is not None:
                    item = to_device(item, self._device)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return

        self._th = threading.Thread(target=worker, daemon=True)
        self._th.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        """Stop the worker; it exits within ~0.1 s."""
        self._stop.set()
