#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--tuples 131072] [--seed 0]
    python3 chip_smoke.py --aa-times SRC      # only the match/slide times
    python3 chip_smoke.py --ripple-times SRC  # only the ripple times
    python3 chip_smoke.py --setup-peak SRC    # only the table set-up peak
    python3 chip_smoke.py --decode-times SRC  # only LM prefill/decode times
    python3 chip_smoke.py --onehot-times SRC  # only the share_onehot times

Phases, any failure exits non-zero:

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   (one process per source, in parallel).
2. Hold each kernel against its plain PyTorch version, bit for bit, on
   random shares with p−1 extremes and ragged shapes (M = 0, N = 0, a
   K split across blocks, broadcast columns with B-stride 0, row blocks;
   ripple segments of k = 1..13 bits, LSB and carried, lane counts that
   are not a multiple of the block, per-segment and per-shard slices;
   sliding windows for k = 1..W, the tall-skinny matmul at M = 1, 17, 255
   and 256, K not a multiple of its tile, N = 1, and at vocab-shard
   offsets that are not a multiple of 4; the fused one-hot sharing at
   M = 1..300, V = 1..256,206 (every V % 4), c = 1, 4, 20 with −1, V and
   2³¹ + 3 as tokens, each call on the route its plan names; both
   matmul kernels where their byte-limb arithmetic is tightest: all-(p−1)
   and all-(2³¹−1) operands at K = 2·8,192 + 1 and the 8,192-term
   K-chunk boundary at M = 1, 9, 33 and 257; the match and slide kernels
   where their staging is tightest: all-(p−1) and all-(2³¹−1) operands at
   full W, prefix views of k = 1 and 4 positions, a row of 660 bytes on
   the 16-byte copy route, zero-length and one-row blocks, a B-stride-0
   stack cut into two chunks of patterns, and a slide whose 1,173 tile
   rows take several passes, each one launch; both of the ripple kernel's
   routes — bit-major planes and interleaved rows — at k = 1..13, LSB and
   carried, on ragged 4-lane tails, carry rows off 16-byte bounds, shard
   slices at 16- and 4-byte offsets (bit-major, strided) and one-lane
   rows, each call on the route its plan names).
3. Drive the main paths through the public entry points at full size: the
   README's Employee schema (5 string attributes, word length 8, A = 69,
   degree 1, c = 20 clouds) over ``--tuples`` synthetic rows made from
   ``--seed`` — 28.9 GB of int32 shares at 131,072 tuples — with Salary
   (hundreds of dollars, 100..2000) also outsourced in 13-bit binary form.
   Slice 1: ``outsource``, ``count``, ``select`` forced to one_tuple /
   one_round / tree and AUTO, and one ``run_batch`` of 8 mixed plans.
   Slice 2: ``range_count`` at ``reduce_every`` 8 and 1, a narrow
   ``range_select``, SUM / conditional AVG / MIN / verified conditional
   MAX, and one ``run_batch`` of 2 ranges, 3 aggregates and a count.
   Slice 3: pattern counts of every kind (masked, prefix, suffix,
   contains, a wildcard-free LIKE on the Eq path), one_round selects
   (masked ℓ = 4, suffix ℓ = 13, a prefix with ℓ = 1,000), a tree select
   (contains, ℓ = 12), an AUTO select and one mixed ``run_batch``.
   Slice 4: the oblivious embedding lookup at Qwen1.5-4B width
   (V = 151,936, D = 2,560) over a synthetic table from ``--seed``, shared
   over c = 4 clouds (6.22 GB): ``setup_private_embed``, ``EmbedLookup``
   through a client at S = 1 and at S = 2 (a 256-token prefill, 4 decode
   steps of 8, a batch of 4 with one verified), ``private_lookup_batched``
   and ``private_lookup``.
   Slice 5 (run before slice 4, so the table is not resident): PK/FK
   joins of a synthetic 1,024-row Assignment relation (EmployeeId,
   Project, Hours; 24 dangling ids) from ``--seed`` against the Employee
   relation — ``client.join`` (chain), ``Join(match_method=...)``
   aggregate and auto, one ``run_batch`` of the join, a one_round select
   and a count, and the chain at S = 2 — and an equijoin on FirstName
   with a 512-row Visitor relation and ``Padding.fake_values(2)`` (54
   pairs, 9 rounds); per call host seconds, launches, peak memory and a
   ``torch.profiler`` device split.
   Slice 6 (after slice 5, before slice 4): multi-tenant serving. A
   ``QueryServer`` (max_batch 8, 20 ms deadline, a 2-worker shard pool)
   serves the Employee relation at 2 shards (weight 2) and slice 5's
   Assignment relation at 1 shard: 4 submitter threads send 48 plans
   (Eq counts at ℓ = 1, 3, 16, 0; one_tuple, one_round and tree selects;
   a contains count; a range count and a SUM on Salary; counts and
   selects on Project): each thread parks a burst of nine before
   ``start()``, so the first scan closes both relations together as one
   fused wave, then sends its last three alone after an idle pause
   (deadline closes) while the scheduler runs. Then a
   ``MapReduceExecutor`` client (4 splits, worker 2 dead, worker 3 slow)
   runs a count, a one_round select and a range count. Every answer is
   held to the plaintext and every ledger to a solo replay; logs closes,
   latency, throughput, pool dispatches, launches, the MapReduce counters
   and the phase's host seconds and peak memory.
   Slice 11 (after slice 6, before slice 4): ``MeshDispatcher`` on a
   ``("data", "model")`` grid, the Employee relation at 2 shards. (a) A
   2 x 2 grid of ``cuda:0`` at the full n: 2 data rows, 2 groups of 10
   clouds. A count, the one-tuple, one-round and tree selects, a
   substring count, ``RangeCount`` at ``reduce_every`` 8 and 1, SUM, MIN
   and a PK/FK join with slice 5's Assignment relation run on the 1 x 1
   grid and on the 2 x 2 one: every answer must equal the plaintext and
   the 1 x 1 grid's, every ledger its ledger, the dispatcher's record of
   copies must show zero bytes from one cloud group's slot to another's,
   and every kernel but ``share_onehot`` must launch on the 2 x 2 grid
   (launches counted from zero before it). (b) Distinct devices: every
   card at the full n when there are two or more; on one card
   ``[cuda:0, cpu]`` on the model axis, cloud group 1 on the host
   running the plain versions, at 16,384 tuples and a 32-row child
   relation; the same checks. Logs each call's host seconds beside the
   1 x 1 grid's, the copies by kind, the placed bytes by slot, the
   predicted reduction cost and the peak memory. Slice 7's route (b) runs
   under the default ``MeshDispatcher()``: every visible card on data.
   Slice 7 (last, after phase 4, with the earlier relations freed):
   private LM generation at the full Qwen1.5-4B configuration of
   ``repro_torch.configs`` (40 layers, d 2,560, 20 heads, d_ff 6,912,
   V 151,936, QKV bias, bf16) on synthetic weights from ``--seed``; the
   table is shared once (c = 4, degree 1) into ``params["embed_shares"]``.
   4 requests of 64 prompt tokens and 32 new ones run three ways — (c) a
   plaintext ``BatchServer`` over the dequantized quantized table, (a)
   ``BatchServer`` with ``private_embed=True``, (b) the
   ``private_generate`` flow (``QueryClient`` with the table at 2 vocab
   shards under ``MeshDispatcher()``, one ``EmbedLookup`` a step into
   ``decode_step(embeds=)``) — and must give identical tokens;
   ``share_onehot`` and ``ss_matmul_tall`` must launch inside (a) and (b);
   decode must match forward within atol 0.12 / rtol 0.05 and the tall
   kernel at the decode shape (M = 4) its plain version. Logs set-up
   seconds and peak, prefill seconds and ms per decode step a route,
   tokens/s, the lookup's share of a (b) step, launches per lookup, a
   ``torch.profiler`` device split and idle share a route, and the peak.
   Slice 8 (after slice 7, on a freed card): the other decoder families
   at their full published configurations of ``repro_torch.configs``, bf16,
   synthetic weights from ``--seed``, one after another, each freed
   before the next: MiniCPM3-4B (MLA; 4 × 640 prompt tokens, past one
   512-key block of ``flash_attention``), Granite-3.0-3B-A800M and
   Moonlight-16B-A3B (MoE, einsum dispatch; 4 × 64; Moonlight at 24 of
   its 48 layers), Mamba2-2.7B (SSM) and Hymba-1.5B (attention + SSM; 4
   × 320, one full 256-token SSD chunk and a padded one), 32 new tokens
   each. The table is shared once (c = 4, degree 1); (c) a plaintext
   ``BatchServer`` over the dequantized table and (a) a private one must
   give identical tokens and equal prefill logits; (a) must launch one
   ``share_onehot`` and one contraction a lookup (``ss_matmul_tall`` at
   the decode steps and the 256-row prefills, the general ``ss_matmul``
   at the 1,280- and 2,560-row ones), (c) none; every logit must be
   finite; each kernel shape of (a) must equal its plain version; for
   MiniCPM3, Mamba2 and Hymba the same configuration in float32 must give
   a decode step within atol 1e-4 / rtol 1e-4 of the forward (in bf16 the
   error is logged beside bf16's noise floor, the same forward at two
   lengths); the MoE sort dispatch must match the einsum one at smoke
   width (capacity 8.0, atol 0.06). Logs per family the
   parameters, set-up seconds and peak, prefill ms and decode ms a step a
   route, tokens/s, idle share and peak device memory.
   Slice 9 (after slice 8, on a freed card): the encoder-decoder and the
   ViT-prefixed families as slice 8 runs the others, through a greedy
   loop over ``lm.prefill`` and ``lm.decode_step`` whose prefill carries
   the frontend input (``BatchServer`` passes tokens only):
   SeamlessM4T-medium in full (12 + 12 layers, d 1,024, V 256,206; 4
   requests of 640 audio frames of dim 160, past one 512-key block in the
   encoder and the cross-attention, and a 2-token decoder prompt) and
   InternVL2-76B at full width on 20 of its 80 layers (d 8,192, V 128,256,
   its table shares 16.8 GB, the first past 2^31 elements; 4 requests of
   256 patch embeddings of dim 3,200 and 64 text tokens). Both routes must
   give identical tokens and equal prefill logits; route (a) must launch
   one ``share_onehot`` and one ``ss_matmul_tall`` a lookup (every lookup
   is tall: M = 8 or 256 at the prefill, 4 at a decode step), each equal
   to its plain version bit for bit (the plain contraction 1,024 table
   columns at a time); in float32 a decode step must match the forward
   within 1e-4 (InternVL2 at 2 layers). Logs, beside slice 8's numbers,
   the encoder's ms, the set-up's margin on the card and the lookup
   kernels' ms against their bounds at these shapes.
   Slice 10 (after slice 9, on a freed card): training at the full
   Qwen1.5-4B configuration (40 layers, d 2,560, V 151,936, untied head,
   bf16, remat on; 3.95 B synthetic parameters from ``--seed``) on
   ``TokenStream`` batches of 4 x 512 tokens, AdamW at lr 3e-4 with 2
   warmup steps. t1: ``launch.train.main`` for 4 steps (finite losses,
   grad_norm > 0, ``lr`` on its schedule, weights moved; ms a step,
   tokens/s, peak memory, and the idle share over a profiled step), and 2
   layers at full width in float32, one step's loss and gradients on the
   card against the same code on the CPU within 1e-4. t2: the private
   embedding (``private_embed=True``, the table re-shared each step)
   through ``make_train_step``, 2 steps, each launching exactly one
   ``share_onehot`` and one general ``ss_matmul`` (2,048 rows), its
   embeddings equal to the dequantized table's rows, the untied ``embed``
   gradient-free and decayed by the AdamW rule; both kernels at these
   shapes equal their plain versions. t3: ``grad_accum`` 2 with int8
   compression, 2 steps (40 layers unless the predicted peak leaves under
   5 GB), every compressed gradient within half its block's step. t4: a
   run killed after step 3 and restarted beside a torn ``step_4.tmp``
   gives the uninterrupted run's losses, and the restored tensors equal
   the saved ones bit for bit (the smoke config, checkpoints under
   ``build/``).
   Every count, address list, row and value is checked against a plaintext
   evaluation of the rows, every embedding against the quantized table;
   each path's kernel launch counters are zeroed just before it and must
   have risen for every kernel it runs.
4. Hold every call form the paths use against its plain version again at
   the paths' full shapes, through the same ``ops`` wrappers: the
   one-column count stack, a one-column stack of 8 predicates (one launch),
   the distinct-column count and a tree round's 16 row blocks
   (``aa_match_rows``), the fetch, the one_tuple and the
   conditional-SUM contractions, the range's first ripple segment, a
   carried k = 1 step and the tournament's levels 1 and 10 (operands built
   bit-major by the path's helpers; the range's also interleaved, on the
   strided route), the sliding-window
   match of the suffix and substring counts, the tall-skinny fetch at
   R = 3, 69 and 256 rows and the ℓ = 1,000 fetch on the general kernel,
   the one-hot sharing of a 256-token prefill and the embedding
   contraction at M = 8 and 256 (on the tall and on the general kernel),
   and the joins' launches (a K = 69 match position in both orientations,
   the K = 552 aggregate product, the 1,024-row PK/FK fetch and the
   21-row tall equijoin fetch; the chain's copies, launches and modular
   products and the equality indicator timed apart; ``share_onehot`` at
   decode steps (M = 4, 8) over V = 151,936, 256,206, 49,155 and 32,001,
   at M = 256 over 151,936 and 128,256 and at M = 2,048 by device time,
   the median of CUDA-graph replays, and the device time of its kernel
   in those replays (``torch.profiler``) beside its host-inclusive time,
   each row on the quad route; one call with int64 tokens must run
   exactly one device kernel);
   time kernel and plain version there (CUDA events; the match at B = 1
   and 8 and over the tree round, the slide at k = 2, 3 and 5; the ripple
   kernel on both routes, the median of CUDA-graph replays, beside the
   launcher's host µs a call, and the ripple operand builds against the
   interleaved ``torch.cat``/``torch.where``/``torch.stack``), each
   beside its bound: bytes at 3.35 TB/s or operations, at the int32 rate,
   or for the two matmul kernels at the tensor cores' int8 rate (32 int8
   operations per modular multiply-accumulate). Prints the phase's peak device
   memory.

Prints the kernels JSON line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``. Needs no JAX and no network.
"""
from __future__ import annotations

import argparse
import collections
import copy
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

P = 2**31 - 1
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
#: H100 SXM int32 rate outside the tensor cores: 64 INT32 lanes per SM,
#: half the 128 FP32 lanes behind the 67 TFLOP/s fp32 figure; a mod-p
#: multiply-accumulate counts as 2 operations.
INT32_OPS_PER_S = 33.5e12
#: H100 SXM dense int8 rate of the tensor cores. The two matmul kernels
#: make each exact mod-p multiply-accumulate from 16 int8 ones (4 x 4 byte
#: limbs of two 31-bit operands), so c·M·K·N of them count 32·c·M·K·N
#: operations at this rate.
INT8_TENSOR_OPS_PER_S = 1.979e15

NAMES = ["EmployeeId", "FirstName", "LastName", "Salary", "Department"]
PLANT = {"one_round": "Zorro", "tree": "Quinn", "absent": "Nobody"}
ELL = {"Zorro": 3, "Quinn": 16}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _words(rng, k: int, lo: int, hi: int, taken) -> np.ndarray:
    """k distinct capitalised words of lo..hi letters, none in ``taken``."""
    low = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    up = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    out = set()
    while len(out) < k:
        n = int(rng.integers(lo, hi + 1))
        w = up[rng.integers(26)] + "".join(low[rng.integers(0, 26, n - 1)])
        if w not in taken:
            out.add(w)
    return np.array(sorted(out))


def make_rows(n: int, seed: int) -> np.ndarray:
    """(n, 5) str array; FirstName plants ℓ = 3 (Zorro), ℓ = 16 (Quinn) and
    ℓ = 0 (Nobody); EmployeeId is unique; Salary is in hundreds of dollars,
    uniform in 100..2000 (USD 10k–200k)."""
    rng = np.random.default_rng(seed)
    taken = set(PLANT.values())
    first = _words(rng, 300, 3, 8, taken)
    last = _words(rng, 500, 4, 8, taken)
    dept = np.array(["Sale", "Design", "Research", "Finance", "Legal",
                     "Support", "Ops", "HR"])
    rows = np.empty((n, 5), dtype=object)
    rows[:, 0] = [f"E{i:07d}" for i in rng.permutation(n)]
    rows[:, 1] = first[rng.integers(0, len(first), n)]
    rows[:, 2] = last[rng.integers(0, len(last), n)]
    rows[:, 3] = [str(v) for v in rng.integers(100, 2001, n)]
    rows[:, 4] = dept[rng.integers(0, len(dept), n)]
    planted = rng.choice(n, ELL["Zorro"] + ELL["Quinn"], replace=False)
    rows[planted[:ELL["Zorro"]], 1] = "Zorro"
    rows[planted[ELL["Zorro"]:], 1] = "Quinn"
    return rows


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def rand_field(torch, gen, shape, dev):
    """Uniform [0, p) int32 with ~1/8 of the entries forced to p−1."""
    x = torch.randint(0, P, shape, generator=gen, dtype=torch.int32,
                      device=dev)
    hot = torch.rand(shape, generator=gen, device=dev) < 0.125
    return torch.where(hot, torch.full_like(x, P - 1), x)


def max_err(torch, x, y) -> int:
    if x.numel() == 0:
        return 0
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max())


def compare_small(torch, dev, errs) -> None:
    """Phase 2: kernels (through the ``ops`` wrappers the path calls) vs
    plain versions on extremes and ragged shapes."""
    from repro_torch.kernels import aa_match as aa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ss_matmul as ssm
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    cases = [((37, 1000), (1000, 300)), ((3, 5, 4097), (3, 4097, 129)),
             ((4, 7, 513), (513, 200)), ((2, 0, 64), (2, 64, 10)),
             ((2, 3, 64), (2, 64, 0)), ((2, 3, 300000), (2, 300000, 64)),
             ((1, 17, 131), (1, 131, 255))]
    for sa, sb in cases:
        a, b = rand_field(torch, gen, sa, dev), rand_field(torch, gen, sb, dev)
        got, want = ops.ss_matmul(a, b), ssm.ss_matmul_plain(a, b)
        torch.cuda.synchronize()
        check(got.shape == want.shape and torch.equal(got, want),
              f"ss_matmul {sa} @ {sb} differs from plain")
        errs["ss_matmul"] = max(errs["ss_matmul"], max_err(torch, got, want))
    full = torch.full((2, 9, 700), P - 1, dtype=torch.int32, device=dev)
    got = ops.ss_matmul(full, full[:, 0].T.contiguous())
    check(torch.equal(got, ssm.ss_matmul_plain(full,
                                               full[:, 0].T.contiguous())),
          "ss_matmul all-(p-1) differs")

    for (c, b, n, w, a) in [(3, 1, 1000, 8, 69), (2, 3, 77, 5, 33),
                            (4, 2, 33, 12, 69)]:
        col = rand_field(torch, gen, (c, b, n, w, a), dev)
        pat = rand_field(torch, gen, (c, b, w, a), dev)
        got = ops.aa_match_batch(col, pat)
        want = aa.aa_match_batch_plain(col, pat)
        check(torch.equal(got, want), f"aa_match_batch {col.shape} differs")
        errs["aa_match_batch"] = max(errs["aa_match_batch"],
                                     max_err(torch, got, want))
        one = col[:, :1].expand(c, b, n, w, a)          # B-stride 0
        check(torch.equal(ops.aa_match_batch(one, pat),
                          aa.aa_match_batch_plain(one, pat)),
              "aa_match_batch broadcast column differs")
    rel = rand_field(torch, gen, (3, 500, 4, 8, 69), dev)
    pat = rand_field(torch, gen, (3, 5, 8, 69), dev)
    blocks = dict(columns=[0, 3, 3, 1, 2], starts=[0, 17, 250, 499, 100],
                  lengths=[500, 40, 250, 1, 0])
    got = ops.aa_match_rows(rel, pat=pat, height=500, **blocks)
    want = aa.aa_match_rows_plain(rel, pat=pat, height=500, **blocks)
    check(torch.equal(got, want), "aa_match_rows differs")
    torch.cuda.synchronize()
    compare_ripple(torch, gen, dev, errs)
    compare_slide(torch, gen, dev, errs)
    compare_staging_edges(torch, gen, dev, errs)
    compare_tall(torch, gen, dev, errs)
    compare_onehot(torch, gen, dev, errs)
    compare_limb_edges(torch, gen, dev, errs)


def compare_limb_edges(torch, gen, dev, errs) -> None:
    """Both matmul kernels (called directly) vs ``ss_matmul_plain`` where
    their byte-limb arithmetic is tightest: all-(p−1) and all-(2³¹−1)
    operands at K = 2·K_CHUNK + 1 (three s32 chunks, the last of one term),
    and random operands at K = K_CHUNK − 1, K_CHUNK and K_CHUNK + 1, with
    M = 1, 9, 33 (tall) and 257 (general) and N = 70 (not a multiple of
    the 64-column tile)."""
    from repro_torch.kernels import ss_matmul as ssm
    tall = ("ss_matmul_tall", ssm.ss_matmul_tall_cuda)
    general = ("ss_matmul", ssm.ss_matmul_cuda)

    def same(name, fn, a, b, what):
        got, want = fn(a, b), ssm.ss_matmul_plain(a, b)
        torch.cuda.synchronize()
        check(got.shape == want.shape and torch.equal(got, want),
              f"{name} {what} differs from its plain version")
        errs[name] = max(errs[name], max_err(torch, got, want))

    k = 2 * ssm.K_CHUNK + 1
    for value in (P - 1, 2**31 - 1):
        for (name, fn), m in ((tall, 8), (general, 300)):
            a = torch.full((2, m, k), value, dtype=torch.int32, device=dev)
            b = torch.full((2, k, 70), value, dtype=torch.int32, device=dev)
            same(name, fn, a, b, f"all-{value} at K={k}")
    for k in (ssm.K_CHUNK - 1, ssm.K_CHUNK, ssm.K_CHUNK + 1):
        for (name, fn), m in ((tall, 1), (tall, 9), (tall, 33),
                              (general, 257)):
            a = rand_field(torch, gen, (2, m, k), dev)
            b = rand_field(torch, gen, (k, 70), dev)
            same(name, fn, a, b, f"M={m} K={k}")


def compare_slide(torch, gen, dev, errs) -> None:
    """``ops.aa_slide_batch`` / ``ops.aa_slide_rows`` vs the plain version:
    every tile length k = 1..W (M = 1 included), p−1 extremes, a ragged
    tuple count, a B-stride-0 column and relation rows with distinct
    columns."""
    from repro_torch.kernels import aa_match as aa
    from repro_torch.kernels import ops

    def same(got, want, what):
        torch.cuda.synchronize()
        check(got.shape == want.shape and torch.equal(got, want),
              f"{what} differs from its plain version")
        errs["aa_slide_batch"] = max(errs["aa_slide_batch"],
                                     max_err(torch, got, want))

    c, b, n, w, a = 3, 2, 1001, 8, 69
    col = rand_field(torch, gen, (c, b, n, w, a), dev)
    for k in range(1, w + 1):
        pat = rand_field(torch, gen, (c, b, k, a), dev)
        same(ops.aa_slide_batch(col, pat), aa.aa_slide_batch_plain(col, pat),
             f"aa_slide_batch k={k}")
        one = col[:, :1].expand(c, b, n, w, a)
        same(ops.aa_slide_batch(one, pat), aa.aa_slide_batch_plain(one, pat),
             f"aa_slide_batch B-stride-0 k={k}")
    full = torch.full((2, 1, 77, w, a), P - 1, dtype=torch.int32,
                      device=dev)
    tile = torch.full((2, 1, 3, a), P - 1, dtype=torch.int32, device=dev)
    same(ops.aa_slide_batch(full, tile), aa.aa_slide_batch_plain(full, tile),
         "aa_slide_batch all-(p-1)")
    rel = rand_field(torch, gen, (3, 500, 4, w, a), dev)
    pat = rand_field(torch, gen, (3, 5, 2, a), dev)
    blocks = dict(columns=[0, 3, 3, 1, 2], starts=[0, 17, 250, 499, 100],
                  lengths=[500, 40, 250, 1, 0])
    same(ops.aa_slide_rows(rel, pat=pat, height=500, **blocks),
         aa.aa_slide_rows_plain(rel, pat=pat, height=500, **blocks),
         "aa_slide_rows")


def compare_staging_edges(torch, gen, dev, errs) -> None:
    """The match and the slide (k = 2) vs their plain versions where the
    staging is tightest: all-(p−1) and all-(2³¹−1) operands at W = 8,
    A = 69; prefix views of k = 1 and 4 positions (rows of k·276 bytes,
    a partial last 16-byte copy); a (5, 33) row of 660 bytes at a pitch of
    168 words on the 16-byte route; zero-length and one-row blocks in the
    rows form; a B-stride-0 stack larger than one chunk of patterns; a
    slide whose tile rows take several passes (1,300 one-symbol positions,
    k = 1,173). Each stack is one launch."""
    from repro_torch.kernels import aa_match as aa
    from repro_torch.kernels import ops

    forms = {"aa_match_batch": (ops.aa_match_batch, aa.aa_match_batch_plain),
             "aa_slide_batch": (ops.aa_slide_batch, aa.aa_slide_batch_plain)}

    def same(col, pat_fn, what, route=16, chunks=None):
        for name, (fn, plain) in forms.items():
            w = col.shape[-2]
            k = w if name == "aa_match_batch" else min(2, w)
            pat = pat_fn(col.shape[:2] + (k, col.shape[-1]))
            pl = aa.batch_plan(col, 0 if name == "aa_match_batch" else k)
            check(pl.copy_bytes == route, f"{what}: {pl.copy_bytes}-byte "
                  f"copies, not {route}")
            check(chunks is None or len(pl.chunks) == chunks,
                  f"{what}: {len(pl.chunks)} chunks, not {chunks}")
            before = ops.launch_counts()[name]
            got, want = fn(col, pat), plain(col, pat)
            torch.cuda.synchronize()
            check(ops.launch_counts()[name] == before + 1,
                  f"{name} {what}: not one launch")
            check(got.shape == want.shape and torch.equal(got, want),
                  f"{name} {what} differs from its plain version")
            errs[name] = max(errs[name], max_err(torch, got, want))

    def rand(shape):
        return rand_field(torch, gen, shape, dev)

    for value in (P - 1, 2**31 - 1):
        col = torch.full((2, 1, 300, 8, 69), value, dtype=torch.int32,
                         device=dev)
        same(col, lambda sh: torch.full(sh, value, dtype=torch.int32,
                                        device=dev), f"all-{value}")
    rel = rand((3, 700, 5, 8, 69))
    for k in (1, 4):
        same(rel[..., :k, :][:, :, 2][:, None], rand, f"prefix k={k}")
    buf = rand((2, 3, 301, 168))
    same(buf[..., :165].unflatten(-1, (5, 33)), rand, "(5, 33) at pitch 168")
    cap = max(aa.tile_layout(8, 69, k, 10**6)[2] for k in (2, 8))
    same(rel[:, :, 1][:, None].expand(3, cap + 5, 700, 8, 69), rand,
         f"B-stride-0 stack of {cap + 5}", chunks=2)
    # 1,300 one-symbol positions against 1,173 tile rows: several passes
    long_words = rand((1, 2, 37, 1300, 1))
    tile = rand((1, 2, 1173, 1))
    check(aa.batch_plan(long_words, 1173).k_pass < 1173,
          "the 1,173-row tile did not split into passes")
    got = ops.aa_slide_batch(long_words, tile)
    want = aa.aa_slide_batch_plain(long_words, tile)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "aa_slide_batch in passes differs")
    errs["aa_slide_batch"] = max(errs["aa_slide_batch"],
                                 max_err(torch, got, want))
    for height, lengths in ((1, [0, 1, 0]), (64, [0, 0, 0]),
                            (700, [700, 1, 0])):
        blocks = dict(columns=[1, 1, 3], starts=[0, 699, 5], lengths=lengths,
                      height=height)
        for name, fn, plain, k in (
                ("aa_match_batch", ops.aa_match_rows, aa.aa_match_rows_plain,
                 8),
                ("aa_slide_batch", ops.aa_slide_rows, aa.aa_slide_rows_plain,
                 3)):
            pat = rand((3, 3, k, 69))
            got = fn(rel, pat=pat, **blocks)
            want = plain(rel, pat=pat, **blocks)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{name} rows form, lengths "
                  f"{lengths} at height {height}, differs")
            errs[name] = max(errs[name], max_err(torch, got, want))


def compare_tall(torch, gen, dev, errs) -> None:
    """``ops.ss_matmul`` on tall-skinny shapes (the tall kernel) vs
    ``ss_matmul_plain``: M = 1, 17, 255, 256, K not a multiple of the
    32-wide K chunk, N = 1, the (3, 2) and (3, 3) ranks."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ss_matmul as ssm
    cases = [((3, 1, 4099), (3, 4099, 129)), ((3, 17, 4099), (4099, 129)),
             ((2, 255, 8195), (2, 8195, 300)), ((2, 256, 8195), (8195, 1)),
             ((4, 3, 70001), (4, 70001, 1)), ((1, 69, 9000), (1, 9000, 1000))]
    for sa, sb in cases:
        check(ssm.is_tall_skinny(sa[-2], sa[-1], sb[-1]), f"{sa} not tall")
        a, b = rand_field(torch, gen, sa, dev), rand_field(torch, gen, sb, dev)
        before = ops.launch_counts()["ss_matmul_tall"]
        got, want = ops.ss_matmul(a, b), ssm.ss_matmul_plain(a, b)
        torch.cuda.synchronize()
        check(ops.launch_counts()["ss_matmul_tall"] == before + 1,
              f"{sa} @ {sb} did not take the tall kernel")
        check(got.shape == want.shape and torch.equal(got, want),
              f"ss_matmul_tall {sa} @ {sb} differs from plain")
        errs["ss_matmul_tall"] = max(errs["ss_matmul_tall"],
                                     max_err(torch, got, want))
    full = torch.full((2, 256, 3000), P - 1, dtype=torch.int32, device=dev)
    other = torch.full((2, 3000, 40), P - 1, dtype=torch.int32, device=dev)
    check(torch.equal(ssm.ss_matmul_tall_cuda(full, other),
                      ssm.ss_matmul_plain(full, other)),
          "ss_matmul_tall all-(p-1) differs")


def compare_onehot(torch, gen, dev, errs) -> None:
    """``ops.share_onehot`` vs ``share_onehot_plain``: M = 1, 17, 256, 300,
    V = 1, 1,000 to 1,003 (every V % 4, so M·V % 4 takes every value),
    151,936 and 256,206, c = 1, 4, 20; tokens at 0, V−1, repeated and −1,
    and from M = 17 also V, −5 and 2³¹ + 3; a1 with p−1 extremes and as a
    strided view; each call one launch on the route ``onehot_plan`` names
    (quad where M·V % 4 == 0, word for the rest and the views). Then the
    embedding lookup's shard contraction on the tall kernel at S = 3 over
    151,936 ids, whose second and third vocab slices start at offsets that
    are not a multiple of 4 (the kernel's 4-byte copy route)."""
    from repro_torch.core.partition import split_bounds
    from repro_torch.kernels import ops
    from repro_torch.kernels import ss_matmul as ssm

    def same(toks, a1, c, what):
        before = ops.onehot_route_counts()
        got = ops.share_onehot(toks, a1, n_shares=c)
        want = ssm.share_onehot_plain(toks, a1, n_shares=c)
        torch.cuda.synchronize()
        check(got.shape == want.shape and torch.equal(got, want),
              f"{what} differs from its plain version")
        errs["share_onehot"] = max(errs["share_onehot"],
                                   max_err(torch, got, want))
        route = ssm.onehot_plan(a1.data_ptr(), got.data_ptr(), a1.stride(),
                                *a1.shape)
        after = ops.onehot_route_counts()
        check(after[route] == before[route] + 1
              and sum(after.values()) == sum(before.values()) + 1,
              f"{what}: one launch on the {route} route wanted, routes "
              f"went {before} -> {after}")

    for m in (1, 17, 256, 300):
        for v in (1, 1000, 1001, 1002, 1003, QWEN_VOCAB, SEAMLESS_VOCAB):
            toks = torch.randint(0, v, (m,), generator=gen, device=dev)
            if m >= 4:
                toks[:4] = torch.tensor([0, v - 1, int(toks[m - 1]), -1])
            if m >= 17:
                toks[4:7] = torch.tensor([v, -5, 2**31 + 3])
            a1 = rand_field(torch, gen, (m, v), dev)
            for c in (1, 4, 20):
                same(toks, a1, c, f"share_onehot M={m} V={v} c={c}")
    wide = rand_field(torch, gen, (6, 1030), dev)
    for view in (wide[:, 3:1027], wide[::2, 1:9]):
        toks = torch.arange(view.shape[0], device=dev) * 3
        same(toks, view, 4, "share_onehot strided a1")

    stacked = rand_field(torch, gen, (4, 8, QWEN_VOCAB), dev)
    table = rand_field(torch, gen, (4, QWEN_VOCAB, 64), dev)
    for lo, hi in split_bounds(0, QWEN_VOCAB, 3):
        a, b = stacked[:, :, lo:hi], table[:, lo:hi]
        before = ops.launch_counts()["ss_matmul_tall"]
        got, want = ops.ss_matmul(a, b), ssm.ss_matmul_plain(a, b)
        torch.cuda.synchronize()
        check(ops.launch_counts()["ss_matmul_tall"] == before + 1,
              f"vocab shard [{lo}, {hi}) did not take the tall kernel")
        check(torch.equal(got, want),
              f"ss_matmul_tall vocab shard [{lo}, {hi}) differs")
        errs["ss_matmul_tall"] = max(errs["ss_matmul_tall"],
                                     max_err(torch, got, want))


def _ripple_name(k: int) -> str:
    return "ripple_carry" if k == 1 else "ripple_segment"


def same_ripple(torch, got, want, k, errs, what) -> None:
    """Kernel (rb, carry') against the plain version's, bit for bit."""
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        check(g.shape == w.shape and torch.equal(g, w),
              f"{what} differs from ripple_segment_plain")
        errs[_ripple_name(k)] = max(errs[_ripple_name(k)],
                                    max_err(torch, g, w))


def compare_ripple(torch, gen, dev, errs) -> None:
    """The ripple kernel through ``ops.ripple_segment`` / ``ops.ripple_carry``
    vs ``ripple_segment_plain``: k = 1..13, LSB (init) and carried steps,
    p−1 extremes, 15,405 lanes (not a multiple of the 256-thread block),
    and the strided views the range engine and the tournament pass."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ripple as rip
    lanes = (3, 5, 1027)
    for k in (1, 2, 5, 8, 13):
        for init in (True, False):
            a = rand_field(torch, gen, lanes + (k,), dev)
            b = rand_field(torch, gen, lanes + (k,), dev)
            carry = None if init else rand_field(torch, gen, lanes, dev)
            same_ripple(torch, ops.ripple_segment(a, b, carry),
                        rip.ripple_segment_plain(a, b, carry), k, errs,
                        f"ripple k={k} init={init}")
    a, b = rand_field(torch, gen, lanes, dev), rand_field(torch, gen, lanes,
                                                           dev)
    same_ripple(torch, ops.ripple_carry(a, b, b),
                rip.ripple_segment_plain(a[..., None], b[..., None], b), 1,
                errs, "ripple_carry 1-D form")
    for fill in (0, 1, P - 1):
        a = torch.full(lanes + (5,), fill, dtype=torch.int32, device=dev)
        b = torch.full_like(a, P - 1 - fill)
        carry = torch.full(lanes, P - 1, dtype=torch.int32, device=dev)
        same_ripple(torch, ops.ripple_segment(a, b, carry),
                    rip.ripple_segment_plain(a, b, carry), 5, errs,
                    f"ripple all-{fill}")
    # a shard's segment slice lhs[:, :, lo:hi, s0:s1] with its carry slice
    full = rand_field(torch, gen, (3, 4, 600, 13), dev)
    other = rand_field(torch, gen, (3, 4, 600, 13), dev)
    carry = rand_field(torch, gen, (3, 4, 700), dev)[:, :, 100:400]
    a, b = full[:, :, 77:377, 8:13], other[:, :, 77:377, 8:13]
    same_ripple(torch, ops.ripple_segment(a, b, carry),
                rip.ripple_segment_plain(a, b, carry), 5, errs,
                "ripple shard/segment slice")
    # a binary column broadcast across B (B-stride 0) and a tournament
    # level's every-other-tuple view (tuple stride 2t)
    col = rand_field(torch, gen, (3, 600, 8), dev)[:, None].expand(
        3, 2, 600, 8)
    same_ripple(torch, ops.ripple_segment(col, other[:, :2, :, :8]),
                rip.ripple_segment_plain(col, other[:, :2, :, :8]), 8, errs,
                "ripple B-stride-0 column")
    x1, x2 = full[:, :, 0:600:2, :8], full[:, :, 1:600:2, :8]
    same_ripple(torch, ops.ripple_segment(x1, x2),
                rip.ripple_segment_plain(x1, x2), 8, errs,
                "ripple tournament pair view")
    compare_ripple_routes(torch, gen, dev, errs)


def compare_ripple_routes(torch, gen, dev, errs) -> None:
    """Both of the ripple kernel's routes at k = 1..13, LSB and carried
    (carry rows 16-byte aligned and not), at the bit offset 13 − k over
    1,027 lanes a row (a ragged 4-lane tail): bit-major operands
    (``ripple.bit_major``) on the bit-major route, interleaved ones on the
    strided route; then bit-major shard slices at 16- and 4-byte offsets
    (bit-major, strided), the tournament's operands from
    ``ripple.bit_major_where`` and one-lane rows. Each call must take the
    route named."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ripple as rip

    def on(route, a, b, carry):
        before = ops.ripple_route_counts()[route]
        got = rip.ripple_segment_cuda(a, b, carry)
        check(ops.ripple_route_counts()[route] == before + 1,
              f"ripple {route} case took another route")
        same_ripple(torch, got, rip.ripple_segment_plain(a, b, carry),
                    a.shape[-1], errs, f"ripple {route} route k="
                    f"{a.shape[-1]}")

    src = [rand_field(torch, gen, (3, 2, 1027, 13), dev) for _ in range(3)]
    bm, inter = rip.bit_major(src, dim=1), torch.cat(src, dim=1)
    carries = [None, rand_field(torch, gen, (3, 4, 1028), dev)[..., :1027],
               rand_field(torch, gen, (3, 4, 1027), dev)]
    for k in range(1, 14):
        for carry in carries:
            for route, rows in (("bit_major", bm), ("strided", inter)):
                on(route, rows[:, :4, :, 13 - k:], rows[:, 2:, :, 13 - k:],
                   carry)
    full = rip.bit_major([rand_field(torch, gen, (3, 2, 600, 13), dev)], 1)
    carry = rand_field(torch, gen, (3, 2, 700), dev)
    for lo, route in ((4, "bit_major"), (77, "strided")):
        on(route, full[:, :, lo:lo + 300, 8:13], full[:, :, lo:lo + 300, :5],
           carry[..., lo:lo + 300])
    is_min = torch.tensor([True, False], device=dev)[None, :, None, None]
    x1, x2 = full[:, :, 0:598:2], full[:, :, 1:598:2]      # 299 pairs
    on("bit_major", rip.bit_major_where(is_min, x1, x2)[..., :8],
       rip.bit_major_where(is_min, x2, x1)[..., :8], None)
    for lanes in (1, 2, 3, 5):
        a = rip.bit_major([rand_field(torch, gen, (3, 2, lanes, 13), dev)], 1)
        on("bit_major", a[..., :5], a[..., 8:], rand_field(
            torch, gen, (3, 2, lanes), dev))


#: kernels each path runs (its launch counters must rise during it). Every
#: fetch, one_tuple and conditional-SUM contraction of slices 1 and 2 is
#: tall-skinny (M <= 256 rows); the general ss_matmul runs on slice 3's
#: ℓ = 1,000 fetch.
SLICE1_KERNELS = ("aa_match_batch", "ss_matmul_tall")
SLICE2_KERNELS = ("aa_match_batch", "ss_matmul_tall", "ripple_segment",
                  "ripple_carry")
SLICE3_KERNELS = ("aa_match_batch", "aa_slide_batch", "ss_matmul_tall",
                  "ss_matmul")
SALARY_BITS = 13        # SUM needs n·2^(t−1) < 2^30 at n = 131,072
#: slice 4 runs at the embedding width of Qwen1.5-4B (vocab_size, d_model of
#: src/repro/configs/qwen1_5_4b.py) with the reference's default sharing:
#: c = 4 clouds, table degree 1 (lookups open at degree 2; verify needs 4).
QWEN_VOCAB, QWEN_DIM, EMBED_SHARES = 151936, 2560, 4
SLICE4_KERNELS = ("share_onehot", "ss_matmul_tall")


def check_launches(torch, ops, path: str, kernels, timings):
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"{path} launches {launches}; host seconds "
        + json.dumps({k: round(v, 4) for k, v in timings.items()}))
    for name in kernels:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {path}")
    check_onehot_quad(ops, path)
    return launches


def check_onehot_quad(ops, path: str) -> dict:
    """Every ``share_onehot`` launch since the last reset took the quad
    route (every main-path lookup has M·V % 4 == 0 and a fresh a1)."""
    routes = ops.onehot_route_counts()
    n = ops.launch_counts()["share_onehot"]
    check(routes == {"quad": n, "word": 0},
          f"{path}: share_onehot launched {n} times, by route {routes}; "
          f"every main-path lookup takes the quad route")
    if n:
        log(f"{path} share_onehot routes {routes}")
    return routes


#: slice 12: the cost walker (``launch.hlo_cost``) against real steps of
#: the main paths. Each priced step's record, in run order; a walked step
#: may take at most SLICE12_SLACK x its measured time at the roofline.
SLICE12 = []
SLICE12_SLACK = 1.05


def price_step(torch, label, fn, kernels=()):
    """Slice 12: ``fn``, one step of a main path on objects its slice
    built, once untimed, once timed with CUDA events (the peak device
    memory above what is allocated before it), and once under the cost
    walker (ops on the host left to it). Logs the walker's flops by
    class, bytes, link bytes, roofline terms and bound, the measured ms,
    measured over roofline, and the walker's predicted peak beside the
    measured one. Fails unless no op is unpriced, the walker priced each
    of ``kernels`` (the step's hand-written kernels) and the roofline
    time is at most SLICE12_SLACK x the measured time."""
    from repro_torch.launch import hlo_cost

    t0 = time.perf_counter()
    fn()                                          # untimed
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop)
    measured_peak = torch.cuda.max_memory_allocated() - base
    with hlo_cost.CostMode(device="cuda") as mode:
        fn()
    torch.cuda.synchronize()
    cost = mode.cost
    roof = cost.roofline()
    bound_ms = roof.t_bound * 1e3
    rec = {"step": label, "measured_ms": ms, "roofline_ms": bound_ms,
           "bound_by": roof.bottleneck,
           "measured_over_roofline": ms / bound_ms if bound_ms else None,
           "t_compute_ms": roof.t_compute * 1e3,
           "t_memory_ms": roof.t_memory * 1e3,
           "t_collective_ms": roof.t_collective * 1e3,
           "flops_by_class": cost.flops_by_class, "hbm_bytes": cost.hbm_bytes,
           "link_bytes": cost.collectives, "kernels": cost.kernels,
           "aten_ops": cost.ops, "host_ops": cost.host_ops,
           "unpriced": cost.unpriced,
           "predicted_peak_gb": cost.peak_bytes / 1e9,
           "measured_peak_gb": measured_peak / 1e9,
           "argument_gb": cost.arg_bytes / 1e9,
           "seconds": time.perf_counter() - t0}
    SLICE12.append(rec)
    log(f"slice-12 {label}: " + json.dumps(rec))
    check(not cost.unpriced, f"slice 12 {label}: unpriced ops "
          f"{cost.unpriced}")
    for name in kernels:
        check(cost.kernels.get(name, 0) > 0,
              f"slice 12 {label}: the walker priced no {name}")
    check(bound_ms <= SLICE12_SLACK * ms,
          f"slice 12 {label}: the roofline time {bound_ms} ms is over "
          f"{SLICE12_SLACK} x the measured {ms} ms")
    return rec


def main_path(torch, args, expect_strategy):
    """Phase 3, slice 1: outsourcing, count and selection at full size
    through the public entry points."""
    from repro_torch.api import Count, Eq, Padding, QueryClient, Select
    from repro_torch.core import Codec, outsource
    from repro_torch.kernels import ops

    rows = make_rows(args.tuples, args.seed)
    pick = np.random.default_rng(args.seed + 1)
    ids = rows[pick.choice(args.tuples, 2, replace=False), 0]
    salaries, mult = np.unique(rows[:, 3].astype(str), return_counts=True)
    salary = str(salaries[np.argmax(mult >= 3)])       # a small ℓ >= 3

    def truth(col, pat):
        return [int(i) for i in np.nonzero(rows[:, NAMES.index(col)]
                                           == pat)[0]]

    def check_rows(res, col, pat, tag):
        addrs = truth(col, pat)
        check(res.count == len(addrs), f"{tag}: count {res.count} != "
              f"{len(addrs)}")
        if res.rows is not None:
            want = [list(rows[a]) for a in addrs]
            check(sorted(res.rows) == sorted(want), f"{tag}: rows differ")
        if res.addresses is not None:
            check(res.addresses == addrs, f"{tag}: addresses differ")

    ops.reset_launch_counts()
    timings = {}
    t0 = time.perf_counter()
    db = outsource(rows.tolist(), n_shares=20, column_names=NAMES,
                   codec=Codec(word_length=8), degree=1, seed=args.seed,
                   numeric_columns={NAMES.index("Salary"): SALARY_BITS})
    torch.cuda.synchronize()
    timings["outsource_s"] = time.perf_counter() - t0
    rel = db.relation.values
    log(f"outsourced {tuple(rel.shape)} int32 shares "
        f"({rel.numel() * 4 / 1e9:.1f} GB) in {timings['outsource_s']:.1f} s")
    client = QueryClient(db, seed=args.seed)

    def timed(tag, fn):
        t = time.perf_counter()
        res = fn()
        timings[tag] = time.perf_counter() - t
        return res

    res = timed("count", lambda: client.count("FirstName", "Quinn"))
    check_rows(res, "FirstName", "Quinn", "count")
    res = timed("one_tuple", lambda: client.select(
        "EmployeeId", ids[0], strategy="one_tuple"))
    check(res.strategy == "one_tuple", "one_tuple strategy")
    check_rows(res, "EmployeeId", ids[0], "one_tuple")
    res = timed("one_round", lambda: client.select(
        "FirstName", "Zorro", strategy="one_round"))
    check_rows(res, "FirstName", "Zorro", "one_round")
    res = timed("tree", lambda: client.select("FirstName", "Quinn",
                                              strategy="tree"))
    check_rows(res, "FirstName", "Quinn", "tree")
    res = timed("auto", lambda: client.select("FirstName", "Zorro"))
    check(res.strategy == expect_strategy(client, None),
          f"auto chose {res.strategy}")
    check_rows(res, "FirstName", "Zorro", "auto")

    plans = [Count(Eq("FirstName", "Quinn")),
             Count(Eq("Department", "Legal")),
             Select(Eq("EmployeeId", ids[1]), strategy="one_tuple"),
             Select(Eq("FirstName", "Zorro"), strategy="one_round"),
             Select(Eq("FirstName", PLANT["absent"]), strategy="one_round"),
             Select(Eq("Salary", salary), strategy="tree"),
             Select(Eq("FirstName", "Quinn"), strategy="tree",
                    padding=Padding.to_rows(20)),
             Select(Eq("EmployeeId", ids[0]), expected_matches=1)]
    outs = timed("run_batch_8", lambda: client.run_batch(plans))
    for i, (plan, res) in enumerate(zip(plans, outs)):
        check_rows(res, plan.where.column, plan.where.pattern, f"batch[{i}]")
    check(outs[7].strategy == "one_tuple", "batch AUTO ℓ=1 -> one_tuple")
    launches = check_launches(torch, ops, "slice-1 path", SLICE1_KERNELS,
                              timings)
    return db, client, rows, launches


def range_agg_path(torch, client, rows):
    """Phase 3, slice 2: range count/selection and SUM/AVG/MIN/MAX at full
    size through the same client, against numpy on the rows."""
    from repro_torch.api import (Aggregate, Between, Count, Eq, RangeCount,
                                 RangeSelect)
    from repro_torch.kernels import ops

    salary = rows[:, NAMES.index("Salary")].astype(np.int64)
    legal = rows[:, NAMES.index("Department")] == "Legal"
    vals, mult = np.unique(salary, return_counts=True)
    planted = int(vals[np.argmax(np.where(mult <= 150, mult, 0))])

    def in_range(lo, hi):
        return [int(i) for i in np.nonzero((salary >= lo)
                                           & (salary <= hi))[0]]

    def check_range(res, lo, hi, tag):
        addrs = in_range(lo, hi)
        check(res.count == len(addrs), f"{tag}: count {res.count} != "
              f"{len(addrs)}")
        if res.addresses is not None:
            check(res.addresses == addrs, f"{tag}: addresses differ")
            check(res.rows == [list(rows[a]) for a in addrs],
                  f"{tag}: rows differ")

    def check_agg(res, op, where_legal, tag):
        sel = salary[legal] if where_legal else salary
        want = {"sum": int(sel.sum()), "avg": float(sel.mean()),
                "min": int(sel.min()), "max": int(sel.max())}[op]
        ok = (abs(res.value - want) <= 1e-9 * abs(want) if op == "avg"
              else res.value == want)
        check(ok, f"{tag}: {op} {res.value} != {want}")
        if where_legal and op != "sum":
            check(res.count == int(legal.sum()), f"{tag}: count differs")

    timings, peaks = {}, {}

    def timed(tag, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        timings[tag] = time.perf_counter() - t
        peaks[tag] = (torch.cuda.max_memory_allocated() - base) / 1e9
        return res

    ops.reset_launch_counts()
    res = timed("range_count_r8", lambda: client.range_count(
        "Salary", 500, 1500, reduce_every=8))
    check_range(res, 500, 1500, "range_count r8")
    res = timed("range_select", lambda: client.range_select(
        "Salary", planted, planted, reduce_every=8))
    check_range(res, planted, planted, "range_select")
    res = timed("range_count_r1", lambda: client.range_count(
        "Salary", 500, 1500, reduce_every=1))
    check_range(res, 500, 1500, "range_count r1")
    res = timed("sum", lambda: client.aggregate("sum", "Salary"))
    check_agg(res, "sum", False, "sum")
    res = timed("avg_legal", lambda: client.aggregate(
        "avg", "Salary", where=Eq("Department", "Legal")))
    check_agg(res, "avg", True, "avg")
    res = timed("min", lambda: client.aggregate("min", "Salary",
                                                reduce_every=8))
    check_agg(res, "min", False, "min")
    res = timed("max_legal_verify", lambda: client.aggregate(
        "max", "Salary", where=Eq("Department", "Legal"), verify=True,
        reduce_every=8))
    check_agg(res, "max", True, "max verified")
    plans = [RangeCount(Between("Salary", 700, 900), reduce_every=8),
             RangeSelect(Between("Salary", planted, planted),
                         reduce_every=8),
             Aggregate("sum", "Salary", where=Eq("Department", "Legal")),
             Aggregate("min", "Salary", where=Eq("Department", "Legal"),
                       reduce_every=8),
             Aggregate("avg", "Salary"),
             Count(Eq("Department", "Legal"))]
    outs = timed("run_batch_6", lambda: client.run_batch(plans))
    check_range(outs[0], 700, 900, "batch range_count")
    check_range(outs[1], planted, planted, "batch range_select")
    check_agg(outs[2], "sum", True, "batch sum")
    check_agg(outs[3], "min", True, "batch min")
    check_agg(outs[4], "avg", False, "batch avg")
    check(outs[5].count == int(legal.sum()), "batch count differs")
    log(f"slice-2 peak device memory above the relation, GB: "
        + json.dumps({k: round(v, 3) for k, v in peaks.items()}))
    routes = ops.ripple_route_counts()
    log(f"slice-2 ripple launches by route {json.dumps(routes)}")
    check(routes["strided"] == 0,
          "a slice-2 ripple launch missed the bit-major route")
    return check_launches(torch, ops, "slice-2 path", SLICE2_KERNELS,
                          timings)


def like_oracle(word: str, pattern: str, w: int = 8) -> bool:
    """Plaintext LIKE as the engine defines it (``_`` also matches past
    the end of the word; ``%`` only at the ends)."""
    lead, trail = pattern.startswith("%"), pattern.endswith("%")
    body = pattern[1 if lead else 0:len(pattern) - 1 if trail else None]
    if lead and trail:
        return body in word
    if lead:
        return word.endswith(body)
    padded = word + "\0" * w
    ok = all(ch == "_" or padded[i] == ch for i, ch in enumerate(body))
    return ok if trail else ok and all(padded[i] == "\0"
                                       for i in range(len(body), w))


def pattern_path(torch, client, rows):
    """Phase 3, slice 3: LIKE / prefix / suffix / substring counts and
    selects at full size through the same client, against the plaintext
    rows."""
    from repro_torch.api import (AUTO, Contains, Count, Eq, Like, Prefix,
                                 RangeCount, Select, Suffix, Between,
                                 choose_pattern_strategy)
    from repro_torch.core.encoding import PatternSpec
    from repro_torch.kernels import ops

    def source(where):
        for cls, fmt in ((Prefix, "{}%"), (Suffix, "%{}"),
                         (Contains, "%{}%")):
            if isinstance(where, cls):
                return fmt.format(where.literal)
        return where.pattern

    def truth(where):
        col = rows[:, NAMES.index(where.column)]
        pat = source(where)
        return [i for i, word in enumerate(col) if like_oracle(word, pat)]

    def check_res(res, where, tag):
        addrs = truth(where)
        check(res.count == len(addrs), f"{tag}: count {res.count} != "
              f"{len(addrs)}")
        if res.addresses is not None:
            check(res.addresses == addrs, f"{tag}: addresses differ")
            check(res.rows == [list(rows[a]) for a in addrs],
                  f"{tag}: rows differ")

    timings, peaks = {}, {}

    def timed(tag, plan):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        res = client.run_batch(plan) if isinstance(plan, list) \
            else client.run(plan)
        torch.cuda.synchronize()
        timings[tag] = time.perf_counter() - t
        peaks[tag] = (torch.cuda.max_memory_allocated() - base) / 1e9
        return res

    counts = {"count_masked": Like("FirstName", "Zo_ro"),
              "count_prefix": Like("FirstName", "Qu%"),
              "count_suffix": Suffix("FirstName", "nn"),
              "count_contains": Contains("FirstName", "inn")}
    # at 131,072 tuples: ℓ = 4, 13 and 1,000 (the last takes the general
    # ss_matmul kernel, M > 256; it is 1,000 from 2,000 tuples up)
    selects = {"select_masked": Like("EmployeeId", "E01_0000"),
               "select_suffix": Suffix("EmployeeId", "7777"),
               "select_prefix_1000": Like("EmployeeId", "E0001%")}
    ops.reset_launch_counts()
    for tag, where in counts.items():
        check_res(timed(tag, Count(where)), where, tag)
    res = timed("count_like_exact", Count(Like("FirstName", "Quinn")))
    check_res(res, Eq("FirstName", "Quinn"), "count_like_exact")
    eq = client.run(Count(Eq("FirstName", "Quinn")))
    check(res.ledger.as_dict() == eq.ledger.as_dict(),
          "a wildcard-free LIKE did not take the Eq path")
    for tag, where in selects.items():
        res = timed(tag, Select(where, strategy="one_round"))
        check(res.strategy == "one_round", f"{tag}: {res.strategy}")
        check_res(res, where, tag)
    where = Contains("EmployeeId", "12345")                # ℓ = 12
    res = timed("select_tree_contains", Select(where, strategy="tree"))
    check(res.strategy == "tree", f"tree select ran {res.strategy}")
    check_res(res, where, "select_tree_contains")
    tail = str(rows[0, NAMES.index("LastName")])[-3:]
    where = Suffix("LastName", tail)
    res = timed("select_auto", Select(where, strategy=AUTO))
    want = choose_pattern_strategy(client.stats(), PatternSpec(
        "suffix", tail), ell=None).strategy
    check(res.strategy == want, f"auto chose {res.strategy}, not {want}")
    check_res(res, where, "select_auto")
    log(f"slice-3 AUTO select {where}: ℓ = {res.count}, {res.strategy}")
    plans = [Count(Like("FirstName", "Zo_ro")),
             Count(Contains("LastName", "inn")),
             Count(Suffix("Department", "gal")),
             Count(Eq("Department", "Legal")),
             RangeCount(Between("Salary", 700, 900), reduce_every=8),
             Select(Like("EmployeeId", "E01_0000"), strategy="one_round"),
             Select(Suffix("EmployeeId", "7777"), strategy="tree"),
             Select(Prefix("FirstName", "Quin"), strategy=AUTO)]
    outs = timed("run_batch_8", plans)
    salary = rows[:, NAMES.index("Salary")].astype(np.int64)
    for i, (plan, res) in enumerate(zip(plans, outs)):
        if isinstance(plan, RangeCount):
            check(res.count == int(((salary >= 700) & (salary <= 900))
                                   .sum()), "batch range count differs")
        else:
            check_res(res, plan.where, f"batch[{i}]")
    log("slice-3 counts: " + json.dumps(
        {tag: len(truth(wh)) for tag, wh in {**counts, **selects}.items()}))
    log("slice-3 peak device memory above the relation, GB: "
        + json.dumps({k: round(v, 3) for k, v in peaks.items()}))
    return check_launches(torch, ops, "slice-3 path", SLICE3_KERNELS,
                          timings)


#: slice 5's right relations, synthetic from ``--seed`` beside the Employee
#: relation: an HR / payroll system's month of project assignments joined
#: against the employee master (PK/FK), and a visitor log joined on first
#: names (an equijoin: values repeat on both sides).
ASSIGN_NAMES = ["EmployeeId", "Project", "Hours"]
VISIT_NAMES = ["FirstName", "City"]
N_ASSIGN, N_DANGLING, N_VISIT = 1024, 24, 512
VISIT_COMMON = {"Zorro": 2, "Quinn": 3}             # ℓy beside ELL's ℓx
EQUI_FAKE = 2
SLICE5_KERNELS = ("ss_matmul", "ss_matmul_tall")


def make_assignments(rows: np.ndarray, seed: int) -> np.ndarray:
    """(1,024, 3) str array: 1,000 rows carry EmployeeIds drawn from
    ``rows`` with repeats (an employee may hold several assignments), 24
    carry ids the relation lacks (dangling children), shuffled."""
    rng = np.random.default_rng(seed + 5)
    n = len(rows)
    out = np.empty((N_ASSIGN, 3), dtype=object)
    out[:, 0] = np.concatenate([
        rows[rng.integers(0, n, N_ASSIGN - N_DANGLING), 0],
        [f"E{n + i:07d}" for i in range(N_DANGLING)]])
    out[:, 1] = [f"P{v:05d}" for v in rng.integers(0, 400, N_ASSIGN)]
    out[:, 2] = [str(v) for v in rng.integers(1, 200, N_ASSIGN)]
    return out[rng.permutation(N_ASSIGN)]


def make_visitors(rows: np.ndarray, seed: int) -> np.ndarray:
    """(512, 2) str array: FirstName Zorro twice and Quinn three times, the
    other 507 names drawn (with repeats) from words the relation's
    FirstName column lacks, so exactly k = 2 values are common."""
    rng = np.random.default_rng(seed + 6)
    names = _words(rng, 200, 3, 8, set(rows[:, NAMES.index("FirstName")]))
    cities = np.array(["Paris", "Lima", "Oslo", "Quito", "Accra", "Hanoi",
                       "Perth", "Dakar"])
    first = list(names[rng.integers(0, len(names),
                                    N_VISIT - sum(VISIT_COMMON.values()))])
    for word, k in VISIT_COMMON.items():
        first += [word] * k
    out = np.empty((N_VISIT, 2), dtype=object)
    out[:, 0] = first
    out[:, 1] = cities[rng.integers(0, len(cities), N_VISIT)]
    return out[rng.permutation(N_VISIT)]


def device_split(torch, fn) -> dict:
    """Device ms of one more run of ``fn`` under ``torch.profiler``, by
    kernel: the ss_matmul kernels (matmul body and K-split reduce) and
    every other kernel (PyTorch's: the chain's modular products, the
    transposing copies, sharing, interpolation), with the three slowest
    of those by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    mm, other = 0.0, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if not us:
            continue
        if "ss_matmul" in e.key:
            mm += us / 1e3
        else:
            other[e.key[:60]] = other.get(e.key[:60], 0.0) + us / 1e3
    top = sorted(other.items(), key=lambda kv: -kv[1])[:3]
    return {"ss_matmul_ms": round(mm, 3),
            "other_ms": round(sum(other.values()), 3),
            "slowest_other": [(k, round(v, 3)) for k, v in top]}


def join_path(torch, args, db, rows):
    """Phase 3, slice 5: PK/FK joins and the equijoin at full size through
    the public entry points, the Employee relation as the join's left
    side. Every call is checked against a plaintext join of the rows.
    Returns (launches, assignment DB)."""
    from repro_torch.api import Count, Eq, Join, Padding, QueryClient, Select
    from repro_torch.core import Codec, ShardedRelation, outsource
    from repro_torch.kernels import ops
    from repro_torch.kernels import ss_matmul as ssm

    assign, visit = make_assignments(rows, args.seed), make_visitors(
        rows, args.seed)
    by_id = {r[0]: list(r) for r in rows}
    want_pkfk = [by_id[a[0]] + list(a[1:]) for a in assign if a[0] in by_id]
    first = NAMES.index("FirstName")
    want_equi = sorted(tuple(list(x) + [v[1]]) for v in visit
                       for x in rows[rows[:, first] == v[0]])
    check(len(want_pkfk) == N_ASSIGN - N_DANGLING and len(want_equi) == sum(
        ELL[w] * k for w, k in VISIT_COMMON.items()), "slice-5 data")
    timings, peaks, calls, top = {}, {}, {}, [0]
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()

    def timed(tag, fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        timings[tag] = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        peaks[tag] = (peak - base) / 1e9
        top[0] = max(top[0], peak)
        after = ops.launch_counts()
        calls[tag] = {k: after[k] - before[k] for k in after
                      if after[k] != before[k]}
        return res

    ops.reset_launch_counts()
    codec = Codec(word_length=8)
    assign_db = timed("outsource_assignment", lambda: outsource(
        assign.tolist(), n_shares=20, column_names=ASSIGN_NAMES, codec=codec,
        degree=1, seed=args.seed + 5))
    visit_db = timed("outsource_visitor", lambda: outsource(
        visit.tolist(), n_shares=20, column_names=VISIT_NAMES, codec=codec,
        degree=1, seed=args.seed + 6))
    client = QueryClient(db, seed=args.seed + 7)
    on = ("EmployeeId", "EmployeeId")

    def pkfk(method, cl=client):
        return cl.run(Join(right=assign_db, on=on, match_method=method))

    chain = timed("pkfk_chain", lambda: pkfk("chain"))
    check(chain.strategy == "pkfk" and chain.rows == want_pkfk,
          "pkfk chain: rows differ from the plaintext join")
    check(calls["pkfk_chain"] == {"ss_matmul": 9}, "pkfk chain launched "
          f"{calls['pkfk_chain']}, not 8 match + 1 fetch general ss_matmul")
    for method in ("aggregate", "auto"):
        res = timed(f"pkfk_{method}", lambda: pkfk(method))
        check(res.rows == chain.rows and res.ledger.as_dict()
              == chain.ledger.as_dict(), f"pkfk {method} differs from chain")
        check(calls[f"pkfk_{method}"] == {"ss_matmul": 2},
              f"pkfk {method} launched {calls[f'pkfk_{method}']}")
    plans = [Join(right=assign_db, on=on, match_method="auto"),
             Select(Eq("FirstName", "Zorro"), strategy="one_round"),
             Count(Eq("FirstName", "Quinn"))]
    outs = timed("run_batch_3", lambda: client.run_batch(plans))
    check(outs[0].rows == chain.rows and outs[0].ledger.as_dict()
          == chain.ledger.as_dict(), "batched join differs from the solo one")
    zorro = sorted(list(r) for r in rows[rows[:, first] == "Zorro"])
    check(sorted(outs[1].rows) == zorro, "batched select rows differ")
    check(outs[2].count == ELL["Quinn"], "batched count differs")
    check(calls["run_batch_3"].get("ss_matmul") == 2
          and "ss_matmul_tall" not in calls["run_batch_3"],
          "the batch's 1,024 match rows and 3 select rows did not share one "
          f"general fetch: {calls['run_batch_3']}")
    two = QueryClient(ShardedRelation(db, shards=2), seed=args.seed + 7)
    res = timed("pkfk_chain_s2", lambda: pkfk("chain", two))
    check(res.rows == chain.rows and res.ledger.as_dict()
          == chain.ledger.as_dict(), "pkfk at S = 2 differs from S = 1")
    check(calls["pkfk_chain_s2"] == {"ss_matmul": 18},
          f"pkfk at S = 2 launched {calls['pkfk_chain_s2']}")
    del res, outs

    def equi():
        return client.join(visit_db, on=("FirstName", "FirstName"),
                           kind="equi", padding=Padding.fake_values(EQUI_FAKE))

    res = timed("equijoin", equi)
    check(sorted(map(tuple, res.rows)) == want_equi,
          "equijoin: rows differ from the plaintext join")
    want_rounds = 1 + 2 * (len(VISIT_COMMON) + EQUI_FAKE)
    check(res.ledger.rounds == want_rounds,
          f"equijoin took {res.ledger.rounds} rounds, not {want_rounds}")
    # X side: ℓx rows of every common and fake value, tall at full size
    x_rows = sum(ELL[v] for v in VISIT_COMMON) + EQUI_FAKE
    tall = ssm.is_tall_skinny(x_rows, db.n_tuples, db.n_attrs * 8 * 69)
    want = collections.Counter(
        ["ss_matmul", "ss_matmul_tall" if tall else "ss_matmul"])
    check(calls["equijoin"] == want,
          f"equijoin launched {calls['equijoin']}, not {dict(want)}")
    # host work of the equijoin's column open, measured apart
    from repro_torch.core.queries import rounds
    t = time.perf_counter()
    opened = rounds._fused_interpolate([rounds._column(db, first)])[0]
    host = {"open_x_column_s": time.perf_counter() - t}
    t = time.perf_counter()
    words = [db.codec.decode_word(v) for v in opened]
    host["decode_131072_words_s"] = time.perf_counter() - t
    check(words == list(rows[:, first]), "opened FirstName column differs")
    del opened, words
    # the path's launches are read before the profiled repeats below
    launches = check_launches(torch, ops, "slice-5 path", SLICE5_KERNELS,
                              timings)
    split = {tag: device_split(torch, fn) for tag, fn in (
        ("pkfk_chain", lambda: pkfk("chain")),
        ("pkfk_aggregate", lambda: pkfk("aggregate")),
        ("run_batch_3", lambda: client.run_batch(plans)),
        ("pkfk_chain_s2", lambda: pkfk("chain", two)), ("equijoin", equi))}
    log("slice-5 per call: " + json.dumps({
        tag: {"host_s": round(timings[tag], 4),
              "launches": calls.get(tag, {}),
              "peak_above_resident_gb": round(peaks[tag], 3),
              "device": split.get(tag)} for tag in timings}))
    log("slice-5 equijoin host work: " + json.dumps(
        {k: round(v, 4) for k, v in host.items()}))
    log(f"slice-5 device memory: {resident / 1e9:.2f} GB resident before "
        f"the path, {top[0] / 1e9:.2f} GB peak during it")
    del visit_db
    return launches, assign_db


#: slice 6 serves the Employee relation (2 shards, weight 2) and slice 5's
#: Assignment relation (2 shards: a one-shard relation is serial and fuses
#: with nobody) from one QueryServer: 48 plans from 4 submitter threads,
#: then a MapReduce-wrapped client with a dead and a slow worker. Every
#: kernel of the count, select, pattern and range paths launches from pool
#: or MapReduce threads. Each of the two runs is counted on its own.
SLICE6_KERNELS = ("aa_match_batch", "aa_slide_batch", "ss_matmul",
                  "ss_matmul_tall", "ripple_segment")
SLICE6_MR_KERNELS = ("aa_match_batch", "ss_matmul_tall", "ripple_segment")
SERVE_THREADS, SERVE_PLANS, SERVE_WAIT_S = 4, 48, 300.0


def serve_path(torch, args, db, rows, assign_db):
    """Phase 3, slice 6: multi-tenant serving at full size. A
    ``QueryServer`` (max_batch 8, 20 ms deadline, a 2-worker pool) serves
    48 plans from 4 threads over the Employee relation and the Assignment
    relation; every answer is held to the plaintext, every ledger to a
    solo ``QueryClient`` replay of its plan. Then a ``MapReduceExecutor``
    client (4 splits, worker 2 dead, worker 3 slow) runs a count, a
    one_round select and a range count, held to the plaintext and to the
    unwrapped client's ledgers."""
    import threading

    from repro_torch.api import (Aggregate, Between, Contains, Count, Eq,
                                 MapReduceExecutor, QueryClient, RangeCount,
                                 Select)
    from repro_torch.kernels import ops
    from repro_torch.launch import QueryServer
    from repro_torch.runtime import MapReduceRunner, WorkerPool, mapreduce

    assign = make_assignments(rows, args.seed)
    pick = np.random.default_rng(args.seed + 8)
    ids = rows[pick.choice(len(rows), 2, replace=False), 0]
    projects, mult = np.unique(assign[:, 1], return_counts=True)
    small = projects[(mult >= 2) & (mult <= 4)]
    projs = list(pick.choice(small, 4, replace=False))
    salary = rows[:, NAMES.index("Salary")].astype(np.int64)
    emp_plans = [Count(Eq("EmployeeId", ids[1])),
                 Count(Eq("FirstName", "Zorro")),
                 Count(Eq("FirstName", "Quinn")),
                 Count(Eq("FirstName", PLANT["absent"])),
                 Select(Eq("EmployeeId", ids[0]), strategy="one_tuple"),
                 Select(Eq("FirstName", "Zorro"), strategy="one_round"),
                 Select(Eq("FirstName", "Quinn"), strategy="tree"),
                 Count(Contains("EmployeeId", "12345")),
                 RangeCount(Between("Salary", 500, 1500), reduce_every=8),
                 Aggregate("sum", "Salary")]
    # thread t sends each Employee kind once and a select and a count on
    # one Project; its list opens with a fetch on each relation (a
    # one_round or tree select, then the Project select), so the batches
    # the first scan closes carry fetch work and fuse into one wave
    per_thread = []
    for t in range(SERVE_THREADS):
        first = emp_plans[5 + t % 2]
        rest = [("employees", p) for p in emp_plans if p is not first] + [
            ("assignments", Count(Eq("Project", projs[t])))]
        per_thread.append(
            [("employees", first),
             ("assignments", Select(Eq("Project", projs[t]),
                                    strategy="one_round"))]
            + [rest[i] for i in pick.permutation(len(rest))])
    check(sum(map(len, per_thread)) == SERVE_PLANS, "slice-6 traffic")

    def truth(relation, plan):
        """Plaintext (count, addresses, rows or None, value or None)."""
        if isinstance(plan, RangeCount):
            hit = (salary >= plan.where.lo) & (salary <= plan.where.hi)
            return int(hit.sum()), None, None, None
        if isinstance(plan, Aggregate):
            return None, None, None, int(salary.sum())
        table, names = ((rows, NAMES) if relation == "employees"
                        else (assign, ASSIGN_NAMES))
        col = table[:, names.index(plan.where.column)]
        if isinstance(plan.where, Contains):
            hit = np.array([plan.where.literal in w for w in col])
        else:
            hit = col == plan.where.pattern
        addrs = [int(i) for i in np.nonzero(hit)[0]]
        got_rows = ([list(table[a]) for a in addrs]
                    if isinstance(plan, Select) else None)
        return len(addrs), addrs, got_rows, None

    def check_answer(relation, plan, res, tag):
        count, addrs, want_rows, value = truth(relation, plan)
        if value is not None:
            check(res.value == value, f"{tag}: value {res.value} != {value}")
            return
        check(res.count == count, f"{tag}: count {res.count} != {count}")
        if want_rows is not None:
            check(sorted(res.rows) == sorted(want_rows), f"{tag}: rows")
            if res.addresses is not None:
                check(res.addresses == addrs, f"{tag}: addresses")

    def window_counts():
        """Launches and ripple routes since the last reset, once every
        queued kernel has run."""
        torch.cuda.synchronize()
        return ops.launch_counts(), ops.ripple_route_counts()

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    srv = QueryServer(max_batch=8, max_wait_ms=20, pool_workers=2,
                      seed=args.seed + 9)
    srv.attach("employees", db, shards=2, weight=2.0)
    srv.attach("assignments", assign_db, shards=2)
    ops.reset_launch_counts()
    done, lock, errors = [], threading.Lock(), []
    parked = threading.Barrier(SERVE_THREADS + 1, timeout=SERVE_WAIT_S)

    def submitter(plans):
        """A burst of nine, parked before the scheduler starts (a backlog
        at start-up: the first scan finds both relations due, whatever the
        threads' timing), then, once the burst is served, the last three
        one at a time after an idle pause (closed by deadline)."""
        try:
            burst = [(rel, srv.submit(p, relation=rel))
                     for rel, p in plans[:-3]]
            parked.wait()
            for _, r in burst:
                r.wait(timeout=SERVE_WAIT_S)
            tail = []
            for rel, p in plans[-3:]:
                time.sleep(0.05)
                r = srv.submit(p, relation=rel)
                r.wait(timeout=SERVE_WAIT_S)
                tail.append((rel, r))
            with lock:
                done.extend(burst + tail)
        except Exception as e:  # noqa: BLE001 — reported by the main thread
            errors.append(e)
            parked.abort()

    threads = [threading.Thread(target=submitter, args=(per_thread[t],))
               for t in range(SERVE_THREADS)]
    t_serve = time.perf_counter()
    for th in threads:
        th.start()
    parked.wait()
    time.sleep(0.03)                # past the 20 ms deadline
    started = time.time()           # the clock of QueryRequest.enqueued_at
    srv.start()
    for th in threads:
        th.join(timeout=2 * SERVE_WAIT_S)
    serve_s = time.perf_counter() - t_serve
    check(not errors and not any(th.is_alive() for th in threads),
          f"slice-6 submitters failed: {errors}")
    srv.stop()
    served_launches, served_routes = window_counts()
    snap = srv.stats.snapshot()
    planes = {name: copy.copy(srv.dataplane_of(name).stats)
              for name in ("employees", "assignments")}
    log(f"slice-6 server launches {json.dumps(served_launches)}; ripple "
        f"launches by route {json.dumps(served_routes)}")
    for name in SLICE6_KERNELS:
        check(served_launches[name] > 0,
              f"kernel {name} was not launched by the server")
    check(served_routes["strided"] == 0,
          f"served ripple launches off the bit-major route: {served_routes}")
    busy_reader = time_busy_reader(torch, srv, emp_plans[:4])
    srv.close()
    check(len(done) == SERVE_PLANS, f"{len(done)} of 48 requests served")
    failed = [(rel, r.plan, r.error) for rel, r in done if r.error]
    check(not failed, f"slice-6 requests failed: {failed}")
    solo = {"employees": QueryClient(db, seed=args.seed + 10),
            "assignments": QueryClient(assign_db, seed=args.seed + 10)}
    replay = {}
    for i, (rel, r) in enumerate(done):
        check_answer(rel, r.plan, r.result, f"served[{i}] {r.plan}")
        if (rel, r.plan) not in replay:
            replay[(rel, r.plan)] = solo[rel].run(r.plan).ledger.as_dict()
        check(r.result.ledger.as_dict() == replay[(rel, r.plan)],
              f"served[{i}] {r.plan}: ledger differs from a solo replay")
    check(snap["closes"].get("full", 0) > 0
          and snap["closes"].get("deadline", 0) > 0,
          f"slice-6 closes {snap['closes']}: want full and deadline")
    check(all(st.fused_steps > 0 for st in planes.values()),
          "no fused multi-relation wave ran: fused steps "
          + json.dumps({k: v.fused_steps for k, v in planes.items()}))
    check(snap["fused_fallbacks"] == 0,
          f"{snap['fused_fallbacks']} fused waves fell back to solo "
          f"batches: {snap['last_fused_error']}")
    # a burst request's clock starts at start(), not while it sat parked
    parked_s = np.array([max(0.0, started - r.enqueued_at) for _, r in done])
    lat = np.array([r.latency_s for _, r in done]) - parked_s
    wait = np.array([r.queue_wait_s for _, r in done]) - parked_s
    log(f"slice-6 served {snap['served']} requests ({snap['failed']} "
        f"failed) in {snap['batches']} batches; closes "
        f"{json.dumps(snap['closes'])}; fills "
        f"{json.dumps(snap['batch_fill'])}; per relation "
        + json.dumps({k: {"served": v["served"], "batches": v["batches"],
                          "closes": v["closes"]}
                      for k, v in snap["relations"].items()}))
    log(f"slice-6 from start() or submission: latency p50 "
        f"{np.percentile(lat, 50)} s, p99 {np.percentile(lat, 99)} s; "
        f"queue wait p50 {np.percentile(wait, 50)} s; throughput "
        f"{snap['throughput_qps']} queries/s over {snap['busy_s']} s inside "
        f"run_batch; the staged window (threads, barrier, 30 ms before "
        f"start(), 3 x 50 ms pauses a thread) {serve_s} s")
    log("slice-6 pool: " + json.dumps(
        {k: {"dispatches": v.dispatches, "steps": v.steps,
             "fused_steps": v.fused_steps,
             "dispatch_s": round(v.dispatch_s, 4)}
         for k, v in planes.items()}))

    # -- MapReduce: the paper's substrate over the same relation ---------
    runner = MapReduceRunner(WorkerPool(4, slow_workers={3: 0.3},
                                        dead_workers={2}, seed=args.seed),
                             lease_s=0.5, max_attempts=8)
    mr = QueryClient(db, seed=args.seed + 11,
                     executor=MapReduceExecutor(runner, n_splits=4))
    plain = QueryClient(db, seed=args.seed + 11)
    mr_plans = [Count(Eq("FirstName", "Quinn")),
                Select(Eq("FirstName", "Zorro"), strategy="one_round",
                       expected_matches=3),
                RangeCount(Between("Salary", 500, 1500), reduce_every=8)]
    timings, mr_results = {}, []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for plan in mr_plans:
        t = time.perf_counter()
        mr_results.append((plan, mr.run(plan)))
        torch.cuda.synchronize()
        timings[type(plan).__name__] = time.perf_counter() - t
    # a straggler's late copy belongs to this run, not to the next one
    for th in threading.enumerate():
        if th.name == mapreduce.THREAD_NAME:
            th.join(timeout=10)
    mr_launches, mr_routes = window_counts()
    for plan, res in mr_results:
        check_answer("employees", plan, res, f"mapreduce {plan}")
        check(res.ledger.as_dict() == plain.run(plan).ledger.as_dict(),
              f"mapreduce {plan}: ledger differs from the unwrapped one")
    counters = {"reexecutions": runner.reexecutions,
                "speculative_launched": runner.speculative_launched,
                "worker_deaths": runner.worker_deaths}
    log(f"slice-6 mapreduce {json.dumps(counters)}; host seconds "
        + json.dumps(timings) + f"; launches {json.dumps(mr_launches)}; "
        f"ripple launches by route {json.dumps(mr_routes)}")
    check(runner.reexecutions > 0, "the dead worker's task was never "
          "re-executed")
    for name in SLICE6_MR_KERNELS:
        check(mr_launches[name] > 0,
              f"kernel {name} was not launched by the MapReduce client")
    log(f"slice-6 phase {time.perf_counter() - t_phase:.3f} host s; device "
        f"memory {resident / 1e9:.2f} GB resident, "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB peak")
    launches = {k: served_launches[k] + mr_launches[k]
                for k in served_launches}
    log(f"slice-6 path launches {launches}; host seconds "
        + json.dumps({"serve_s": serve_s, **timings, **busy_reader}))
    return launches


def time_busy_reader(torch, srv, counts, rounds: int = 2):
    """Host seconds of one batch of eight counts pumped on a stopped
    server, alone and beside a monitor thread that polls the stats in a
    tight loop, alternated ``rounds`` times. Not a counted run."""
    import threading

    def one_batch():
        reqs = [srv.submit(counts[i % len(counts)], relation="employees")
                for i in range(8)]
        t = time.perf_counter()
        srv.pump(relation="employees")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        check(all(r.done() and r.error is None for r in reqs),
              "a batch beside the stats monitor failed")
        return dt

    def monitor():
        while not stop.is_set():
            srv.stats.snapshot()
            srv.stats.latency_quantile(0.99)
            reads[0] += 1

    times = {"alone_s": [], "monitored_s": []}
    reads = [0]
    for _ in range(rounds):
        times["alone_s"].append(one_batch())
        stop = threading.Event()
        mon = threading.Thread(target=monitor)
        mon.start()
        try:
            times["monitored_s"].append(one_batch())
        finally:
            stop.set()
            mon.join(timeout=60)
    log(f"slice-6 one batch of 8 counts (host s): {json.dumps(times)}; "
        f"the monitor read the stats {reads[0]} times")
    return {k: max(v) for k, v in times.items()}


# ---------------------------------------------------------------------------
# slice 11: the MeshDispatcher on a grid of devices
# ---------------------------------------------------------------------------

#: every kernel of the slice-11 path (share_onehot is reached by slice 7's
#: route (b), the EmbedLookup under the default MeshDispatcher())
SLICE11_KERNELS = ("aa_match_batch", "aa_slide_batch", "ss_matmul",
                   "ss_matmul_tall", "ripple_segment", "ripple_carry")
#: (b) on a one-card host: cloud group 1 lives on the host and runs the
#: plain versions there, so its relation is cut to this many tuples and
#: its join's child relation to this many rows (the host's int64 matmuls
#: take seconds a cloud at 16,384 x 2,760)
HOST_HALF_TUPLES, HOST_HALF_CHILD = 16384, 32


def slice11_cases(rows, assign, child_db, seed):
    """(plans by tag, their plaintext check): count, the one-tuple,
    one-round and tree selects, a substring count, RangeCount at
    reduce_every 8 and 1, SUM and MIN over Salary and a PK/FK join."""
    from repro_torch.api import (Aggregate, Between, Contains, Count, Eq,
                                 Join, RangeCount, Select)
    pick = np.random.default_rng(seed + 11)
    eid = rows[pick.integers(0, len(rows)), 0]
    first = rows[:, NAMES.index("FirstName")]
    salary = rows[:, NAMES.index("Salary")].astype(np.int64)
    by_id = {r[0]: list(r) for r in rows}
    plans = {
        "count": Count(Eq("FirstName", "Quinn")),
        "one_tuple": Select(Eq("EmployeeId", eid), strategy="one_tuple"),
        "one_round": Select(Eq("FirstName", "Zorro"), strategy="one_round"),
        "tree": Select(Eq("FirstName", "Quinn"), strategy="tree"),
        "contains": Count(Contains("FirstName", "inn")),
        "range_r8": RangeCount(Between("Salary", 500, 1500), reduce_every=8),
        "range_r1": RangeCount(Between("Salary", 500, 1500), reduce_every=1),
        "sum": Aggregate("sum", "Salary"),
        "min": Aggregate("min", "Salary", reduce_every=8),
        "pkfk": Join(right=child_db, on=("EmployeeId", "EmployeeId"),
                     kind="pkfk")}
    in_range = int(((salary >= 500) & (salary <= 1500)).sum())
    want = {
        "count": ("count", ELL["Quinn"]),
        "one_tuple": ("rows", [by_id[eid]]),
        "one_round": ("rows", sorted(list(r) for r in rows[first == "Zorro"])),
        "tree": ("addresses",
                 [int(i) for i in np.nonzero(first == "Quinn")[0]]),
        "contains": ("count", sum(like_oracle(w, "%inn%") for w in first)),
        "range_r8": ("count", in_range),
        "range_r1": ("count", in_range),
        "sum": ("value", int(salary.sum())),
        "min": ("value", int(salary.min())),
        "pkfk": ("rows", sorted(by_id[a[0]] + list(a[1:]) for a in assign
                                if a[0] in by_id))}
    return plans, want


def slice11_run(torch, args, db, plans, grid):
    """Every plan through a client whose relation sits at 2 shards under
    ``MeshDispatcher(grid)``, in strict mode (no cloud step may copy to
    the host or wait on the device) when every slot is a card: (results,
    host seconds a call, dispatcher)."""
    from repro_torch.api import MeshDispatcher, QueryClient
    mesh = MeshDispatcher(grid, strict_transfers=all(
        d.type == "cuda" for d in grid.devices))
    client = QueryClient(db, seed=args.seed)
    client.attach(shards=2, dispatcher=mesh)
    outs, secs = {}, {}
    for tag, plan in plans.items():
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs[tag] = client.run(plan)
        torch.cuda.synchronize()
        secs[tag] = time.perf_counter() - t
    return outs, secs, mesh


def slice11_check(torch, args, db, plans, want, grid, label):
    """Run ``plans`` on the 1 x 1 grid of ``cuda:0`` and on ``grid``; every
    answer must equal the plaintext and the 1 x 1 grid's, every ledger its
    ledger, and no byte may go from one cloud group's slot to another's.
    Returns the launches of the ``grid`` run."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_dispatch_mesh
    peaks = {}

    def run(which, grid_):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = slice11_run(torch, args, db, plans, grid_)
        peaks[which] = (torch.cuda.max_memory_allocated() - base) / 1e9
        return out

    one, one_s, _ = run("1 x 1", make_dispatch_mesh(devices=["cuda:0"]))
    ops.reset_launch_counts()
    got, got_s, mesh = run(label, grid)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    for tag, (field, value) in want.items():
        for res, who in ((one[tag], "1 x 1"), (got[tag], label)):
            have = getattr(res, field)
            if field == "rows":
                have = sorted(have)
            check(have == value, f"slice 11 {who} {tag}: {field} {have} != "
                  f"{value}")
        a, b = one[tag], got[tag]
        check((a.strategy, a.rows, a.addresses, a.count, a.value)
              == (b.strategy, b.rows, b.addresses, b.count, b.value),
              f"slice 11 {label} {tag}: answer differs from the 1 x 1 grid's")
        check(a.ledger.as_dict() == b.ledger.as_dict(),
              f"slice 11 {label} {tag}: ledger differs from the 1 x 1 grid's")
    cross = mesh.cross_group_bytes()
    by_why = collections.Counter()
    for cp in mesh.copies():
        by_why[cp["why"]] += cp["bytes"]
    log(f"slice 11 {label}: grid {mesh.grid.shape} of "
        f"{[str(d) for d in mesh.devices]}, "
        f"{len(mesh.groups(db.n_shares))} cloud groups of "
        f"{[hi - lo for lo, hi in mesh.groups(db.n_shares)]} clouds; "
        f"bytes copied by kind {json.dumps(dict(by_why))}; "
        f"cross-group bytes {cross}; predicted reduction cost "
        f"{json.dumps(mesh.predicted_cost())}")
    log(f"slice 11 {label}: placed bytes by slot " + json.dumps(
        {str(cp["dst"]): cp["bytes"] for cp in mesh.copies()
         if cp["why"] == "place"}))
    check(cross == 0, f"slice 11 {label}: {cross} bytes went from one "
          f"cloud group's slot to another's")
    log(f"slice 11 {label}: host seconds a call (this grid, then the 1 x 1 "
        f"grid) " + json.dumps({t: [round(got_s[t], 4), round(one_s[t], 4)]
                               for t in plans}))
    log(f"slice 11 {label}: strict transfers {mesh.strict_transfers}; "
        f"launches {json.dumps(launches)}; peak device memory above the "
        f"resident relations, GB " + json.dumps(
            {k: round(v, 3) for k, v in peaks.items()}))
    return launches


def slice11_isolation(torch, args, db, plans, want, grid, label):
    """The non-communicating clouds on ``grid``: run the count and the
    one-round select with every cloud step run twice, the first time with
    each share of the clouds outside group 0 raised by one (mod p) in
    place (the blocks on the relation's own card are views of it), then
    as shared. Group 0's clouds of each step's result must be
    bit-identical in both runs and the other clouds must differ, so a
    block that read another group's shares fails; the answers must stay
    the plaintext's."""
    from repro_torch import _tree
    from repro_torch.api import MeshDispatcher, QueryClient

    class Isolating(MeshDispatcher):
        steps = moved = 0

        def run_set(self, plane, ds):
            k = self.groups(plane.db.n_shares)[0][1]
            held = [plane.db.relation.values] + [
                s.values for s in plane.db.numeric.values()]
            for t in held:
                t[k:].add_(1).remainder_(P)
            try:
                changed = super().run_set(plane, ds)
            finally:
                for t in held:
                    t[k:].sub_(1).remainder_(P)
            out = super().run_set(plane, ds)
            a, b = _tree.leaves(out), _tree.leaves(changed)
            check(len(a) == len(b), f"slice 11 {label} isolation: the "
                  f"changed run returned another structure")
            moved = False
            for x, y in zip(a, b):
                if isinstance(x, torch.Tensor):
                    check(torch.equal(x[:k], y[:k]),
                          f"slice 11 {label} isolation: group 0's clouds "
                          f"moved with another group's shares")
                    moved |= not torch.equal(x[k:], y[k:])
                else:
                    check(x == y, f"slice 11 {label} isolation: {x!r} "
                          f"!= {y!r}")
            Isolating.steps += 1
            Isolating.moved += moved
            return out

    mesh = Isolating(grid)
    check(len(mesh.groups(db.n_shares)) > 1,
          f"slice 11 {label}: the isolation check needs split clouds")
    client = QueryClient(db, seed=args.seed)
    client.attach(shards=2, dispatcher=mesh)
    for tag in ("count", "one_round"):
        field, value = want[tag]
        have = getattr(client.run(plans[tag]), field)
        check((sorted(have) if field == "rows" else have) == value,
              f"slice 11 {label} isolation {tag}: {field} {have}")
    check(Isolating.steps == Isolating.moved == 3,
          f"slice 11 {label} isolation: {Isolating.moved} of "
          f"{Isolating.steps} steps moved with group 1's shares, not 3 of 3")
    log(f"slice 11 {label}: a count and a one-round select, each cloud "
        f"step run with the clouds outside group 0 changed: group 0's "
        f"clouds bit-identical in all {Isolating.steps} steps, the other "
        f"clouds changed in {Isolating.moved}")


def slice11_path(torch, args, db, rows):
    """Phase 3, slice 11: the Employee relation's cloud steps through
    ``MeshDispatcher`` on a grid. (a) A 2 x 2 grid of ``cuda:0`` at the
    full n (2 data rows, 2 groups of 10 clouds); every kernel of the path
    must launch there. (b) Distinct devices: every card (n_model 2 when
    their count is even) at the full n, or on a one-card host
    ``[cuda:0, cpu]`` on the model axis at HOST_HALF_TUPLES, cloud group 1
    on the host. Returns the launches of both grid runs."""
    from repro_torch.core import Codec, outsource
    from repro_torch.launch.mesh import make_dispatch_mesh

    def child(rows_, n_child):
        assign = make_assignments(rows_, args.seed)[:n_child]
        return assign, outsource(assign.tolist(), n_shares=20,
                                 column_names=ASSIGN_NAMES,
                                 codec=Codec(word_length=8), degree=1,
                                 seed=args.seed + 5)

    t0 = time.perf_counter()
    assign, child_db = child(rows, N_ASSIGN)
    plans, want = slice11_cases(rows, assign, child_db, args.seed)
    grid = make_dispatch_mesh(2, devices=["cuda:0"] * 4)
    launches = slice11_check(torch, args, db, plans, want, grid,
                             "(a) 2 x 2 grid of cuda:0")
    slice11_isolation(torch, args, db, plans, want, grid,
                      "(a) 2 x 2 grid of cuda:0")
    for name in SLICE11_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the slice-11 2 x 2 grid")
    log(f"slice 11 (a) took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    if cards >= 2:
        grid = make_dispatch_mesh(2 if cards % 2 == 0 else 1)
        label = f"(b) {cards} cards"
        db_b, rows_b, assign_b, child_b = db, rows, assign, child_db
    else:
        grid = make_dispatch_mesh(2, devices=["cuda:0", "cpu"])
        label = "(b) cuda:0 and the host"
        rows_b = make_rows(HOST_HALF_TUPLES, args.seed)
        db_b = outsource(rows_b.tolist(), n_shares=20, column_names=NAMES,
                         codec=Codec(word_length=8), degree=1,
                         seed=args.seed,
                         numeric_columns={NAMES.index("Salary"):
                                          SALARY_BITS})
        assign_b, child_b = child(rows_b, HOST_HALF_CHILD)
    log(f"slice 11 {label}: {db_b.n_tuples} tuples, a "
        f"{child_b.n_tuples}-row child relation")
    plans, want = slice11_cases(rows_b, assign_b, child_b, args.seed)
    launches_b = slice11_check(torch, args, db_b, plans, want, grid, label)
    log(f"slice 11 (b) took {time.perf_counter() - t0:.1f} s")
    return {k: launches[k] + launches_b[k] for k in launches}


def embed_path(torch, args, vocab: int = QWEN_VOCAB, dim: int = QWEN_DIM):
    """Phase 3, slice 4: the oblivious embedding lookup at Qwen1.5-4B width
    through the public entry points: a synthetic (V, D) table from
    ``--seed`` shared over c = 4 clouds, a client over the table at S = 1
    and one over a 2-shard ``ShardedRelation``, a 256-token prefill, 4
    decode steps of 8 tokens, a batch of 4 lookups (one verified), and the
    standalone batched and per-call lookups. Every opened embedding must
    equal the quantized table's row exactly. Returns (launches, table)."""
    from repro_torch import _device
    from repro_torch.api import EmbedLookup, QueryClient
    from repro_torch.core import ShardedRelation
    from repro_torch.core.queries import embed as eq
    from repro_torch.kernels import ops
    from repro_torch.models import private_embed as pe

    dev = _device.resolve(None)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    timings, peaks, top = {}, {}, [0]

    def timed(tag, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        timings[tag] = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        peaks[tag] = (peak - base) / 1e9
        top[0] = max(top[0], peak)
        return res

    ops.reset_launch_counts()
    plain = torch.randn((vocab, dim), generator=gen, device=dev)  # |x| << 64
    table = timed("setup_private_embed", lambda: pe.setup_private_embed(
        args.seed, plain, n_shares=EMBED_SHARES))
    quant = eq.dequantize_from_field(eq.quantize_to_field(plain))
    del plain
    log(f"shared a {vocab} x {dim} table over {EMBED_SHARES} clouds: "
        f"{table.values.numel() * 4 / 1e9:.2f} GB of int32 shares in "
        f"{timings['setup_private_embed']:.2f} s")
    rel = pe.as_embed_relation(table)
    one = QueryClient(rel, seed=args.seed)
    plane = ShardedRelation(rel, shards=2)
    two = QueryClient(plane, seed=args.seed + 1)
    rng = np.random.default_rng(args.seed + 4)

    def want(toks):
        idx = torch.as_tensor(np.asarray(toks).reshape(-1), device=dev)
        return quant[idx].cpu().numpy()

    def lookup(tag, toks, verify=False):
        plan = EmbedLookup(tokens=np.asarray(toks).reshape(-1),
                           verify=verify)
        res = timed(tag, lambda: one.run(plan))
        check(np.array_equal(res.embeddings, want(toks)),
              f"{tag}: embeddings differ from the quantized table")
        exp = one.explain([plan])
        check((exp.bits, exp.rounds) == (res.ledger.communication_bits,
                                         res.ledger.rounds),
              f"{tag}: explain differs from the ledger")
        res2 = timed(tag + "_s2", lambda: two.run(plan))
        check(np.array_equal(res2.embeddings, res.embeddings),
              f"{tag}: S = 2 embeddings differ from S = 1")
        check(res2.ledger.as_dict() == res.ledger.as_dict(),
              f"{tag}: S = 2 ledger differs")

    prefill = rng.integers(0, vocab, (8, 32))
    prefill[0, :4] = [0, vocab - 1, 17, 17]
    lookup("prefill_256", prefill)
    for step in range(4):
        lookup(f"decode_8_{step}", rng.integers(0, vocab, 8))
    toks = [rng.integers(0, vocab, n) for n in (8, 32, 1, 8)]
    plans = [EmbedLookup(tokens=t, verify=i == 1) for i, t in enumerate(toks)]
    d0 = plane.stats.dispatches
    outs = timed("run_batch_4_s2", lambda: two.run_batch(plans))
    check(plane.stats.dispatches - d0 == 2, "the batch of 4 took "
          f"{plane.stats.dispatches - d0} dispatches, not 2")
    for i, (t, res) in enumerate(zip(toks, outs)):
        check(np.array_equal(res.embeddings, want(t)), f"batch[{i}] differs")
    exp = two.explain(plans)
    check((exp.bits, exp.rounds) == (
        sum(r.ledger.communication_bits for r in outs),
        max(r.ledger.rounds for r in outs)), "batch explain differs")
    grid = rng.integers(0, vocab, (2, 4))
    got = timed("private_lookup_batched", lambda: pe.private_lookup_batched(
        (args.seed, 5), table, grid, verify=True))
    check(got.shape == (2, 4, dim) and np.array_equal(
        got.cpu().numpy().reshape(8, dim), want(grid)),
        "private_lookup_batched differs")
    got = timed("private_lookup", lambda: pe.private_lookup(
        (args.seed, 6), table, grid[0, :3]))
    check(np.array_equal(got.cpu().numpy(), want(grid[0, :3])),
          "private_lookup differs")
    del quant
    log("slice-4 peak device memory above both tables, GB: "
        + json.dumps({k: round(v, 3) for k, v in peaks.items()}))
    log(f"slice-4 device memory: {torch.cuda.memory_allocated() / 1e9:.2f} "
        f"GB held after the path, {top[0] / 1e9:.2f} GB peak during it (the "
        f"Employee relation resident)")
    return check_launches(torch, ops, "slice-4 path", SLICE4_KERNELS,
                          timings), table


def embed_full_shapes(torch, table, errs, launches):
    """Phase 4 for slice 4: ``share_onehot`` at the prefill shape (M = 256,
    V = 151,936, c = 4) and the lookup's tall contraction at M = 8 (a
    decode step) and M = 256 against the (4, 151,936, 2,560) table, each
    against its plain version and timed. Returns the kernels-line entry of
    ``share_onehot``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ss_matmul as ssm

    vals = table.values
    c, v, d = vals.shape
    dev = vals.device
    gen = torch.Generator(device=dev).manual_seed(11)
    entry = None
    for m, reps in ((8, 10), (256, 3)):
        toks = torch.randint(0, v, (m,), generator=gen, device=dev)
        a1 = rand_field(torch, gen, (m, v), dev)
        shared = ops.share_onehot(toks, a1, n_shares=c)
        want = ssm.share_onehot_plain(toks, a1, n_shares=c)
        torch.cuda.synchronize()
        check(torch.equal(shared, want), f"share_onehot M={m} differs")
        errs["share_onehot"] = max(errs["share_onehot"],
                                   max_err(torch, shared, want))
        del want
        if m == 256:
            ms = time_ms(torch, lambda: ops.share_onehot(toks, a1,
                                                         n_shares=c), 20)
            plain_ms = time_ms(torch, lambda: ssm.share_onehot_plain(
                toks, a1, n_shares=c), 2)
            nbytes = 4 * (m * v + m + c * m * v)
            nops = (c + 1) * m * v               # one compare, c adds
            bound_ms, bound_by = bound(nbytes, nops)
            entry = {"name": "share_onehot", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/share_onehot.cu",
                     "replaces": "src/repro/kernels/ss_matmul.py:186",
                     "launches": launches["share_onehot"],
                     "max_abs_err": errs["share_onehot"], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None}
            log(f"share_onehot {(c, m, v)}: {ms} ms, plain {plain_ms} ms, "
                f"bound {bound_ms} ms ({bound_by})")
        got, want = ops.ss_matmul(shared, vals), ssm.ss_matmul_plain(shared,
                                                                     vals)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"embedding contraction M={m} differs")
        errs["ss_matmul_tall"] = max(errs["ss_matmul_tall"],
                                     max_err(torch, got, want))
        del got, want
        tall_ms = time_ms(torch, lambda: ops.ss_matmul(shared, vals), reps)
        gen_ms = time_ms(torch, lambda: ssm.ss_matmul_cuda(shared, vals),
                         reps)
        plain_ms = time_ms(torch, lambda: ssm.ss_matmul_plain(shared, vals),
                           1, warmup=0)
        nbytes = 4 * (c * m * v + c * v * d + c * m * d)
        log(f"embedding contraction {(c, m, v)} @ {(c, v, d)}: tall "
            f"{tall_ms} ms, general {gen_ms} ms, plain {plain_ms} ms, bound "
            f"{bound_note(nbytes, 32 * c * m * v * d, INT8_TENSOR_OPS_PER_S)}")
        del shared, a1
    return entry


#: slice 7 runs the full Qwen1.5-4B configuration of the port's registry
#: (src/repro_torch/configs/qwen1_5_4b.py: 40 layers, d 2,560, 20 heads,
#: d_ff 6,912, V 151,936, QKV bias, bf16) on synthetic weights from
#: ``--seed``: 4 requests of 64 prompt tokens and 32 new ones, three ways.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW = "qwen1_5_4b", 4, 64, 32
SLICE7_KERNELS = ("share_onehot", "ss_matmul_tall")


def lm_path(torch, args, errs):
    """Phase 3, slice 7: private LM generation at the full Qwen1.5-4B
    configuration through the public entry points. The weights are drawn
    on the card from ``--seed`` (``lm.init_params``) and the embedding
    table is shared once (c = 4, degree 1) into ``params["embed_shares"]``.
    Three routes generate greedily from the same prompts: (a)
    ``BatchServer`` with ``private_embed=True`` (``private_lookup_inline``
    each step), (b) the ``private_generate`` flow (a ``QueryClient`` with
    the table attached at 2 vocab shards under ``MeshDispatcher()``, one
    ``EmbedLookup`` a step into ``decode_step(embeds=)``), (c) a plaintext
    ``BatchServer`` over the dequantized quantized table. Fails unless the
    three generate identical tokens, the launch counters of
    ``share_onehot`` and ``ss_matmul_tall`` rise inside (a) and (b), the
    three routes' prefill logits are equal (every embedding is exact),
    decode matches forward within atol 0.12 / rtol 0.05 (the reference's
    own bound), and every kernel shape the routes launch equals its plain
    version: ``share_onehot`` at M = 4 (a decode step) and M = 256 (the
    prefill), the tall contraction against the whole table (route a) and
    against each vocab shard's strided column slice (route b) at both M.
    Records each kernel's largest error in ``errs``. Returns the path's
    launches."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.api import EmbedLookup, MeshDispatcher, QueryClient
    from repro_torch.kernels import ops
    from repro_torch.kernels import ss_matmul as ssm
    from repro_torch.launch import BatchServer, Request
    from repro_torch.models import lm
    from repro_torch.models import private_embed as pe

    cfg = configs.full(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size,
           cfg.dtype, cfg.qkv_bias) == (40, 2560, 20, 6912, 151936,
                                        "bfloat16", True),
          f"{LM_ARCH} is not the published configuration: {cfg}")
    priv_cfg = dataclasses.replace(cfg, private_embed=True)
    b, t, new = LM_BATCH, LM_PROMPT, LM_NEW
    max_len = t + new
    timings, total = {}, collections.Counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()

    def clock(tag, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        timings[tag] = time.perf_counter() - t0
        return res

    params = clock("init_params_s", lambda: lm.init_params(args.seed, cfg))
    n_params = sum(v.numel() for v in _leaves(params))
    weights_gb = (torch.cuda.memory_allocated() - held) / 1e9
    base = torch.cuda.memory_allocated()
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    table = clock("setup_private_embed_s", lambda: pe.setup_private_embed(
        (args.seed, 7), params["embed"], n_shares=EMBED_SHARES))
    setup_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    params["embed_shares"] = table.values
    plain = {k: v for k, v in params.items() if k != "embed_shares"}
    plain["embed"] = dequantized(torch, params["embed"])
    log(f"slice-7 {LM_ARCH}: {n_params} parameters ({weights_gb:.3f} GB, "
        f"bf16 weights, fp32 norms) drawn in {timings['init_params_s']:.3f}"
        f" s; table shared over {EMBED_SHARES} clouds "
        f"({table.values.numel() * 4 / 1e9:.3f} GB) in "
        f"{timings['setup_private_embed_s']:.3f} s, set-up peak "
        f"{setup_peak:.3f} GB above the weights")
    rng = np.random.default_rng(args.seed + 7)
    prompts = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    dev = params["final_norm"].device
    prompt_t = torch.as_tensor(prompts, dtype=torch.int64, device=dev)

    def count_window(route, fn):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        got = ops.launch_counts()
        total.update(got)
        log(f"slice-7 route {route} launches {got}")
        check_onehot_quad(ops, f"slice-7 route {route}")
        return res, got

    def via_server_run(server, n_new):
        reqs = [Request(prompt=p.copy(), max_new=n_new) for p in prompts]
        return np.stack([r.out for r in server.serve(reqs)])

    def via_server(route, server):
        via_server_run(server, 2)                # warm-up, untimed
        clock(f"{route}_prefill_s", lambda: via_server_run(server, 1))
        return clock(f"{route}_generate_s",
                     lambda: via_server_run(server, new))

    servers = {"a": BatchServer(params, priv_cfg, max_len=max_len),
               "c": BatchServer(plain, cfg, max_len=max_len)}
    toks_c, launch_c = count_window("c", lambda: via_server("c",
                                                            servers["c"]))
    toks_a, launch_a = count_window("a", lambda: via_server("a",
                                                            servers["a"]))

    client = QueryClient(seed=args.seed)
    mesh = MeshDispatcher()
    check(mesh.grid.shape == {"data": torch.cuda.device_count(),
                              "model": 1},
          f"the default MeshDispatcher() grid is {mesh.grid.shape}, not "
          f"every visible card on data")
    log(f"slice-7 route (b): the default MeshDispatcher() grid "
        f"{mesh.grid.shape} of {[str(d) for d in mesh.devices]}")
    plane = client.attach(pe.as_embed_relation(table), name="embeddings",
                          shards=2, dispatcher=mesh)
    split = {"lookup_s": 0.0, "decode_s": 0.0}

    def lookup(toks):
        res = client.run(EmbedLookup(tokens=toks.reshape(-1)),
                         relation="embeddings")
        return torch.from_numpy(res.embeddings).to(dev).reshape(
            *toks.shape, cfg.d_model)

    def generate_b(n_new, keep=None):
        logits, cache = lm.prefill(params, cfg, {"tokens": prompt_t,
                                                 "embeds": lookup(prompts)},
                                   max_len=max_len)
        if keep is not None:
            keep.append(logits)
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        out = [tok]
        for i in range(n_new - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            emb = lookup(tok.cpu().numpy())
            t1 = time.perf_counter()
            logits, cache = lm.decode_step(params, cfg, cache, t + i,
                                           {"tokens": tok, "embeds": emb})
            tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            out.append(tok)
            torch.cuda.synchronize()
            split["lookup_s"] += t1 - t0
            split["decode_s"] += time.perf_counter() - t1
        return torch.cat(out, dim=1).cpu().numpy().astype(np.int32)

    def route_b():
        generate_b(2)                            # warm-up, untimed
        clock("b_prefill_s", lambda: generate_b(1))
        split.update(lookup_s=0.0, decode_s=0.0)
        toks = clock("b_generate_s", lambda: generate_b(new))
        timings.update(b_lookup_s=split["lookup_s"],
                       b_decode_s=split["decode_s"])
        return toks

    toks_b, launch_b = count_window("b", route_b)
    log(f"slice-7 tokens of request 0: {toks_a[0].tolist()}")
    check(toks_a.shape == (b, new) and np.array_equal(toks_a, toks_b)
          and np.array_equal(toks_a, toks_c),
          "slice 7: routes (a), (b) and (c) generated different tokens")
    for route, got in (("a", launch_a), ("b", launch_b)):
        for name in SLICE7_KERNELS:
            check(got[name] > 0, f"slice 7 route ({route}) launched no "
                  f"{name}")
    check(launch_c["share_onehot"] == 0 and launch_c["ss_matmul_tall"] == 0,
          "slice 7: the plaintext route launched a lookup kernel")
    lookups = 2 + 1 + new                    # warm-up, prefill, full run
    per_step = {r: {k: got[k] / lookups for k in SLICE7_KERNELS}
                for r, got in (("a", launch_a), ("b", launch_b))}
    log(f"slice-7 plane: {plane.stats.dispatches} dispatches in "
        f"{plane.stats.steps} steps, {plane.stats.transfer_bytes} bytes "
        f"placed once")

    # logits of the three embeddings sources at the prefill, and decode
    # against forward (not counted)
    kept = []
    generate_b(1, keep=kept)
    la, _ = lm.prefill(params, priv_cfg, {"tokens": prompt_t},
                       max_len=max_len)
    lc, cache = lm.prefill(plain, cfg, {"tokens": prompt_t}, max_len=max_len)
    diff = {"a_vs_b": float((la - kept[0]).abs().max()),
            "a_vs_c": float((la - lc).abs().max())}
    check(diff["a_vs_b"] == 0.0 and diff["a_vs_c"] == 0.0,
          f"slice 7: the routes' prefill logits differ: {diff}")
    tok = torch.argmax(lc[:, -1], dim=-1, keepdim=True)
    ld, _ = lm.decode_step(plain, cfg, cache, t, {"tokens": tok})
    full = lm.forward(plain, cfg, {"tokens": torch.cat([prompt_t, tok], 1)})
    dec_err = float((ld[:, 0] - full[:, t]).abs().max())
    check(bool(torch.isfinite(full).all()) and torch.allclose(
        ld[:, 0], full[:, t], atol=0.12, rtol=0.05),
        f"slice 7: decode_step differs from forward (max |d| {dec_err})")
    del kept, la, lc, ld, full, cache
    log(f"slice-7 prefill logits max |d| {json.dumps(diff)}; decode vs "
        f"forward max |d| {dec_err} (atol 0.12, rtol 0.05)")
    path_peak = max(init_peak, torch.cuda.max_memory_allocated())

    # every kernel shape of the routes against its plain version: the
    # one-hot shares at M = 4 (a decode step) and M = 256 (the prefill),
    # contracted with the whole table (route a) and with each vocab
    # shard's strided column slice and its placed block (route b)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    blocks = [(f"table[{lo}:{hi}]", (lo, hi),
               plane.view(sh.index).relation.values)
              for sh in plane.shards for lo, hi in [(sh.lo, sh.hi)]]
    for m in (b, b * t):
        mtoks = torch.randint(0, cfg.vocab_size, (m,), generator=gen,
                              device=dev)
        a1 = rand_field(torch, gen, (m, cfg.vocab_size), dev)
        shared = ops.share_onehot(mtoks, a1, n_shares=EMBED_SHARES)
        want = ssm.share_onehot_plain(mtoks, a1, n_shares=EMBED_SHARES)
        torch.cuda.synchronize()
        check(torch.equal(shared, want), f"slice 7: share_onehot at "
              f"{tuple(shared.shape)} differs from its plain version")
        errs["share_onehot"] = max(errs["share_onehot"],
                                   max_err(torch, shared, want))
        del want, a1
        for what, (lo, hi), rhs in [("table", (0, cfg.vocab_size),
                                     table.values)] + blocks:
            lhs = shared[:, :, lo:hi]
            check(ssm.is_tall_skinny(m, hi - lo, cfg.d_model),
                  f"slice 7: M={m} against {what} is not a tall shape")
            got, want = ops.ss_matmul(lhs, rhs), ssm.ss_matmul_plain(lhs,
                                                                     rhs)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"slice 7: ss_matmul_tall at M="
                  f"{m} against {what} differs from its plain version")
            errs["ss_matmul_tall"] = max(errs["ss_matmul_tall"],
                                         max_err(torch, got, want))
            del got, want
        del shared
    log(f"slice-7 kernels == plain versions: share_onehot at M = {b} and "
        f"{b * t}; ss_matmul_tall at both M against the table and "
        f"{', '.join(w for w, _, _ in blocks)}")
    del blocks
    # device time of one more generation a route (torch.profiler), so the
    # card's idle share is 1 - device / host seconds of the counted run
    runs = {"a": lambda: via_server_run(servers["a"], new),
            "b": lambda: generate_b(new),
            "c": lambda: via_server_run(servers["c"], new)}
    split_dev = {r: device_split(torch, fn) for r, fn in runs.items()}
    for r, sp in split_dev.items():
        dev_ms = sp["ss_matmul_ms"] + sp["other_ms"]
        sp["idle_share"] = 1.0 - dev_ms / (1e3 * timings[f"{r}_generate_s"])
    log(f"slice-7 device ms of one generation a route: "
        f"{json.dumps(split_dev)}")
    decode_ms = {r: 1e3 * (timings[f"{r}_generate_s"]
                           - timings[f"{r}_prefill_s"]) / (new - 1)
                 for r in "abc"}
    step_s = timings["b_lookup_s"] + timings["b_decode_s"]
    summary = {
        "setup_s": {k: timings[k] for k in
                    ("init_params_s", "setup_private_embed_s")},
        "prefill_s": {r: timings[f"{r}_prefill_s"] for r in "abc"},
        "generate_s": {r: timings[f"{r}_generate_s"] for r in "abc"},
        "decode_ms_per_step": decode_ms,
        "tokens_per_s": {r: b * new / timings[f"{r}_generate_s"]
                         for r in "abc"},
        "b_lookup_share_of_step": timings["b_lookup_s"] / step_s,
        "b_lookup_ms_per_step": 1e3 * timings["b_lookup_s"] / (new - 1),
        "launches_per_lookup": per_step,
        "idle_share": {r: sp["idle_share"] for r, sp in split_dev.items()},
        "setup_peak_gb": setup_peak,
        "peak_gb": path_peak / 1e9,
        "peak_with_plain_check_gb": torch.cuda.max_memory_allocated() / 1e9,
        "held_before_gb": held / 1e9}
    log("slice-7 summary " + json.dumps(summary))
    # slice 12: one decode step of route (a) after a prefill, priced
    _, dcache = lm.prefill(params, priv_cfg, {"tokens": prompt_t},
                           max_len=max_len)
    tok = prompt_t[:, -1:]
    price_step(torch, f"slice-7 route (a) private {LM_ARCH} decode step",
               lambda: lm.decode_step(params, priv_cfg, dcache, t,
                                      {"tokens": tok}),
               kernels=SLICE7_KERNELS)
    del servers, client, plane, table, params, plain, dcache
    return dict(total)


#: slice 8 runs the other decoder families at their full published
#: configurations of the port's registry (src/repro_torch/configs/), bf16,
#: on synthetic weights from ``--seed``: (arch, layers kept or None for
#: all, prompt tokens, published fields the configuration must carry).
#: Moonlight keeps 24 of its 48 layers (57.8 GB of bf16 weights at 48
#: leave under 5 GB of 80 for the table, its set-up and activations);
#: no width is cut. MiniCPM3's 640-token prompts pass one 512-key block
#: of ``flash_attention``; Mamba2's and Hymba's 320 are one full
#: 256-token SSD chunk and a padded one.
SLICE8_FAMILIES = (
    ("minicpm3_4b", None, 640,
     dict(n_layers=62, d_model=2560, n_heads=40, d_ff=6400,
          vocab_size=73448, attn_type="mla", q_lora_rank=768,
          kv_lora_rank=256, qk_nope_head_dim=64, qk_rope_head_dim=32,
          v_head_dim=64)),
    ("granite_moe_3b_a800m", None, 64,
     dict(n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
          vocab_size=49155, family="moe", n_experts=40, top_k=8)),
    ("moonshot_v1_16b_a3b", 24, 64,
     dict(n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
          vocab_size=163840, family="moe", n_experts=64, top_k=6,
          n_shared_experts=2)),
    ("mamba2_2_7b", None, 320,
     dict(n_layers=64, d_model=2560, vocab_size=50280, family="ssm",
          ssm_state=128, ssm_head_dim=64, ssm_chunk=256)),
    ("hymba_1_5b", None, 320,
     dict(n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
          vocab_size=32001, hybrid_ssm=True, ssm_state=16, ssm_head_dim=64)),
)
SLICE8_BATCH, SLICE8_NEW, SLICE8_PROFILED_NEW = 4, 32, 8
SLICE8_KERNELS = ("share_onehot", "ss_matmul_tall")
#: the families whose decode is held to forward in float32 at full width
#: (atol 1e-4 / rtol 1e-4, the CPU tests' float32 bound): the two the
#: reference's own test holds (in bf16 at smoke width), MLA's absorbed
#: decode against its expanded forward, and slice 9's two (the cross
#: cache, the prefix's positions). In bf16 at full width the logits of one
#: position move by up to ~0.2 between two lengths of the same forward
#: (the noise floor logged below), more than atol 0.12 / rtol 0.05 allows,
#: so the bf16 errors are logged, not held. The MoE models are not held:
#: a near-tie in routing may pick another expert.
DECODE_HELD = ("minicpm3_4b", "mamba2_2_7b", "hymba_1_5b",
               "seamless_m4t_medium", "internvl2_76b")
#: float32 decode against float32 forward (see DECODE_HELD)
F32_ATOL = F32_RTOL = 1e-4
#: layers of the float32 decode check where the float32 weights of the
#: path's layers do not fit (InternVL2's 20 would take 77 GB); no width
#: is cut
F32_LAYERS = {"internvl2_76b": 2}
#: columns of the table a plain contraction takes at a time in the kernel
#: check (columns are independent; the plain version's float64 limbs of a
#: whole 128,256 x 8,192 table would take ~34 GB each)
PLAIN_COLS = 1024

#: slice 9 runs the encoder-decoder and the ViT-prefixed families of the
#: port's registry, bf16, synthetic weights and frontend inputs from
#: ``--seed``: (arch, layers kept or None, prompt tokens, published fields,
#: (frontend input, its length)). SeamlessM4T-medium runs in full: 4
#: requests of 640 audio frames (stacked 80-dim fbank at a 20 ms stride:
#: 12.8 s of speech; past one 512-key block in the encoder and the
#: cross-attention) and a 2-token decoder prompt (``</s>`` and the
#: target-language tag). InternVL2-76B keeps 20 of its 80 layers (80 are
#: ~141 GB of bf16 weights; at 20, 38.4 GB of weights, its 16.8 GB table
#: shares and their ~28 GB set-up transient leave ~13 GB of 80), with 256
#: patch embeddings of InternViT-6B's width 3,200 (one 448 x 448 tile
#: after the pixel shuffle) and 64 text tokens a request; no width is cut.
SLICE9_FAMILIES = (
    ("seamless_m4t_medium", None, 2,
     dict(n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16,
          n_kv_heads=16, d_ff=4096, vocab_size=256206, family="encdec",
          frontend="audio", frontend_dim=160), ("frames", 640)),
    ("internvl2_76b", 20, 64,
     dict(n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
          vocab_size=128256, family="vlm", frontend="vit", n_prefix=256,
          frontend_dim=3200, rope_theta=500000.0), ("patches", 256)),
)
SLICE9_KERNELS = ("share_onehot", "ss_matmul_tall")


def moe_dispatch_check(torch, args) -> float:
    """The MoE sort dispatch against the einsum dispatch on the card, at
    the granite smoke configuration with capacity 8.0 (no token dropped),
    bf16, within the reference's atol 0.06. Returns the largest
    difference."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import lm

    cfg_e = dataclasses.replace(configs.smoke("granite_moe_3b_a800m"),
                                capacity_factor=8.0)
    cfg_s = dataclasses.replace(cfg_e, moe_dispatch="sort")
    params = lm.init_params(args.seed, cfg_e)
    toks = torch.as_tensor(np.random.default_rng(args.seed).integers(
        0, cfg_e.vocab_size, (2, 16)), device=params["embed"].device)
    le = lm.forward(params, cfg_e, {"tokens": toks})
    ls = lm.forward(params, cfg_s, {"tokens": toks})
    err = float((le - ls).abs().max())
    check(bool(torch.isfinite(le).all()) and err <= 0.06,
          f"slice 8: the MoE sort dispatch differs from the einsum one on "
          f"the card by {err} (atol 0.06)")
    return err


class FrontendServer:
    """``BatchServer``'s greedy loop (``lm.prefill``, then one
    ``lm.decode_step`` a token) with the frontend inputs ``extra``
    (``frames`` or ``patches``, (B, n, frontend_dim)) in the prefill's
    batch, which ``BatchServer`` does not pass (it serves tokens only, as
    the reference's). A ViT prefix's positions count in ``cache_len``."""

    def __init__(self, params, cfg, *, max_len: int, extra: dict):
        self.params, self.cfg, self.max_len = params, cfg, max_len
        self.extra = extra
        self.prefix = (extra["patches"].shape[1] if "patches" in extra
                       else 0)

    def serve(self, requests):
        import torch

        from repro_torch.models import lm
        t0 = time.time()
        prompts = np.stack([r.prompt for r in requests])
        b, t = prompts.shape
        max_new = max(r.max_new for r in requests)
        pos = self.prefix + t
        check(pos + max_new - 1 <= self.max_len,
              f"{pos} positions + {max_new} new exceed max_len "
              f"{self.max_len}")
        dev = self.params["final_norm"].device
        with torch.no_grad():
            logits, cache = lm.prefill(
                self.params, self.cfg,
                {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                           device=dev), **self.extra},
                max_len=self.max_len)
            gen = torch.empty((b, max_new), dtype=torch.int64, device=dev)
            toks = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            gen[:, :1] = toks
            for i in range(max_new - 1):
                logits, cache = lm.decode_step(self.params, self.cfg, cache,
                                               pos + i, {"tokens": toks})
                toks = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
                gen[:, i + 1:i + 2] = toks
        out = gen.cpu().numpy().astype(np.int32)
        dt = time.time() - t0
        for i, r in enumerate(requests):
            r.out = out[i, :r.max_new]
            r.latency_s = dt
        return requests


def dequantized(torch, embed, rows: int = 16384):
    """The table as the private route opens it (quantized to the field and
    back, in ``embed``'s dtype), a block of rows at a time: the whole
    table's int64 transients of ``dequantize_from_field`` would take ~30
    GB at InternVL2's 128,256 x 8,192."""
    from repro_torch.core.queries import embed as eq
    out = torch.empty_like(embed)
    for lo in range(0, embed.shape[0], rows):
        out[lo:lo + rows] = eq.dequantize_from_field(eq.quantize_to_field(
            embed[lo:lo + rows], device=embed.device)).to(embed.dtype)
    return out


def family_path(torch, args, idx, arch, layers, t, fields, frontend=None,
                slice_no=8):
    """Slice 8 or 9, one family: the full published configuration ``arch``
    (``layers`` kept when not None) on synthetic weights from ``--seed``,
    the table shared once (c = 4, degree 1) into ``params["embed_shares"]``,
    then greedy generation of SLICE8_BATCH requests of ``t`` prompt tokens
    and SLICE8_NEW new ones through (c) a plaintext server over the
    dequantized quantized table and (a) a private one
    (``private_lookup_inline`` a step): ``BatchServer``s, or, with
    ``frontend`` = (``"frames"`` or ``"patches"``, n), ``FrontendServer``s
    whose prefills carry n frontend rows a request from ``--seed``. Fails
    unless the two generate the same tokens, their prefill logits are
    equal, every logit is finite, route (a) launches one ``share_onehot``
    and one contraction a lookup (``ss_matmul_tall`` at a decode step's
    M = 4 and wherever the prefill is tall-skinny, the general
    ``ss_matmul`` where it is not) and route (c) none, each kernel shape
    of route (a) equals its plain version (bit for bit, so its error is
    0; the plain contraction PLAIN_COLS columns at a time), and, for the
    families of DECODE_HELD, decode matches forward in float32 (the bf16
    errors are logged). Logs the lookup kernels' times against their
    bounds at the path's shapes and, for an encoder-decoder, the
    encoder's. Returns (the route windows' launches, the family's
    summary)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.kernels import ss_matmul as ssm
    from repro_torch.launch import BatchServer, Request
    from repro_torch.models import lm
    from repro_torch.models import private_embed as pe

    cfg = configs.full(arch)
    bad = {k: getattr(cfg, k) for k, v in fields.items()
           if getattr(cfg, k) != v}
    check(not bad and cfg.dtype == "bfloat16",
          f"{arch} is not the published configuration: {bad}")
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    priv_cfg = dataclasses.replace(cfg, private_embed=True)
    b, new = SLICE8_BATCH, SLICE8_NEW
    pre = frontend[1] if frontend and frontend[0] == "patches" else 0
    max_len = pre + t + new
    tag = f"slice-{slice_no} {arch}"
    timings, total = {}, collections.Counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()

    def clock(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        timings[name] = time.perf_counter() - t0
        return res

    params = clock("init_params_s", lambda: lm.init_params(args.seed, cfg))
    n_params = sum(v.numel() for v in _leaves(params))
    weights_gb = (torch.cuda.memory_allocated() - held) / 1e9
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    table = clock("setup_private_embed_s", lambda: pe.setup_private_embed(
        (args.seed, slice_no, idx), params["embed"], n_shares=EMBED_SHARES))
    setup_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    card_gb = torch.cuda.mem_get_info()[1] / 1e9
    margin = card_gb - torch.cuda.max_memory_allocated() / 1e9
    params["embed_shares"] = table.values
    plain = {k: v for k, v in params.items() if k != "embed_shares"}
    plain["embed"] = dequantized(torch, params["embed"])
    log(f"{tag}: {cfg.n_layers} layers, {n_params} parameters "
        f"({weights_gb:.3f} GB) drawn in {timings['init_params_s']:.3f} s; "
        f"table shared over {EMBED_SHARES} clouds "
        f"({table.values.numel() * 4 / 1e9:.3f} GB) in "
        f"{timings['setup_private_embed_s']:.3f} s, set-up peak "
        f"{setup_peak:.3f} GB above the weights, {margin:.3f} GB of the "
        f"card's {card_gb:.3f} left at that peak")
    rng = np.random.default_rng(args.seed + slice_no + idx)
    prompts = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    dev = params["final_norm"].device
    prompt_t = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    extra = {}
    if frontend is not None:
        name, n = frontend
        extra[name] = torch.as_tensor(rng.standard_normal(
            (b, n, cfg.frontend_dim)), dtype=torch.float32).to(dev)

    def serve(server, n_new):
        reqs = [Request(prompt=p.copy(), max_new=n_new) for p in prompts]
        return np.stack([r.out for r in server.serve(reqs)])

    def window(route, server):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        serve(server, 2)                         # warm-up, untimed
        clock(f"{route}_prefill_s", lambda: serve(server, 1))
        toks = clock(f"{route}_generate_s", lambda: serve(server, new))
        torch.cuda.synchronize()
        got = ops.launch_counts()
        total.update(got)
        log(f"{tag} route {route} launches {got}")
        check_onehot_quad(ops, f"{tag} route {route}")
        return toks, got

    def server(p, c):
        if extra:
            return FrontendServer(p, c, max_len=max_len, extra=extra)
        return BatchServer(p, c, max_len=max_len)

    servers = {"a": server(params, priv_cfg), "c": server(plain, cfg)}
    t_phase = time.perf_counter()
    toks_c, launch_c = window("c", servers["c"])
    toks_a, launch_a = window("a", servers["a"])
    timings["windows_s"] = time.perf_counter() - t_phase
    log(f"{tag} tokens of request 0: {toks_a[0].tolist()}")
    check(toks_a.shape == (b, new) and np.array_equal(toks_a, toks_c),
          f"{tag}: routes (a) and (c) generated different tokens")
    # 3 prefill lookups (M = b·t) and SLICE8_NEW decode ones (M = b) a
    # window: warm-up (2 new), prefill only (1), the full generation
    lookups = 3 + new
    pre_tall = ssm.is_tall_skinny(b * t, cfg.vocab_size, cfg.d_model)
    check(ssm.is_tall_skinny(b, cfg.vocab_size, cfg.d_model),
          f"{tag}: a decode step's lookup is not a tall shape")
    want = {"share_onehot": lookups,
            "ss_matmul_tall": new + (3 if pre_tall else 0),
            "ss_matmul": 0 if pre_tall else 3}
    got = {k: launch_a[k] for k in want}
    check(got == want, f"{tag}: route (a) launched {got}, one lookup a "
          f"step wants {want}")
    check(all(launch_c[k] == 0 for k in want),
          f"{tag}: the plaintext route launched a lookup kernel")

    # prefill logits of both routes, decode against forward (not counted)
    t_phase = time.perf_counter()
    batch = {"tokens": prompt_t, **extra}
    la, _ = lm.prefill(params, priv_cfg, batch, max_len=max_len)
    lc, cache = lm.prefill(plain, cfg, batch, max_len=max_len)
    diff = float((la - lc).abs().max())
    check(bool(torch.isfinite(la).all()) and diff == 0.0,
          f"{tag}: the routes' prefill logits differ by {diff}")
    tok = torch.argmax(lc[:, -1], dim=-1, keepdim=True)
    ld, _ = lm.decode_step(plain, cfg, cache, pre + t, {"tokens": tok})
    full = lm.forward(plain, cfg, dict(batch, tokens=torch.cat([prompt_t,
                                                                tok], 1)))
    check(bool(torch.isfinite(full).all() and torch.isfinite(ld).all()),
          f"{tag}: non-finite logits")
    dec_err = float((ld[:, 0] - full[:, pre + t]).abs().max())
    close = bool(torch.allclose(ld[:, 0], full[:, pre + t], atol=0.12,
                                rtol=0.05))
    # the same forward at t and t + 1 tokens, at position t - 1: bf16's
    # noise floor for this model (no decode step involved)
    floor = float((lc[:, 0] - full[:, pre + t - 1]).abs().max())
    log(f"{tag} prefill logits max |d| {diff}; bf16 decode vs forward max "
        f"|d| {dec_err} (within atol 0.12 / rtol 0.05: {close}; logged); "
        f"bf16 forward at {t} vs {t + 1} tokens max |d| {floor}")
    del la, lc, ld, full, cache
    encoder_ms = None
    if "frames" in extra:
        with torch.no_grad():
            encoder_ms = time_ms(torch, lambda: lm._encode(
                plain, cfg, extra["frames"]), 3)
        log(f"{tag} encoder over {tuple(extra['frames'].shape)} frames: "
            f"{encoder_ms} ms")
    path_peak = torch.cuda.max_memory_allocated()
    timings["logit_check_s"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # route (a)'s kernel shapes against their plain versions and timed
    # against their bounds: the one-hot shares at a decode step (M = b)
    # and the prefill (M = b·t), each contracted with the table (tall or
    # general, as ``ops.ss_matmul`` routes it); the plain contraction
    # takes PLAIN_COLS columns of the table at a time
    gen = torch.Generator(device=dev).manual_seed(args.seed + slice_no + idx)
    c, v, d = table.values.shape
    kernel_ms = {}
    for m in (b, b * t):
        mtoks = torch.randint(0, v, (m,), generator=gen, device=dev)
        a1 = rand_field(torch, gen, (m, v), dev)
        shared = ops.share_onehot(mtoks, a1, n_shares=c)
        want_sh = ssm.share_onehot_plain(mtoks, a1, n_shares=c)
        torch.cuda.synchronize()
        check(torch.equal(shared, want_sh), f"{tag}: share_onehot at "
              f"{tuple(shared.shape)} differs from its plain version")
        del want_sh
        name = ("ss_matmul_tall" if ssm.is_tall_skinny(m, v, d)
                else "ss_matmul")
        got_mm = ops.ss_matmul(shared, table.values)
        plain_ms = 0.0
        for lo in range(0, d, PLAIN_COLS):
            cols = table.values[..., lo:lo + PLAIN_COLS]
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            want_mm = ssm.ss_matmul_plain(shared, cols)
            stop.record()
            torch.cuda.synchronize()
            plain_ms += start.elapsed_time(stop)
            check(torch.equal(got_mm[..., lo:lo + PLAIN_COLS], want_mm),
                  f"{tag}: {name} at M = {m}, columns {lo}.. differ from "
                  f"its plain version")
            del want_mm
        del got_mm
        onehot_ms = time_ms(torch, lambda: ops.share_onehot(
            mtoks, a1, n_shares=c), 5)
        mm_ms = time_ms(torch, lambda: ops.ss_matmul(shared, table.values),
                        5)
        mm_bytes = 4 * (c * m * v + c * v * d + c * m * d)
        mm_ops = 32 * c * m * v * d
        onehot_bound = bound(4 * (m * v + m + c * m * v), (c + 1) * m * v)
        kernel_ms[f"M={m}"] = {
            "share_onehot_ms": onehot_ms, "share_onehot_bound": onehot_bound,
            f"{name}_ms": mm_ms, f"{name}_plain_ms": plain_ms,
            f"{name}_bound": bound(mm_bytes, mm_ops, INT8_TENSOR_OPS_PER_S)}
        log(f"{tag} share_onehot {(c, m, v)}: {onehot_ms} ms, bound "
            f"{onehot_bound}; {name} {(c, m, v)} @ {(c, v, d)}: {mm_ms} ms, "
            f"plain {plain_ms} ms, bound "
            f"{bound_note(mm_bytes, mm_ops, INT8_TENSOR_OPS_PER_S)}")
        del shared, a1
    timings["kernel_check_s"] = time.perf_counter() - t_phase
    log(f"{tag} kernels == plain versions: share_onehot and the table "
        f"contraction at M = {b} and {b * t} "
        f"({'tall' if pre_tall else 'general'} at the prefill)")

    # the card's idle share over a generation of SLICE8_PROFILED_NEW
    # tokens a route: 1 - its device time under torch.profiler / the host
    # seconds of the same generation unprofiled (a whole SLICE8_NEW-token
    # generation yields ~10^6 profiler events, slower to sum than to run)
    t_phase = time.perf_counter()
    split_dev = {}
    for r in "ac":
        clock(f"{r}_profiled_run_s",
              lambda: serve(servers[r], SLICE8_PROFILED_NEW))
        sp = device_split(torch, lambda: serve(servers[r],
                                               SLICE8_PROFILED_NEW))
        sp["idle_share"] = 1.0 - (sp["ss_matmul_ms"] + sp["other_ms"]) / (
            1e3 * timings[f"{r}_profiled_run_s"])
        split_dev[r] = sp
    timings["device_split_s"] = time.perf_counter() - t_phase
    summary = {
        "layers": cfg.n_layers, "parameters": n_params,
        "weights_gb": weights_gb,
        "setup_s": {k: timings[k] for k in
                    ("init_params_s", "setup_private_embed_s")},
        "setup_peak_gb": setup_peak,
        "prefill_ms": {r: 1e3 * timings[f"{r}_prefill_s"] for r in "ac"},
        "decode_ms_per_step": {r: 1e3 * (timings[f"{r}_generate_s"]
                                         - timings[f"{r}_prefill_s"])
                               / (new - 1) for r in "ac"},
        "tokens_per_s": {r: b * new / timings[f"{r}_generate_s"]
                         for r in "ac"},
        "idle_share": {r: sp["idle_share"] for r, sp in split_dev.items()},
        "device_ms": split_dev,
        "decode_vs_forward": dec_err, "bf16_noise_floor": floor,
        "peak_gb": path_peak / 1e9, "setup_margin_gb": margin,
        "encoder_ms": encoder_ms, "kernels": kernel_ms}
    log(f"{tag} summary " + json.dumps(summary))
    del servers, table, params, plain
    if arch in DECODE_HELD:
        f32_cfg = dataclasses.replace(cfg, n_layers=F32_LAYERS.get(
            arch, cfg.n_layers))
        summary["f32_decode_vs_forward"] = clock(
            "f32_check_s", lambda: f32_decode_check(torch, args, f32_cfg,
                                                    batch, pre, tag))
    summary["phase_s"] = {k: v for k, v in timings.items()
                          if k.endswith("check_s") or k.endswith("split_s")
                          or k.endswith("windows_s")}
    log(f"{tag} phases " + json.dumps(summary["phase_s"]))
    return dict(total), summary


def f32_decode_check(torch, args, cfg, batch, pre, tag) -> float:
    """``cfg`` in float32 (weights drawn from ``--seed``, no table): one
    decode step after the prompt ``batch`` (its frontend inputs included;
    a ViT prefix of ``pre`` positions) against the full forward at that
    position, within F32_ATOL / F32_RTOL. Returns the largest
    difference."""
    import dataclasses

    from repro_torch.models import lm

    f32 = dataclasses.replace(cfg, dtype="float32")
    gc.collect()
    torch.cuda.empty_cache()
    params = lm.init_params(args.seed, f32)
    pos = pre + batch["tokens"].shape[1]
    logits, cache = lm.prefill(params, f32, batch, max_len=pos + 1)
    tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
    ld, _ = lm.decode_step(params, f32, cache, pos, {"tokens": tok})
    full = lm.forward(params, f32, dict(batch, tokens=torch.cat(
        [batch["tokens"], tok], 1)))
    err = float((ld[:, 0] - full[:, pos]).abs().max())
    check(bool(torch.isfinite(full).all()) and torch.allclose(
        ld[:, 0], full[:, pos], atol=F32_ATOL, rtol=F32_RTOL),
        f"{tag}: float32 decode_step differs from forward (max |d| {err}, "
        f"atol {F32_ATOL}, rtol {F32_RTOL})")
    log(f"{tag} float32 decode vs forward max |d| {err} (atol {F32_ATOL}, "
        f"rtol {F32_RTOL}; {cfg.n_layers} layers)")
    del params, cache, ld, full, logits
    gc.collect()
    torch.cuda.empty_cache()
    return err


def families_path(torch, args, families=SLICE8_FAMILIES):
    """Phase 3, slice 8 (after slice 7, on a freed card): the MoE dispatch
    check at smoke width, then :func:`family_path` for each family, its
    parameters freed before the next starts. Returns the launches of the
    route windows, summed over the families."""
    moe_err = moe_dispatch_check(torch, args)
    log(f"slice-8 MoE sort vs einsum dispatch at capacity 8.0: max |d| "
        f"{moe_err} (atol 0.06)")
    total = collections.Counter()
    t0 = time.perf_counter()
    for idx, (arch, layers, t, fields) in enumerate(families):
        got, _ = family_path(torch, args, idx, arch, layers, t, fields)
        total.update(got)
    for name in SLICE8_KERNELS:
        check(total[name] > 0, f"slice 8 launched no {name}")
    log(f"slice-8 launches {dict(total)} in "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(total)


def slice9_path(torch, args):
    """Phase 3, slice 9 (after slice 8, on a freed card): the
    encoder-decoder and the ViT-prefixed families (SLICE9_FAMILIES), each
    through :func:`family_path` with its frontend input, its parameters
    freed before the next starts. Returns the launches of the route
    windows, summed over the families."""
    total = collections.Counter()
    t0 = time.perf_counter()
    for idx, (arch, layers, t, fields, frontend) in enumerate(
            SLICE9_FAMILIES):
        got, _ = family_path(torch, args, idx, arch, layers, t, fields,
                             frontend=frontend, slice_no=9)
        total.update(got)
    for name in SLICE9_KERNELS:
        check(total[name] > 0, f"slice 9 launched no {name}")
    log(f"slice-9 launches {dict(total)} in "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(total)


#: slice 10 trains the full Qwen1.5-4B configuration of the port's registry
#: (40 layers, d 2,560, V 151,936, untied head, bf16, remat on) on
#: synthetic weights from ``--seed`` and ``TokenStream`` batches of 4 x 512
#: tokens (2,048 a step), AdamW at lr 3e-4 with 2 warmup steps
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = "qwen1_5_4b", 4, 512, 3e-4
TRAIN_FIELDS = dict(n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
                    d_ff=6912, vocab_size=151936, tie_embeddings=False,
                    dtype="bfloat16", remat=True)
#: t1's steps (through ``launch.train.main``) and t2's / t3's
T1_STEPS, T2_STEPS, T3_STEPS = 4, 2, 2
#: layers and tokens of t1's float32 card-against-CPU check (full width)
F32_TRAIN_LAYERS, F32_TRAIN_TOKENS = 2, (2, 64)
F32_TRAIN_TOL = 1e-4
#: GB t3 must leave free on the card at its predicted peak, and its cut
T3_MARGIN_GB, T3_CUT_LAYERS = 5.0, 20
SLICE10_KERNELS = ("share_onehot", "ss_matmul")


def train_cfg(torch):
    """The full Qwen1.5-4B configuration, checked against its published
    fields."""
    from repro_torch import configs
    cfg = configs.full(TRAIN_ARCH)
    bad = {k: getattr(cfg, k) for k, v in TRAIN_FIELDS.items()
           if getattr(cfg, k) != v}
    check(not bad, f"slice 10: {TRAIN_ARCH} is not the published "
          f"configuration: {bad}")
    return cfg


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


def train_kernel_kind(name: str) -> str:
    """A profiled kernel's kind by its name: matrix products (cuBLAS's
    ``nvjet``/``gemm``/``cutlass`` kernels), elementwise, reductions, or
    other (copies, index and scatter kernels, the log-softmax)."""
    low = name.lower()
    if any(k in low for k in ("nvjet", "gemm", "cutlass", "sm90_xmma")):
        return "matmul"
    if "elementwise" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduce"
    return "other"


def train_t1(torch, args, cfg):
    """t1: ``launch.train.main`` for T1_STEPS steps at full width. Checks
    finite losses, grad_norm > 0, ``lr`` = ``schedule(step + 1)``, the
    final norm moved off its zero init and a layer's weights moved
    between the first and last step. Times steps 1 and 3 (host clock
    between synchronizes), profiles step 2 (``torch.profiler`` device
    time) for the idle share, and reads the peak memory."""
    from repro_torch.launch import train as train_launcher
    from repro_torch.train import AdamWConfig
    from repro_torch.train.optim import schedule
    from torch.profiler import ProfilerActivity, profile

    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=max(2, T1_STEPS // 10),
                      total_steps=T1_STEPS)
    marks, rec, snap, prof = [], [], {}, {}

    def on_step(step, params, opt_state, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if step == T1_STEPS - 1:         # kept for slice 12
            snap["state"] = (params, opt_state)
        m = {k: float(v) for k, v in metrics.items()}
        want_lr = float(schedule(opt, step + 1))
        rec.append(m)
        check(math.isfinite(m["loss"]) and m["grad_norm"] > 0
              and abs(m["lr"] - want_lr) <= 1e-6 * want_lr,
              f"slice 10 t1 step {step}: {m} (lr should be {want_lr})")
        w = params["blocks"]["mlp"]["w_up"][0, :8, :64]
        if step == 0:
            snap["w_up"] = w.clone()
            check(bool((params["final_norm"] != 0).any()),
                  "slice 10 t1: final_norm did not move off its init")
        if step == 1:
            prof["p"] = profile(activities=[ProfilerActivity.CUDA])
            prof["p"].__enter__()
        if step == 2:
            prof["p"].__exit__(None, None, None)
        if step == T1_STEPS - 1:
            check(not torch.equal(w, snap["w_up"]),
                  "slice 10 t1: layer 0's w_up did not move")

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final = train_launcher.main(
        ["--arch", TRAIN_ARCH, "--steps", str(T1_STEPS), "--batch",
         str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR),
         "--log-every", "1", "--seed", str(args.seed)], on_step=on_step)
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(len(rec) == T1_STEPS and final == rec[-1]["loss"],
          "slice 10 t1: main did not run every step")
    step_s = [b - a for a, b in zip(marks, marks[1:])]   # steps 1..3
    plain_ms = 1e3 * (step_s[0] + step_s[2]) / 2         # 2 is profiled
    kinds, launches = collections.Counter(), 0
    by_name = collections.Counter()
    for e in prof["p"].key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if not us:
            continue
        launches += e.count
        by_name[e.key[:60]] += us / 1e3
        kinds[train_kernel_kind(e.key)] += us / 1e3
    device_ms = sum(kinds.values())
    top = by_name.most_common(5)
    out = {"losses": [r["loss"] for r in rec],
           "grad_norms": [r["grad_norm"] for r in rec],
           "lrs": [r["lr"] for r in rec],
           "ms_per_step": plain_ms, "step_ms": [1e3 * s for s in step_s],
           "first_step_and_init_s": marks[0] - t0, "main_s": total_s,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (plain_ms / 1e3),
           "peak_gb": peak, "profiled_step_device_ms": device_ms,
           "idle_share": 1.0 - device_ms / plain_ms,
           "profiled_step_kernels": launches,
           "device_ms_by_kind": dict(kinds),
           "slowest_kernels_ms": top}
    log("slice-10 t1 (launch.train.main, plaintext) " + json.dumps(out))
    # slice 12: one more step of t1's model and optimizer state, priced
    from repro_torch.data import make_lm_batches
    from repro_torch.data.pipeline import to_device
    from repro_torch.train import make_train_step
    params, opt_state = snap.pop("state")
    step_fn = make_train_step(cfg, opt)
    batch = to_device(make_lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                      seed=args.seed).batch_at(T1_STEPS),
                      params["final_norm"].device)
    price_step(torch, f"slice-10 t1 {TRAIN_ARCH} train step "
               f"({TRAIN_BATCH} x {TRAIN_SEQ} tokens)",
               lambda: step_fn(params, opt_state, batch))
    del params, opt_state, batch, step_fn
    return out


def f32_train_check(torch, args, cfg):
    """t1's float32 check: F32_TRAIN_LAYERS layers at full width, one
    step's loss and gradients on the card against the same port code on
    the CPU (weights drawn on the card, copied to the host): loss within
    F32_TRAIN_TOL, each leaf's gradient within a relative F32_TRAIN_TOL.
    Returns the largest differences."""
    import dataclasses

    from repro_torch import _tree
    from repro_torch.data import TokenStream
    from repro_torch.models import lm
    from repro_torch.train import step as tstep

    check(not torch.backends.cuda.matmul.allow_tf32,
          "slice 10: TF32 matmuls are on; the float32 check needs them off")
    f32 = dataclasses.replace(cfg, n_layers=F32_TRAIN_LAYERS,
                              dtype="float32")
    _free(torch)
    params = lm.init_params(args.seed, f32)
    host = _tree.map_leaves(lambda t: t.cpu(), params)
    b, t = F32_TRAIN_TOKENS
    batch = TokenStream(f32.vocab_size, b, t, seed=args.seed).batch_at(7)
    out = {}
    for name, p in (("card", params), ("cpu", host)):
        dev = p["final_norm"].device
        tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        loss, grads = tstep._grads(f32, p, tstep._trainable(p), tb)
        out[name] = (float(loss), [g.cpu() for g in grads],
                     time.perf_counter() - t0)
        del grads
    names = [n for n, v in _tree.leaves_with_paths(host)]
    loss_err = abs(out["card"][0] - out["cpu"][0])
    rel = {}
    for n, gc_, gh in zip(names, out["card"][1], out["cpu"][1]):
        den = float(gh.norm()) or 1.0
        rel[n] = float((gc_ - gh).norm()) / den
    worst = max(rel, key=rel.get)
    check(loss_err <= F32_TRAIN_TOL and rel[worst] <= F32_TRAIN_TOL,
          f"slice 10: float32 step on the card differs from the CPU: loss "
          f"{out['card'][0]} vs {out['cpu'][0]}, gradient {worst} relative "
          f"{rel[worst]} (tolerance {F32_TRAIN_TOL})")
    res = {"layers": F32_TRAIN_LAYERS, "tokens": [b, t],
           "loss_card": out["card"][0], "loss_cpu": out["cpu"][0],
           "loss_abs_err": loss_err, "worst_grad": worst,
           "worst_grad_rel_err": rel[worst],
           "card_s": out["card"][2], "cpu_s": out["cpu"][2]}
    log("slice-10 float32 card vs CPU " + json.dumps(res))
    del params, host, out
    _free(torch)
    return res


def train_t2(torch, args, cfg, errs):
    """t2: ``private_embed=True`` through ``make_train_step``, T2_STEPS
    steps at full width. Each step's forward re-shares the table (c = 4)
    and launches one ``share_onehot`` and one ``ss_matmul`` (2,048 rows:
    not tall), counted from zero just before the step and read after a
    synchronize. One step's embeddings must equal the dequantized table's
    rows exactly, and the untied ``embed`` (no gradient) must decay by
    the AdamW rule on a zero gradient. Then, on a freed card, both kernels
    at these shapes against their plain versions (the contraction
    PLAIN_COLS columns at a time), and timed. Returns (launches,
    summary)."""
    import dataclasses

    from repro_torch.core.queries import embed as eq
    from repro_torch.data import TokenStream
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels import ops
    from repro_torch.kernels import ss_matmul as ssm
    from repro_torch.models import lm
    from repro_torch.models import private_embed as pe
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    pcfg = dataclasses.replace(cfg, private_embed=True)
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=T2_STEPS)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params((args.seed, 10, 2), pcfg)
    state = init_state(params)
    step_fn = make_train_step(pcfg, opt)
    stream = TokenStream(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                         seed=args.seed)
    seen = {}
    inner = pe.private_lookup_inline

    def recording(p, c, tokens, **kw):
        out = inner(p, c, tokens, **kw)
        seen["emb"] = out.clone()
        return out

    total = collections.Counter()
    rec = []
    pe.private_lookup_inline = recording
    try:
        for i in range(T2_STEPS):
            batch = stream.batch_at(i)
            dev_batch = to_device(batch, params["embed"].device)
            toks = dev_batch["tokens"].long()
            rows = params["embed"][toks].clone()
            probe = params["embed"][:64].clone()
            _free(torch)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, dev_batch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            got = ops.launch_counts()
            total.update(got)
            check_onehot_quad(ops, f"slice 10 t2 step {i}")
            want = {k: (1 if k in SLICE10_KERNELS else 0) for k in got}
            check(got == want, f"slice 10 t2 step {i}: launched {got}, "
                  f"one lookup a step wants {want}")
            m = {k: float(v) for k, v in m.items()}
            check(math.isfinite(m["loss"]) and m["grad_norm"] > 0,
                  f"slice 10 t2 step {i}: {m}")
            want_emb = eq.dequantize_from_field(eq.quantize_to_field(
                rows, device=rows.device)).to(rows.dtype)
            check(torch.equal(seen["emb"], want_emb),
                  f"slice 10 t2 step {i}: the private embeddings differ "
                  f"from the dequantized table's rows")
            pf = probe.float()
            delta = torch.zeros_like(pf).add_(pf, alpha=opt.weight_decay)
            decayed = (pf - torch.tensor(m["lr"], device=pf.device)
                       * delta).to(probe.dtype)
            # in bf16 a decay of lr·wd ~ 3e-5 mostly rounds back to the
            # stored value; the rule, not a visible change, is checked
            check(torch.equal(params["embed"][:64], decayed)
                  and not bool(state.m["embed"].any()),
                  f"slice 10 t2 step {i}: the untied embed got a gradient "
                  f"or did not decay as a zero-gradient AdamW leaf")
            moved = int((params["embed"][:64] != probe).sum())
            rec.append(dict(m, step_s=step_s, embed_probe_moved=moved))
    finally:
        pe.private_lookup_inline = inner
    peak = torch.cuda.max_memory_allocated() / 1e9
    probe_dev = probe.device
    del params, state, seen, rows, probe
    _free(torch)

    # the kernels at t2's shapes, on a freed card
    dev = probe_dev
    gen = torch.Generator(device=dev).manual_seed(args.seed + 10)
    c, v, d = EMBED_SHARES, cfg.vocab_size, cfg.d_model
    mrows = TRAIN_BATCH * TRAIN_SEQ
    toks = torch.randint(0, v, (mrows,), generator=gen, device=dev)
    a1 = rand_field(torch, gen, (mrows, v), dev)
    shared = ops.share_onehot(toks, a1, n_shares=c)
    want_sh = ssm.share_onehot_plain(toks, a1, n_shares=c)
    torch.cuda.synchronize()
    check(torch.equal(shared, want_sh), "slice 10: share_onehot at "
          f"{(c, mrows, v)} differs from its plain version")
    errs["share_onehot"] = max(errs["share_onehot"],
                               max_err(torch, shared, want_sh))
    del want_sh
    onehot_ms = time_ms(torch, lambda: ops.share_onehot(toks, a1,
                                                        n_shares=c), 5)
    del a1
    table = rand_field(torch, gen, (c, v, d), dev)
    check(not ssm.is_tall_skinny(mrows, v, d),
          "slice 10: the train lookup should not be tall")
    got_mm = ops.ss_matmul(shared, table)
    plain_ms = 0.0
    for lo in range(0, d, PLAIN_COLS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        want_mm = ssm.ss_matmul_plain(shared, table[..., lo:lo + PLAIN_COLS])
        stop.record()
        torch.cuda.synchronize()
        plain_ms += start.elapsed_time(stop)
        check(torch.equal(got_mm[..., lo:lo + PLAIN_COLS], want_mm),
              f"slice 10: ss_matmul at M = {mrows}, columns {lo}.. differs "
              f"from its plain version")
        errs["ss_matmul"] = max(errs["ss_matmul"],
                                max_err(torch, got_mm[..., lo:lo + PLAIN_COLS],
                                        want_mm))
        del want_mm
    del got_mm
    mm_ms = time_ms(torch, lambda: ops.ss_matmul(shared, table), 3)
    mm_bytes = 4 * (c * mrows * v + c * v * d + c * mrows * d)
    mm_ops = 32 * c * mrows * v * d
    summary = {
        "steps": rec, "peak_gb": peak,
        "launches": dict(total),
        "share_onehot": {"shape": [c, mrows, v], "ms": onehot_ms,
                         "bound": bound(4 * (mrows * v + mrows
                                             + c * mrows * v),
                                        (c + 1) * mrows * v)},
        "ss_matmul": {"shape": [c, mrows, v, d], "ms": mm_ms,
                      "plain_ms": plain_ms,
                      "bound": bound(mm_bytes, mm_ops,
                                     INT8_TENSOR_OPS_PER_S)}}
    log("slice-10 t2 (private embedding, make_train_step) "
        + json.dumps(summary))
    del shared, table
    _free(torch)
    return dict(total), summary


def train_t3(torch, args, cfg):
    """t3: ``grad_accum = 2`` (2 x 2 x 512) with ``compress=True``,
    T3_STEPS steps: finite losses, and every gradient element the
    compression touched within its block's bound (half its int8 step, plus
    float32 rounding), checked on the first 2^20 elements of every leaf.
    Keeps 40 layers if the predicted peak leaves T3_MARGIN_GB of the card,
    else T3_CUT_LAYERS."""
    import dataclasses

    from repro_torch.data import TokenStream
    from repro_torch.data.pipeline import to_device
    from repro_torch.models import lm
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    from repro_torch.train import compress as tcomp
    from repro_torch.train import step as tstep

    card_gb = torch.cuda.mem_get_info()[1] / 1e9
    weights_gb = cfg.param_count() * 2 / 1e9
    # bf16 weights, float32 m and v, the float32 accumulator, one
    # microbatch's bf16 gradients, ~3 GB of activations and logits
    predicted = weights_gb * (1 + 4 + 2 + 1) + 3.0
    layers = cfg.n_layers if predicted <= card_gb - T3_MARGIN_GB \
        else T3_CUT_LAYERS
    c3 = dataclasses.replace(cfg, n_layers=layers)
    log(f"slice-10 t3: predicted peak {predicted:.2f} GB of the card's "
        f"{card_gb:.2f}: {layers} layers")
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=T3_STEPS)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params((args.seed, 10, 3), c3)
    state = init_state(params)
    step_fn = make_train_step(c3, opt, grad_accum=2, compress=True)
    stream = TokenStream(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                         seed=args.seed)
    worst = {"ratio": 0.0, "leaves": 0}
    inner = tcomp.roundtrip_

    def checked(g):
        n = min(g.numel(), 1 << 20) // tcomp.BLOCK * tcomp.BLOCK \
            or g.numel()
        before = g.reshape(-1)[:n].clone()
        out = inner(g)
        after = out.reshape(-1)[:n]
        pad = (-n) % tcomp.BLOCK
        blk = torch.nn.functional.pad(before, (0, pad)).view(-1,
                                                             tcomp.BLOCK)
        scale = blk.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
        err = torch.nn.functional.pad((after - before).abs(),
                                      (0, pad)).view(-1, tcomp.BLOCK)
        ratio = float((err / scale).max())
        worst["ratio"] = max(worst["ratio"], ratio)
        worst["leaves"] += 1
        check(ratio <= 0.5 + 2e-5, f"slice 10 t3: a dequantized gradient "
              f"is {ratio} of its block's scale from its input (bound 0.5)")
        return out

    rec = []
    tstep.roundtrip_ = checked
    try:
        for i in range(T3_STEPS):
            batch = stream.batch_at(100 + i)
            batch = {k: a.reshape((2, -1) + a.shape[1:])
                     for k, a in batch.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step_fn(
                params, state, to_device(batch, params["embed"].device))
            torch.cuda.synchronize()
            m = {k: float(v) for k, v in m.items()}
            m["step_s"] = time.perf_counter() - t0
            check(math.isfinite(m["loss"]) and m["grad_norm"] > 0,
                  f"slice 10 t3 step {i}: {m}")
            rec.append(m)
    finally:
        tstep.roundtrip_ = inner
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = {"layers": layers, "predicted_peak_gb": predicted,
           "peak_gb": peak, "card_gb": card_gb, "steps": rec,
           "worst_err_over_scale": worst["ratio"],
           "leaves_checked": worst["leaves"]}
    log("slice-10 t3 (grad_accum 2, int8 compression) " + json.dumps(out))
    del params, state
    _free(torch)
    return out


def train_t4(torch, args):
    """t4: restart through ``launch.train.main`` on the smoke Qwen config
    on the card, checkpoints under ``build/``: run A trains 6 steps
    uninterrupted (checkpoints every 2); run B dies after step 3, a torn
    ``step_4.tmp`` is left beside its step-2 checkpoint, and a restart
    resumes from step 2. B's losses must equal A's, and A's restored
    step-6 tensors must equal A's final ones bit for bit, as must B's."""
    import shutil

    from repro_torch import _tree, configs
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import lm
    from repro_torch.train import init_state

    root = os.path.join(ROOT, "build", "slice10_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    finals = {}

    class Crash(Exception):
        pass

    def run(name, hist, crash_after=None):
        def on_step(step, params, opt_state, metrics):
            hist.append((step, float(metrics["loss"])))
            if step == 5:
                finals[name] = [t.detach().clone() for t in
                                _tree.leaves((params, opt_state))]
            if step == crash_after:
                raise Crash
        return train_launcher.main(
            ["--arch", TRAIN_ARCH, "--smoke", "--steps", "6", "--batch",
             "4", "--seq", "64", "--seed", str(args.seed), "--ckpt-dir",
             os.path.join(root, name), "--ckpt-every", "2",
             "--log-every", "100"], on_step=on_step)

    full, crashed, resumed = [], [], []
    run("a", full)
    try:
        run("b", crashed, crash_after=3)
        check(False, "slice 10 t4: the crash did not happen")
    except Crash:
        pass
    # the step-2 writer thread outlives the crash inside this process
    deadline = time.perf_counter() + 60
    while latest_step(os.path.join(root, "b")) != 2 \
            and time.perf_counter() < deadline:
        time.sleep(0.01)
    os.makedirs(os.path.join(root, "b", "step_4.tmp"))
    check(latest_step(os.path.join(root, "b")) == 2,
          "slice 10 t4: a torn step_4.tmp was taken for a checkpoint")
    run("b", resumed)
    check(crashed == full[:4] and resumed == full[2:],
          f"slice 10 t4: resumed losses {resumed} differ from the "
          f"uninterrupted run's {full}")
    cfg = configs.smoke(TRAIN_ARCH)
    p = lm.init_params(args.seed, cfg)
    tmpl = (p, init_state(p))
    for name in ("a", "b"):
        step, tree = restore_checkpoint(os.path.join(root, name), tmpl,
                                        device=p["embed"].device)
        same = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in
                   zip(_tree.leaves(tree), finals[name]))
        check(step == 6 and same, f"slice 10 t4: run {name}'s restored "
              f"step-6 tensors differ from the saved ones")
    shutil.rmtree(root, ignore_errors=True)
    out = {"losses": [l for _, l in full], "resumed_from": 2,
           "leaves": len(finals["a"])}
    log("slice-10 t4 (restart) " + json.dumps(out))
    return out


def train_path(torch, args, errs):
    """Phase 3, slice 10 (after slice 9, on a freed card): training at the
    full Qwen1.5-4B configuration, t1 to t4 and the float32 check. Returns
    the launches of t2's step windows (t1, t3 and t4 launch no kernel of
    the port: their embeddings are plaintext)."""
    t0 = time.perf_counter()
    cfg = train_cfg(torch)
    phases = {}
    t1 = train_t1(torch, args, cfg)
    phases["t1_s"] = time.perf_counter() - t0
    f32 = f32_train_check(torch, args, cfg)
    phases["f32_s"] = time.perf_counter() - t0 - sum(phases.values())
    launches, t2 = train_t2(torch, args, cfg, errs)
    phases["t2_s"] = time.perf_counter() - t0 - sum(phases.values())
    t3 = train_t3(torch, args, cfg)
    phases["t3_s"] = time.perf_counter() - t0 - sum(phases.values())
    t4 = train_t4(torch, args)
    phases["t4_s"] = time.perf_counter() - t0 - sum(phases.values())
    for name in SLICE10_KERNELS:
        check(launches.get(name, 0) > 0, f"slice 10 launched no {name}")
    summary = {"ms_per_step": t1["ms_per_step"],
               "tokens_per_s": t1["tokens_per_s"],
               "peak_gb": t1["peak_gb"], "idle_share": t1["idle_share"],
               "t2_step_s": [s["step_s"] for s in t2["steps"]],
               "t2_peak_gb": t2["peak_gb"],
               "t3_step_s": [s["step_s"] for s in t3["steps"]],
               "t3_peak_gb": t3["peak_gb"], "t3_layers": t3["layers"],
               "f32_loss_abs_err": f32["loss_abs_err"],
               "f32_worst_grad_rel_err": f32["worst_grad_rel_err"],
               "launches": launches, "phase_s": phases}
    log("slice-10 summary " + json.dumps(summary))
    return launches


#: vocabularies of the families whose lookups phase 4 re-times:
#: SeamlessM4T-medium (slice 9), Granite-3.0-3B-A800M and Hymba-1.5B
#: (slice 8), InternVL2-76B (slice 9); V % 4 = 2, 3, 1 and 0
SEAMLESS_VOCAB, GRANITE_VOCAB, HYMBA_VOCAB, INTERNVL_VOCAB = \
    256206, 49155, 32001, 128256
#: phase 4's share_onehot rows (V, M), c = 4: decode steps (M = 4, 8) of
#: every V % 4, the 256-token prefills of Qwen1.5-4B and InternVL2 and
#: slice 10's 2,048-token training lookup
ONEHOT_ROWS = ((QWEN_VOCAB, 4), (QWEN_VOCAB, 8), (SEAMLESS_VOCAB, 4),
               (SEAMLESS_VOCAB, 8), (GRANITE_VOCAB, 4), (HYMBA_VOCAB, 4),
               (QWEN_VOCAB, 256), (INTERNVL_VOCAB, 256), (QWEN_VOCAB, 2048))
#: a row whose bound is under this is labelled launch-bound: a launch's
#: own fixed cost on the card is of that order
LAUNCH_BOUND_MS = 0.003


def onehot_device_times(torch, args):
    """Phase 4: ``share_onehot`` at ONEHOT_ROWS, int64 tokens, each against
    its plain version and timed by device time (``graph_ms``: the median
    of CUDA-graph replays, so the launcher's host work does not count),
    the device time of the kernels inside those replays by
    ``torch.profiler`` (``graph_kernels``), the host-inclusive figure
    (``time_ms``: 5 back-to-back calls between CUDA events, as slices 8
    and 9 time it) and the bound; each row names the route its launch
    took. Then the device work of one call with int64 and with int32
    tokens: the nodes of a CUDA graph of it (``graph_nodes``) and the
    kernels ``torch.profiler`` lists (``eager_kernels``). A port without
    route counters (an older checkout under ``--onehot-times``) reports
    its route as None. -> (rows, {"int64": {"graph": ..., "profiler":
    ...}, "int32": {...}})."""
    from repro_torch import _device
    from repro_torch.kernels import ops
    from repro_torch.kernels import ss_matmul as ssm

    routes = getattr(ops, "onehot_route_counts", None)
    dev = _device.resolve(None)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    c, rows = EMBED_SHARES, []
    for v, m in ONEHOT_ROWS:
        toks = torch.randint(0, v, (m,), generator=gen, device=dev)
        a1 = rand_field(torch, gen, (m, v), dev)
        before = routes() if routes else None
        got = ops.share_onehot(toks, a1, n_shares=c)
        torch.cuda.synchronize()
        route = None if routes is None else ",".join(
            k for k, n in routes().items() if n > before[k])
        check(torch.equal(got, ssm.share_onehot_plain(toks, a1,
                                                      n_shares=c)),
              f"share_onehot at {(c, m, v)} differs from its plain version")
        del got

        def call(toks=toks, a1=a1):
            ops.share_onehot(toks, a1, n_shares=c)

        dev_ms, host_us, lo, hi = graph_ms(torch, [call])
        by_kernel, per_call = graph_kernels(torch, [call])
        host_ms = time_ms(torch, call, 5)
        b_ms, b_by = bound(4 * (m * v + m + c * m * v), (c + 1) * m * v)
        rows.append({"m": m, "v": v, "c": c, "route": route,
                     "device_ms": dev_ms, "device_ms_range": [lo, hi],
                     "kernel_ms": by_kernel, "kernels_a_call": per_call,
                     "host_inclusive_ms": host_ms,
                     "launcher_host_us": host_us, "bound_ms": b_ms,
                     "bound_by": b_by, "share_of_bound": b_ms / dev_ms,
                     "launch_bound": b_ms < LAUNCH_BOUND_MS})
        del toks, a1
    log("share_onehot re-timed by device time (CUDA-graph replays) "
        + json.dumps(rows))
    toks = torch.randint(0, QWEN_VOCAB, (4,), generator=gen, device=dev)
    a1 = rand_field(torch, gen, (4, QWEN_VOCAB), dev)
    calls = {}
    for name, t in (("int64", toks), ("int32", toks.int())):
        def one(t=t):
            ops.share_onehot(t, a1, n_shares=c)
        calls[name] = {"graph": graph_nodes(torch, one),
                       "profiler": eager_kernels(torch, one)}
    log(f"share_onehot device work of one call (M = 4, V = {QWEN_VOCAB}"
        f"): {json.dumps(calls)}")
    return rows, calls


def graph_nodes(torch, fn) -> dict:
    """The device work of one call of ``fn``, read from a CUDA graph of it
    through ``libcuda`` (``cuGraphGetNodes``, ``cuGraphNodeGetType``):
    {"nodes": all nodes, "kernels": kernel nodes}. Unlike a profiler
    trace, it cannot drop an event."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        kernels += kind.value == 0            # CU_GRAPH_NODE_TYPE_KERNEL
    del graph
    return {"nodes": n.value, "kernels": kernels}


def eager_kernels(torch, fn) -> dict:
    """The device kernels (and copies) of one more call of ``fn`` by
    ``torch.profiler``: {name: count}; empty when the profiler sees no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.count for e in prof.key_averages()
            if getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def full_shape_kernels(torch, db, errs, launches):
    """Phase 4: every kernel call form of the main path vs its plain
    version at the path's own shapes, through the ``ops`` wrappers, timed."""
    from repro_torch import _device
    from repro_torch.core import encoding
    from repro_torch.core.partition import split_bounds
    from repro_torch.core.queries import rounds
    from repro_torch.kernels import aa_match as aa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ss_matmul as ssm

    rel = db.relation.values                           # (c, n, m, W, A)
    c, n, m, w, a = rel.shape
    key = (99,)

    def shared(word, col):
        return encoding.share_pattern(
            db.codec, word, n_shares=c, device=rel.device,
            generator=_device.generator(key + (col,), rel.device)).values

    def same(got, want, what):
        check(got.shape == want.shape and torch.equal(got, want),
              f"{what} differs from its plain version")
        errs["aa_match_batch"] = max(errs["aa_match_batch"],
                                     max_err(torch, got, want))

    first = NAMES.index("FirstName")
    col = rel[:, :, first][:, None]                    # count: (c,1,n,W,A)
    pat = shared("Quinn", first)[:, None]
    same(ops.aa_match_batch(col, pat), aa.aa_match_batch_plain(col, pat),
         "aa_match_batch count stack")
    # distinct-column count group of run_batch: (c, 2, n) over the relation
    cols = [first, NAMES.index("Department")]
    pats = torch.stack([shared("Quinn", cols[0]), shared("Legal", cols[1])],
                       dim=1)
    mixed = dict(columns=cols, starts=[0, 0], lengths=[n, n], pat=pats,
                 height=n)
    same(ops.aa_match_rows(rel, **mixed), aa.aa_match_rows_plain(rel, **mixed),
         "aa_match_rows distinct-column count")
    # first tree Q&A round for ℓ = 16: 16 blocks of FirstName, height n/16
    bounds = split_bounds(0, n, 16)
    tree = dict(columns=[first] * len(bounds),
                starts=[s for s, _ in bounds],
                lengths=[e - s for s, e in bounds],
                pat=pat.expand(c, len(bounds), w, a),
                height=max(e - s for s, e in bounds))
    same(ops.aa_match_rows(rel, **tree), aa.aa_match_rows_plain(rel, **tree),
         "aa_match_rows tree round")
    # a one-column stack of 8 predicates: one launch, one read of the column
    words = ["Quinn", "Zorro", "Nobody", "Anna", "Bo", "Carla", "Dmitri",
             "Eve"]
    pats8 = torch.stack([shared(word, first) for word in words], dim=1)
    col8 = col.expand(c, len(words), n, w, a)
    before = ops.launch_counts()["aa_match_batch"]
    same(ops.aa_match_batch(col8, pats8), aa.aa_match_batch_plain(col8, pats8),
         "aa_match_batch one-column stack of 8")
    check(ops.launch_counts()["aa_match_batch"] == before + 1,
          "the one-column stack of 8 was not one launch")
    del pats8
    aa_times = time_aa_shapes(torch, ops, rel)
    for name, (ms, nbytes, nops) in aa_times.items():
        bound_ms, _ = bound(nbytes, nops)
        note = bound_note(nbytes, nops, INT32_OPS_PER_S)
        log(f"{name}: {ms} ms, bound {note}, {bound_ms / ms:.1%} of the "
            f"bound")
    aa_plain_ms = time_ms(torch, lambda: aa.aa_match_batch_plain(col, pat),
                          2)

    flat = rel.reshape(c, n, m * w * a)                # fetch: (c,R,n)@...
    bits = rand_field(torch,                           # one_tuple: (c,1,n)
                      torch.Generator(device=rel.device).manual_seed(7),
                      (c, 1, n), rel.device)
    # conditional SUM: match bits (c, 1, n) @ the lifted Salary (c, n, 1)
    lifted = rand_field(torch, torch.Generator(device=rel.device)
                        .manual_seed(8), (c, n), rel.device)[:, :, None]
    for rhs, what in ((flat, "one_tuple"), (lifted, "conditional-SUM")):
        got, want = ops.ss_matmul(bits, rhs), ssm.ss_matmul_plain(bits, rhs)
        check(torch.equal(got, want), f"ss_matmul_tall {what} differs")
        errs["ss_matmul_tall"] = max(errs["ss_matmul_tall"],
                                     max_err(torch, got, want))
    del bits, lifted

    def fetch_rows(rows):
        """A select's one-hot fetch matrix of ``rows`` addresses."""
        return rounds._share_one_hot(
            key, db, list(range(0, n, n // rows))[:rows]).values

    def fetch_cost(r):
        """-> (bytes, int8 tensor operations, their rate) of the fetch."""
        return (4 * (c * r * n + c * n * m * w * a + c * r * m * w * a),
                32 * c * r * n * m * w * a, INT8_TENSOR_OPS_PER_S)

    # the tall kernel at R = 3 (slice 1's one_round fetch), 69 (the
    # Salary tree and the range_select) and 256 (its largest M), beside
    # the general kernel at the same shapes, in turns
    tall = {}
    for r, reps in ((3, 10), (69, 3), (256, 1)):
        fetch = fetch_rows(r)
        got, want = ops.ss_matmul(fetch, flat), ssm.ss_matmul_plain(fetch,
                                                                    flat)
        check(torch.equal(got, want), f"ss_matmul_tall fetch R={r} differs")
        check(torch.equal(ssm.ss_matmul_cuda(fetch, flat), want),
              f"general ss_matmul fetch R={r} differs")
        errs["ss_matmul_tall"] = max(errs["ss_matmul_tall"],
                                     max_err(torch, got, want))
        del got, want
        gen_ms = time_ms(torch, lambda: ssm.ss_matmul_cuda(fetch, flat),
                         reps)
        tall_ms = time_ms(torch, lambda: ops.ss_matmul(fetch, flat), reps)
        gen_ms2 = time_ms(torch, lambda: ssm.ss_matmul_cuda(fetch, flat),
                          reps)
        tall_ms2 = time_ms(torch, lambda: ops.ss_matmul(fetch, flat), reps)
        plain_ms = time_ms(torch, lambda: ssm.ss_matmul_plain(fetch, flat),
                           1, warmup=0)
        tall[r] = (tall_ms, plain_ms) + fetch_cost(r)
        log(f"fetch {tuple(fetch.shape)} @ {tuple(flat.shape)}: tall "
            f"{tall_ms} / {tall_ms2} ms, general {gen_ms} / {gen_ms2} ms, "
            f"plain {plain_ms} ms, bound {bound_note(*fetch_cost(r))}")
        del fetch
    # the general kernel on the path: the ℓ = 1,000 prefix select's fetch
    fetch = fetch_rows(1000)
    got, want = ops.ss_matmul(fetch, flat), ssm.ss_matmul_plain(fetch, flat)
    check(torch.equal(got, want), "ss_matmul ℓ=1000 fetch differs")
    errs["ss_matmul"] = max(errs["ss_matmul"], max_err(torch, got, want))
    del got, want
    ss_ms = time_ms(torch, lambda: ops.ss_matmul(fetch, flat), 1)
    ss_plain_ms = time_ms(torch, lambda: ssm.ss_matmul_plain(fetch, flat), 1,
                          warmup=0)
    log(f"fetch {tuple(fetch.shape)} @ {tuple(flat.shape)}: general "
        f"{ss_ms} ms, plain {ss_plain_ms} ms, bound "
        f"{bound_note(*fetch_cost(1000))}")
    del fetch

    slide_plain = slide_full_shapes(torch, db, errs, key)
    ripple = ripple_full_shapes(torch, db, errs, key)

    def entry(name, source, replaces, ms, plain_ms, nbytes, nops,
              rate=INT32_OPS_PER_S):
        bound_ms, bound_by = bound(nbytes, nops, rate)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None}

    aa_src = "src/repro_torch/kernels/csrc/aa_match.cu"
    ss_src = "src/repro_torch/kernels/csrc/ss_matmul.cu"
    match_ms, *match_cost = aa_times[MATCH_TIMED]
    slide_ms, *slide_cost = aa_times[SLIDE_TIMED]
    return [entry("aa_match_batch", aa_src,
                  "src/repro/kernels/aa_match.py:81", match_ms, aa_plain_ms,
                  *match_cost),
            entry("aa_slide_batch", aa_src,
                  "src/repro/kernels/aa_match.py:146", slide_ms, slide_plain,
                  *slide_cost),
            entry("ss_matmul", ss_src, "src/repro/kernels/ss_matmul.py:87",
                  ss_ms, ss_plain_ms, *fetch_cost(1000)),
            entry("ss_matmul_tall", ss_src,
                  "src/repro/kernels/ss_matmul.py:145", *tall[3])] + [
            entry(name, "src/repro_torch/kernels/csrc/ripple.cu", replaces,
                  *ripple[name])
            for name, replaces in (
                ("ripple_segment", "src/repro/kernels/ripple.py:113"),
                ("ripple_carry", "src/repro/kernels/ripple.py:66"))]


def join_full_shapes(torch, db, assign_db, errs, launches):
    """Phase 4 for slice 5: the joins' new launch shapes at the path's full
    size (c = 20, nx = 131,072, ny = 1,024), through the ``ops`` wrappers,
    each against ``ss_matmul_plain`` bit for bit and timed beside its
    bound: one word position's product in the fetch-row orientation
    (Y_j (ny × 69, a view j·69 words into each row) @ X_jᵀ (69 × nx)), the
    aggregate form's K = 552 product, the PK/FK fetch of the 1,024 match
    rows and the equijoin's tall X-side fetch of 21 one-hot rows. The
    chain's W launches, its transposing copies and its 7 modular products
    (plain PyTorch, one cloud slice at a time) are timed apart with CUDA
    events, as is the aggregate form's equality indicator. -> the kernels
    line's entries for these shapes."""
    from repro_torch.core import automata, field
    from repro_torch.core.queries import rounds
    from repro_torch.kernels import ops
    from repro_torch.kernels import ss_matmul as ssm

    rel = db.relation.values
    c, n, m, w, a = rel.shape
    flat = rel.reshape(c, n, m * w * a)
    col_x = rel[:, :, 0]                              # EmployeeId
    col_y = assign_db.relation.values[:, :, 0]        # (c, ny, W, A)
    ny = col_y.shape[1]
    rows = {}

    def held(name, fn, args, what, reps):
        got, want = fn(*args), ssm.ss_matmul_plain(*args)
        # equal or the check raises; max_err's int64 copies of a 10.74 GB
        # product would not fit beside the relation
        check(torch.equal(got, want), f"{what} differs from its plain "
              f"version")
        errs[name] = 0
        del got, want
        ms = time_ms(torch, lambda: fn(*args), reps)
        plain_ms = time_ms(torch, lambda: ssm.ss_matmul_plain(*args), 1,
                           warmup=0)
        return ms, plain_ms

    def events(k):
        return [torch.cuda.Event(enable_timing=True) for _ in range(k)]

    # one word position, j = 3: a base 207 words into each row (4-byte
    # aligned, not 16), K = 69 (not a multiple of the 64-term stage)
    yj = col_y[:, :, 3]
    xt = col_x[:, :, 3].transpose(-1, -2).contiguous()
    name = "ss_matmul[join match position]"
    rows[name] = held(name, ops.ss_matmul, (yj, xt),
                      "the join's match position", 5) + (
        4 * (c * ny * a + c * a * n + c * ny * n), 32 * c * ny * a * n)
    # the reference's orientation, X_j @ Y_jᵀ -> (c, nx, ny), and the
    # transposing copy the fetch would then need (checked bit for bit by
    # tests/test_torch_kernels_cuda.py; timed here for the choice)
    xj = col_x[:, :, 3]
    yt = yj.transpose(-1, -2).contiguous()
    x_copy_ms = time_ms(torch, lambda: xj.transpose(-1, -2).contiguous(), 5)
    pairs_ms = time_ms(torch, lambda: ops.ss_matmul(xj, yt), 5)
    pairs = ops.ss_matmul(xj, yt)
    copy_ms = time_ms(torch, lambda: pairs.transpose(-1, -2).contiguous(), 3)
    log(f"join match position orientations (ms): fetch-row Y_j @ X_jᵀ "
        f"{rows[name][0]} (its X_jᵀ copy {x_copy_ms}); reference X_j @ "
        f"Y_jᵀ {pairs_ms}, then a transposing copy into fetch rows "
        f"{copy_ms}")
    del xt, yt, pairs
    # the chain as the path runs it: per position a transposing copy (made
    # here, not inside the wrapper, so it is timed apart), one launch, one
    # modular product into the accumulator
    copy_ms = kern_ms = mul_ms = 0.0
    acc = None
    torch.cuda.synchronize()
    for j in range(w):
        e = events(4)
        e[0].record()
        xt = col_x[:, :, j].transpose(-1, -2).contiguous()
        e[1].record()
        pj = ops.ss_matmul(col_y[:, :, j], xt)
        e[2].record()
        del xt
        if acc is None:
            acc = pj
        else:
            field.mul_(acc, pj)
        e[3].record()
        del pj
        torch.cuda.synchronize()
        copy_ms += e[0].elapsed_time(e[1])
        kern_ms += e[1].elapsed_time(e[2])
        mul_ms += e[2].elapsed_time(e[3])
    chain = {"transposing_copies_ms": copy_ms, "kernels_ms": kern_ms,
             "modular_products_ms": mul_ms,
             "products_bound_ms": (w - 1) * 3 * 4 * c * ny * n
             / HBM_BYTES_PER_S * 1e3}
    log("join match chain at full size (CUDA events, 8 positions): "
        + json.dumps(chain))
    # the PK/FK fetch of the 1,024 match rows against the relation
    name = "ss_matmul[pkfk fetch]"
    rows[name] = held(name, ops.ss_matmul, (acc, flat),
                      "the PK/FK fetch", 1) + (
        4 * (c * ny * n + c * n * m * w * a + c * ny * m * w * a),
        32 * c * ny * n * m * w * a)
    del acc
    # the aggregate form: one K = 552 product, then the equality indicator
    yf = col_y.flatten(-2)
    xtf = col_x.flatten(-2).transpose(-1, -2).contiguous()
    name = "ss_matmul[join aggregate match]"
    rows[name] = held(name, ops.ss_matmul, (yf, xtf),
                      "the join's aggregate match", 3) + (
        4 * (c * ny * w * a + c * w * a * n + c * ny * n),
        32 * c * ny * w * a * n)
    p_cnt = ops.ss_matmul(yf, xtf)
    del xtf
    e = events(2)
    e[0].record()
    automata.equality_indicator_(p_cnt, w)
    e[1].record()
    torch.cuda.synchronize()
    log(f"join aggregate equality indicator at full size (CUDA events): "
        f"{e[0].elapsed_time(e[1])} ms, bound "
        f"{2 * 4 * c * ny * n / HBM_BYTES_PER_S * 1e3} ms (bytes)")
    del p_cnt
    # the equijoin's layer-1 X-side fetch: ℓx = 3 + 16 rows and 2 fake ones
    onehot = rounds._share_one_hot((98,), db,
                                   list(range(0, n, n // 21))[:21])
    name = "ss_matmul_tall[equijoin fetch]"
    rows[name] = held(name, ops.ss_matmul, (onehot.values, flat),
                      "the equijoin's X-side fetch", 5) + (
        4 * (c * 21 * n + c * n * m * w * a + c * 21 * m * w * a),
        32 * c * 21 * n * m * w * a)
    del onehot
    # the equijoin's Y side: 7 one-hot rows against 512 Visitor tuples
    gen = torch.Generator(device=rel.device).manual_seed(9)
    ya = rand_field(torch, gen, (c, 7, 512), rel.device)
    yb = rand_field(torch, gen, (c, 512, 2 * w * a), rel.device)
    check(torch.equal(ops.ss_matmul(ya, yb), ssm.ss_matmul_plain(ya, yb)),
          "the equijoin's Y-side fetch differs from its plain version")
    ss_src = "src/repro_torch/kernels/csrc/ss_matmul.cu"
    out = []
    for name, (ms, plain_ms, nbytes, nops) in rows.items():
        kernel = name.split("[")[0]
        bound_ms, bound_by = bound(nbytes, nops, INT8_TENSOR_OPS_PER_S)
        log(f"{name}: {ms} ms, plain {plain_ms} ms, bound "
            f"{bound_note(nbytes, nops, INT8_TENSOR_OPS_PER_S)}")
        out.append({"name": name, "route": "cuda", "source": ss_src,
                    "replaces": ("src/repro/kernels/ss_matmul.py:145"
                                 if kernel == "ss_matmul_tall" else
                                 "src/repro/kernels/ss_matmul.py:87"),
                    "launches": launches[kernel], "max_abs_err": errs[name],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None})
    return out


def sass_igmma(build) -> dict:
    """Tensor-core int8 MMA instructions (IGMMA) per kernel of the built
    ss_matmul library, from ``cuobjdump -sass``; {} without cuobjdump."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(build._lib_path("ss_matmul"))],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(ss_matmul_kernel|ss_matmul_reduce_kernel)"
                          r"(?:ILi(\d+)ELi(\d+)E)?", line)
            if m is None:
                name = line.split(":")[-1].strip()
            elif m.group(2):                     # <rows a warpgroup, groups>
                name = f"{m.group(1)}<{m.group(2)},{m.group(3)}>"
            else:
                name = m.group(1)
            counts[name] = 0
        elif name is not None and "IGMMA" in line:
            counts[name] += 1
    return counts


def bound_note(nbytes: int, nops: int, rate: float) -> str:
    """The bound and its basis, for a log line."""
    ms, by = bound(nbytes, nops, rate)
    basis = "int8 tensor" if rate == INT8_TENSOR_OPS_PER_S else "int32"
    return f"{ms} ms ({by}; {nops:.4g} {basis} operations, {nbytes:.4g} B)"


def bound(nbytes: int, nops: int, rate: float = INT32_OPS_PER_S):
    """-> (least ms, "bytes" | "operations"): the larger of the bytes over
    the card's memory rate and the operations over ``rate`` (the int32
    rate; the tensor cores' int8 rate for the matmul kernels)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def slide_full_shapes(torch, db, errs, key):
    """Phase 4 for the slide kernel: the suffix count's (k = 2) and the
    substring count's (k = 3) windows over FirstName, a B-stride-0 view of
    the relation, the tree's k = 5 windows over EmployeeId, and the mixed
    batch's distinct-column group (LastName and Department, k = 3) through
    ``aa_slide_rows``; each against the plain version. Returns the plain
    version's ms at k = 2 (the kernel is timed by time_aa_shapes)."""
    from repro_torch import _device
    from repro_torch.core import encoding
    from repro_torch.core.encoding import PatternSpec
    from repro_torch.kernels import aa_match as aa
    from repro_torch.kernels import ops

    rel = db.relation.values
    c, n, _, w, a = rel.shape

    def tile(kind, body, salt):
        return encoding.share_pattern(
            db.codec, PatternSpec(kind, body), n_shares=c,
            device=rel.device,
            generator=_device.generator(key + (salt,), rel.device)).values

    def same(got, want, what):
        torch.cuda.synchronize()
        check(got.shape == want.shape and torch.equal(got, want),
              f"{what} differs from its plain version")
        errs["aa_slide_batch"] = max(errs["aa_slide_batch"],
                                     max_err(torch, got, want))

    first = rel[:, :, NAMES.index("FirstName")][:, None]    # (c,1,n,W,A)
    for k, body in ((2, "nn"), (3, "inn")):
        pat = tile("suffix", body, k)[:, None]
        same(ops.aa_slide_batch(first, pat), aa.aa_slide_batch_plain(first,
                                                                     pat),
             f"aa_slide_batch FirstName k={k}")
    ids = rel[:, :, NAMES.index("EmployeeId")][:, None]
    pat5 = tile("contains", "12345", 5)[:, None]
    same(ops.aa_slide_batch(ids, pat5), aa.aa_slide_batch_plain(ids, pat5),
         "aa_slide_batch EmployeeId k=5")
    cols = [NAMES.index("LastName"), NAMES.index("Department")]
    pats = torch.stack([tile("contains", "inn", 6),
                        tile("suffix", "gal", 7)], dim=1)
    rows = dict(columns=cols, starts=[0, 0], lengths=[n, n], pat=pats,
                height=n)
    same(ops.aa_slide_rows(rel, **rows), aa.aa_slide_rows_plain(rel, **rows),
         "aa_slide_rows distinct-column group")
    pat = tile("suffix", "nn", 2)[:, None]
    return time_ms(torch, lambda: aa.aa_slide_batch_plain(first, pat), 2)


#: the shapes of time_aa_shapes that stand for the two kernels in the
#: kernels line (the count stack and the suffix count's windows).
MATCH_TIMED = "aa_match_batch count stack (c, 1, n, 8, 69)"
SLIDE_TIMED = "aa_slide_batch k=2 FirstName"


def time_aa_shapes(torch, ops, rel, reps: int = 10):
    """The match and slide kernels at phase 4's shapes over the relation
    ``rel`` (c, n, m, W, A), with random pattern tiles (the work does not
    depend on the values): the count stack, a one-column stack of 8
    predicates, the ℓ = 16 tree round's 16 row blocks, and the windows of
    k = 2, 3 (FirstName) and 5 (EmployeeId). -> name -> (ms, bytes,
    operations); the bytes read each column once."""
    from repro_torch.core.partition import split_bounds
    c, n, _, w, a = rel.shape
    gen = torch.Generator(device=rel.device).manual_seed(13)

    def tile(b, k):
        return rand_field(torch, gen, (c, b, k, a), rel.device)

    def match_cost(b, height=n):
        return (4 * (c * n * w * a + c * b * w * a + c * b * height),
                b * (2 * c * n * w * a + c * n * (w - 1)))

    def slide_cost(k):
        m = w - k + 1
        return (4 * (c * n * w * a + c * k * a + c * n * m),
                2 * c * n * m * k * a + c * n * m * (k - 1))

    first = NAMES.index("FirstName")
    col = rel[:, :, first][:, None]
    ids = rel[:, :, NAMES.index("EmployeeId")][:, None]
    bounds = split_bounds(0, n, 16)
    height = max(e - s for s, e in bounds)
    tree = dict(columns=[first] * len(bounds), starts=[s for s, _ in bounds],
                lengths=[e - s for s, e in bounds],
                pat=tile(1, w).expand(c, len(bounds), w, a), height=height)
    p1, p8 = tile(1, w), tile(8, w)
    shapes = {
        MATCH_TIMED: (lambda: ops.aa_match_batch(col, p1), *match_cost(1)),
        "aa_match_batch one-column stack (c, 8, n, 8, 69)": (
            lambda: ops.aa_match_batch(col.expand(c, 8, n, w, a), p8),
            *match_cost(8)),
        f"aa_match_rows tree round 16 x {height}": (
            lambda: ops.aa_match_rows(rel, **tree),
            4 * (c * n * w * a + c * 16 * w * a + c * 16 * height),
            match_cost(1)[1])}
    for k, src, tag in ((2, col, "FirstName"), (3, col, "FirstName"),
                        (5, ids, "EmployeeId")):
        pk = tile(1, k)
        shapes[f"aa_slide_batch k={k} {tag}"] = (
            lambda src=src, pk=pk: ops.aa_slide_batch(src, pk),
            *slide_cost(k))
    return {name: (time_ms(torch, fn, reps), nbytes, nops)
            for name, (fn, nbytes, nops) in shapes.items()}


#: operations per lane of one SS-SUB bit step, a mod-p multiply counting
#: 2: the LSB step does 5 add/sub and 1 multiply, a carried step 8 and 2.
RIPPLE_INIT_OPS, RIPPLE_STEP_OPS = 7, 12


#: CUDA-graph replays before the timed ones, and the replays timed (each
#: between its own pair of CUDA events; the median is reported).
GRAPH_WARM, GRAPH_TIMED = 3, 9


#: the card's clocks, power and throttle reasons (``nvidia-smi`` fields),
#: logged before the ripple times: phase 4 reads the range's first segment
#: slower than a fresh process does.
CLOCKS = ("clocks.sm,clocks.mem,power.draw,temperature.gpu,"
          "clocks_throttle_reasons.active")


def smi(query: str, check: bool = True) -> str:
    """``nvidia-smi --query-gpu=QUERY --format=csv,noheader`` of card 0
    (without ``check``, what it printed, also when it failed)."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=check)
    return (out.stdout.strip() or out.stderr.strip() or "no output"
            ).splitlines()[0]


def _graph(torch, fns):
    """A CUDA graph of at least 12 calls of ``fns`` (thunks run in turn),
    captured after a warm-up on a side stream -> (graph, calls in it, host
    µs a call measured without the graph)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:                       # warm-up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for fn in fns:
        fn()
    host_us = (time.perf_counter() - t) / len(fns) * 1e6
    torch.cuda.synchronize()
    reps = max(1, 12 // len(fns))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            for fn in fns:
                fn()
    return graph, reps * len(fns), host_us


def graph_ms(torch, fns):
    """Device ms per call of ``fns`` (thunks run in turn): a CUDA graph of
    at least 12 calls, replayed GRAPH_WARM times untimed, then GRAPH_TIMED
    times each between CUDA events, so the launcher's host time does not
    bound a 0.03 ms kernel. -> (median ms, host µs a call measured without
    the graph, least and most ms of the timed replays)."""
    graph, calls, host_us = _graph(torch, fns)
    for _ in range(GRAPH_WARM):
        graph.replay()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(GRAPH_TIMED)]
    torch.cuda.synchronize()
    for start, stop in events:
        start.record()
        graph.replay()
        stop.record()
    torch.cuda.synchronize()
    ms = sorted(start.elapsed_time(stop) / calls for start, stop in events)
    del graph
    return ms[len(ms) // 2], host_us, ms[0], ms[-1]


def graph_kernels(torch, fns):
    """The device time of the kernels inside GRAPH_TIMED replays of a CUDA
    graph of ``fns`` (as ``graph_ms`` builds it), by ``torch.profiler``
    -> ({kernel name: device ms a call}, device kernels a call); ({}, 0)
    when the profiler sees no device time in graph replays."""
    from torch.profiler import ProfilerActivity, profile
    graph, calls, _ = _graph(torch, fns)
    for _ in range(GRAPH_WARM):
        graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(GRAPH_TIMED):
            graph.replay()
        torch.cuda.synchronize()
    del graph
    n = GRAPH_TIMED * calls
    by_name, kernels = {}, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us:
            by_name[e.key[:80]] = us / 1e3 / n
            kernels += e.count
    return by_name, kernels / n


def ripple_operands(torch, x, ends, bit_major):
    """The range phase's operands over one binary column ``x`` (c, n, t)
    with shared endpoints ``ends`` ((c, 1, 1, t) each): bit-major, as
    ``range_phase`` builds them (``bit_major`` of the rows [lo, x, hi]),
    and interleaved, as two ``torch.cat``s build them. -> (lhs, rhs)
    twice."""
    c, n, t = x.shape
    a_all, b_all = (e.expand(c, 1, n, t) for e in ends)
    rows = bit_major([a_all, x[:, None], b_all], dim=1)
    inter = (torch.cat([a_all, x[:, None]], dim=1),
             torch.cat([x[:, None], b_all], dim=1))
    return (rows[:, :2], rows[:, 1:]), inter


def tournament_operands(torch, cand, level: int, bit_major=None):
    """A MIN tournament level's (lhs, rhs) over ``cand`` (c, 1, n, t):
    every pair of a level-``level`` bracket, from the candidates' stride-2
    pair views: with ``bit_major``, copies in the layout (and, for a MIN,
    of the values) ``ripple.bit_major_where`` gives ``agg_minmax_rounds``;
    without, interleaved, by ``torch.where`` as the parent built them."""
    pairs = cand.shape[2] >> level
    x1, x2 = cand[:, :, 0:2 * pairs:2], cand[:, :, 1:2 * pairs:2]
    if bit_major is None:
        is_min = torch.tensor([True], device=cand.device)[None, :, None,
                                                          None]
        return torch.where(is_min, x1, x2), torch.where(is_min, x2, x1)
    return bit_major([x1], dim=1), bit_major([x2], dim=1)


def ripple_times(torch, ops, x, ends, bit_major):
    """The ripple kernel at phase 4's shapes over the column ``x``, each
    through a CUDA graph (``graph_ms``): the range phase's first segment
    (c, 2, n, 8) and its carried k = 1 steps (rotating over bit planes
    1..12, as ``reduce_every=1`` does, so that L2 does not serve the same
    planes again), bit-major and interleaved, MIN tournament levels 1 and
    10 (the k = 8 segment, bit-major) and both levels' two segments
    (k = 8, then 5 carried, as ``reduce_every=8`` runs them), bit-major
    and interleaved. Interleaved operands take the strided route. ->
    name -> (median ms, host µs, least ms, most ms, bytes, operations)."""
    c, n, t = x.shape
    (lhs, rhs), (ilhs, irhs) = ripple_operands(torch, x, ends, bit_major)
    call = ops.ripple_segment
    lanes = c * 2 * n
    seg_cost = (4 * lanes * (2 * 8 + 2),
                lanes * (RIPPLE_INIT_OPS + 7 * RIPPLE_STEP_OPS))
    carry_cost = (4 * lanes * (2 + 2 + 1), lanes * RIPPLE_STEP_OPS)
    carry = call(lhs[..., 0:1], rhs[..., 0:1])[1]
    out = {}
    for tag, (a, b) in (("bit-major", (lhs, rhs)),
                        ("interleaved", (ilhs, irhs))):
        out[f"range first segment {tag}"] = graph_ms(
            torch, [lambda a=a, b=b: call(a[..., 0:8], b[..., 0:8])]) \
            + seg_cost
        out[f"carried k=1 step {tag}"] = graph_ms(
            torch, [lambda j=j, a=a, b=b: call(
                a[..., j:j + 1], b[..., j:j + 1], carry)
                for j in range(1, t)]) + carry_cost
    del lhs, rhs, ilhs, irhs
    cand = bit_major([x[:, None]], dim=1)
    icand = x[:, None].contiguous()

    def level(a, b):                       # both segments of one level
        return call(a[..., 8:], b[..., 8:], call(a[..., :8], b[..., :8])[1])

    for lv in (1, 10):
        a, b = tournament_operands(torch, cand, lv, bit_major)
        m = c * a.shape[2]
        out[f"tournament level {lv} {tuple(a[..., :8].shape)}"] = \
            graph_ms(torch, [lambda a=a, b=b: call(
                a[..., 0:8], b[..., 0:8])]) + (
                4 * m * (2 * 8 + 2),
                m * (RIPPLE_INIT_OPS + 7 * RIPPLE_STEP_OPS))
        both = (4 * m * (2 * t + 2 + 3),
                m * (RIPPLE_INIT_OPS + (t - 1) * RIPPLE_STEP_OPS))
        ia, ib = tournament_operands(torch, icand, lv)
        for tag, (a, b) in (("bit-major", (a, b)), ("interleaved", (ia, ib))):
            out[f"tournament level {lv} both segments {tag}"] = graph_ms(
                torch, [lambda a=a, b=b: level(a, b)]) + both
    return out


def ripple_full_shapes(torch, db, errs, key):
    """Phase 4 for the ripple kernel, through the path's own helpers
    (``ripple.bit_major``, ``ripple.bit_major_where``): the range phase's
    first segment (c, 2, n, 8) and a carried k = 1 step as ``range_count``
    builds them, and the MIN tournament's levels 1 and 10, each held
    against the plain version on the route the path takes (bit-major)
    and, for the range's operands laid out interleaved, on the strided
    route; the operand builds timed against the interleaved
    ``torch.cat``, ``torch.where`` and ``torch.stack`` they replace; the
    kernel timed once on each layout (``ripple_times``). Returns name ->
    (ms, plain_ms, bytes, operations) for the kernels line (bit-major, the
    median of the timed replays)."""
    from repro_torch import _device
    from repro_torch.core import encoding
    from repro_torch.kernels import ops
    from repro_torch.kernels import ripple as rip

    x = db.numeric[NAMES.index("Salary")].values        # (c, n, t)
    c, n, t = x.shape
    dev = x.device
    ends = [encoding.share_encoded(
        encoding.encode_number_bits(v, t), n_shares=c, device=dev,
        generator=_device.generator(key + (v,), dev)).values[:, None, None]
        for v in (500, 1500)]
    (lhs, rhs), (ilhs, irhs) = ripple_operands(torch, x, ends,
                                               rip.bit_major)

    def on(route, a, b, carry, k, what):
        before = ops.ripple_route_counts()[route]
        got = rip.ripple_segment_cuda(a, b, carry)
        check(ops.ripple_route_counts()[route] == before + 1,
              f"{what} did not take the {route} route")
        same_ripple(torch, got, rip.ripple_segment_plain(a, b, carry), k,
                    errs, f"{what} ({route})")

    first = (lhs[..., 0:8], rhs[..., 0:8])
    on("bit_major", *first, None, 8, "ripple range first segment")
    on("strided", ilhs[..., 0:8], irhs[..., 0:8], None, 8,
       "ripple range first segment")
    carry = ops.ripple_segment(lhs[..., 0:1], rhs[..., 0:1])[1]
    step = (lhs[..., 1:2], rhs[..., 1:2])
    on("bit_major", *step, carry, 1, "ripple carried k=1 step")
    on("strided", ilhs[..., 1:2], irhs[..., 1:2], carry, 1,
       "ripple carried k=1 step")
    plain = {"ripple_segment": time_ms(
        torch, lambda: rip.ripple_segment_plain(*first), 2),
        "ripple_carry": time_ms(
        torch, lambda: rip.ripple_segment_plain(*step, carry), 2)}

    a_all, b_all = (e.expand(c, 1, n, t) for e in ends)
    cand = rip.bit_major([x[:, None]], dim=1)
    icand = x[:, None].contiguous()
    is_min = torch.tensor([True], device=dev)[None, :, None, None]
    x1, x2 = cand[:, :, 0::2], cand[:, :, 1::2]
    ix1, ix2 = icand[:, :, 0::2], icand[:, :, 1::2]
    builds = {
        "range operands, torch.cat x2 (interleaved)": lambda: (
            torch.cat([a_all, x[:, None]], dim=1),
            torch.cat([x[:, None], b_all], dim=1)),
        "range operands, bit_major of [lo, x, hi]": lambda: rip.bit_major(
            [a_all, x[:, None], b_all], dim=1),
        "MIN candidates, torch.stack (interleaved)": lambda: torch.stack(
            [x], dim=1),
        "MIN candidates, bit_major": lambda: rip.bit_major(
            [x[:, None]], dim=1),
        "level 1 operands, torch.where x2 (interleaved candidates)":
            lambda: (torch.where(is_min, ix1, ix2),
                     torch.where(is_min, ix2, ix1)),
        "level 1 operands, bit_major_where x2 (interleaved candidates)":
            lambda: (rip.bit_major_where(is_min, ix1, ix2),
                     rip.bit_major_where(is_min, ix2, ix1)),
        "level 1 operands, bit_major_where x2 (bit-major candidates)":
            lambda: (rip.bit_major_where(is_min, x1, x2),
                     rip.bit_major_where(is_min, x2, x1))}
    for name, fn in builds.items():
        log(f"ripple operand build, {name}: "
            f"{time_ms(torch, fn, 10)} ms")
    del icand, ix1, ix2

    for level in (1, 10):
        pairs = n >> level
        a = rip.bit_major_where(is_min, cand[:, :, 0:2 * pairs:2],
                                cand[:, :, 1:2 * pairs:2])
        b = rip.bit_major_where(is_min, cand[:, :, 1:2 * pairs:2],
                                cand[:, :, 0:2 * pairs:2])
        on("bit_major", a[..., 0:8], b[..., 0:8], None, 8,
           f"ripple tournament level {level}")
    del lhs, rhs, ilhs, irhs, cand, x1, x2, a, b

    log(f"before the ripple times: {CLOCKS} {smi(CLOCKS, check=False)}")
    times = ripple_times(torch, ops, x, ends, rip.bit_major)
    for name, (ms, host_us, lo, hi, nbytes, nops) in times.items():
        bound_ms, _ = bound(nbytes, nops)
        log(f"ripple {name}"
            + (" (strided route)" if "interleaved" in name else "")
            + f": {ms} ms (median of {GRAPH_TIMED} CUDA-graph replays, "
            f"{lo}–{hi}), host {host_us:.1f} µs a call, bound "
            f"{bound_note(nbytes, nops, INT32_OPS_PER_S)}, "
            f"{bound_ms / ms:.1%} of the bound")
    ms_seg, _, _, _, *seg_cost = times["range first segment bit-major"]
    ms_car, _, _, _, *car_cost = times["carried k=1 step bit-major"]
    return {"ripple_segment": (ms_seg, plain["ripple_segment"], *seg_cost),
            "ripple_carry": (ms_car, plain["ripple_carry"], *car_cost)}


def tournament_device_ms(torch, x):
    """One MIN tournament (``reduce_every=8``) over the binary column ``x``
    (c, n, t) through ``agg_minmax_rounds``: the device time of all its
    kernels (``torch.profiler``: operand builds, ripple launches,
    re-shares, the opening), and its time between CUDA events (host gaps
    included). The values are random shares, so the opened minimum means
    nothing; the work does not depend on them. -> (device ms or None when
    the profiler sees no device time, event ms)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import get_backend
    from repro_torch.core import Codec
    from repro_torch.core.costs import CostLedger
    from repro_torch.core.engine import SecretSharedDB
    from repro_torch.core.queries import aggregate
    from repro_torch.core.shamir import Shares
    c, n, t = x.shape
    db = SecretSharedDB(
        relation=Shares(torch.zeros((c, n, 1, 1, 1), dtype=torch.int32,
                                    device=x.device), 1),
        codec=Codec(word_length=1), column_names=["v"],
        numeric={0: Shares(x, 1)}, numeric_bits={0: t})

    def run():
        aggregate.agg_minmax_rounds(get_backend("cuda"), db, [
            aggregate.MinMaxJob(value_column=0, key=(5,),
                                ledger=CostLedger(), op="min",
                                reduce_every=8)])

    run()                                                    # warm-up
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in prof.key_averages())
    return (dev_us / 1e3 if dev_us else None), start.elapsed_time(stop)


def local_bit_major(torch, sources, dim):
    """``ripple.bit_major`` for a checkout that predates it (``--ripple-
    times`` on a parent): the same layout, lanes padded to 4."""
    ref = sources[0]
    *lead, lanes, t = ref.shape
    lead[dim] = sum(s.shape[dim] for s in sources)
    buf = torch.empty((*lead, t, -(-lanes // 4) * 4), dtype=ref.dtype,
                      device=ref.device)
    out = buf[..., :lanes].transpose(-1, -2)
    at = 0
    for src in sources:
        out.narrow(dim, at, src.shape[dim]).copy_(src)
        at += src.shape[dim]
    return out


def ripple_times_only(torch, args) -> int:
    """``--ripple-times SRC``: build SRC's kernels, fill a (20, n, 13)
    binary column and endpoints with random field elements and print the
    ripple kernel's ms at phase 4's shapes (``ripple_times``) and one MIN
    tournament's device ms over the column (``tournament_device_ms``); two
    checkouts compare on one card when both run in one call, in turns.
    SRC's ``ripple.bit_major`` builds the bit-major operands where it has
    one."""
    import repro_torch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ripple as rip
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x = rand_field(torch, gen, (20, args.tuples, SALARY_BITS), "cuda")
    ends = [rand_field(torch, gen, (20, 1, 1, SALARY_BITS), "cuda")
            for _ in range(2)]
    bm = getattr(rip, "bit_major", None) or (
        lambda srcs, dim: local_bit_major(torch, srcs, dim))
    clocks = smi(CLOCKS, check=False)
    times = ripple_times(torch, ops, x, ends, bm)
    tour_ms = tournament_device_ms(torch, x)
    print(json.dumps({"src": os.path.dirname(repro_torch.__file__),
                      "card": smi("name,power.limit"),
                      "ms": {k: v[0] for k, v in times.items()},
                      "ms_range": {k: v[2:4] for k, v in times.items()},
                      "host_us": {k: v[1] for k, v in times.items()},
                      "clocks_before": clocks,
                      "min_tournament_ms": {"device": tour_ms[0],
                                            "events": tour_ms[1]}}),
          flush=True)
    return 0


def aa_times_only(torch, args) -> int:
    """``--aa-times SRC``: build SRC's kernels, fill a (20, n, 5, 8, 69)
    relation with random field elements and print the match and slide
    kernels' ms at phase 4's shapes (two checkouts compare on one card when
    both run in one call, in turns)."""
    import repro_torch
    from repro_torch.kernels import _build, ops
    _build.build_all()
    rel = torch.empty((20, args.tuples, len(NAMES), 8, 69), dtype=torch.int32,
                      device="cuda")
    for z in range(rel.shape[0]):
        rel[z].random_(0, P)
    times = time_aa_shapes(torch, ops, rel)
    print(json.dumps({"src": os.path.dirname(repro_torch.__file__),
                      "card": smi("name,power.limit"),
                      "ms": {k: v[0] for k, v in times.items()}}), flush=True)
    return 0


def setup_peak_only(torch, args) -> int:
    """``--setup-peak SRC``: the device memory ``setup_private_embed`` of
    the port under SRC takes above its input, for slice 4's table
    (float32, standard normal) and slice 7's (bfloat16, scaled as
    ``lm.init_params`` draws it), both 151,936 x 2,560 over c = 4 clouds
    (two checkouts compare on one card when both run in one call)."""
    import repro_torch
    from repro_torch.models import private_embed as pe
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    peaks = {}
    for name, dtype, scale in (("slice4_f32", torch.float32, 1.0),
                               ("slice7_bf16", torch.bfloat16,
                                QWEN_DIM ** -0.5)):
        table = (torch.randn((QWEN_VOCAB, QWEN_DIM), generator=gen,
                             device="cuda") * scale).to(dtype)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        shares = pe.setup_private_embed(args.seed, table,
                                        n_shares=EMBED_SHARES)
        torch.cuda.synchronize()
        peaks[name] = {"seconds": time.perf_counter() - t0,
                       "peak_gb": (torch.cuda.max_memory_allocated()
                                   - base) / 1e9,
                       "shares_gb": shares.values.numel() * 4 / 1e9}
        del table, shares
    print(json.dumps({"src": os.path.dirname(repro_torch.__file__),
                      "card": smi("name,power.limit"),
                      "setup_private_embed": peaks}), flush=True)
    return 0


def onehot_times_only(torch, args) -> int:
    """``--onehot-times SRC``: build SRC's kernels and print
    ``onehot_device_times``' rows and one call's device kernels as JSON
    (two checkouts compare on one card when both run in one call, in
    turns)."""
    import repro_torch
    from repro_torch.kernels import _build
    _build.build_all()
    clocks = smi(CLOCKS, check=False)
    rows, calls = onehot_device_times(torch, args)
    print(json.dumps({"src": os.path.dirname(repro_torch.__file__),
                      "card": smi("name,power.limit"),
                      "clocks_before": clocks, "rows": rows,
                      "kernels_of_one_call": calls}), flush=True)
    return 0


def decode_times_only(torch, args) -> int:
    """``--decode-times SRC``: with the port under SRC, for slice 7's
    configuration and each of slices 8 and 9's that the port runs (a
    family that an older port refuses with ``NotImplementedError`` is
    listed as unported), plaintext, bf16, synthetic weights and frontend
    inputs from ``--seed``: prefill ms and decode ms a step over
    SLICE8_NEW - 1 steps of SLICE8_BATCH requests (three rounds), and the
    aten calls of one decode step (``torch.profiler``, CPU activity), as
    one JSON line (two checkouts compare on one card when both run in one
    call)."""
    import dataclasses

    import repro_torch
    from repro_torch import configs
    from repro_torch.models import lm
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for arch, layers, t, frontend in (
            [(LM_ARCH, None, LM_PROMPT, None)]
            + [f[:3] + (None,) for f in SLICE8_FAMILIES]
            + [f[:3] + f[4:] for f in SLICE9_FAMILIES]):
        cfg = configs.full(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        try:
            getattr(lm, "check_supported", lambda _: None)(cfg)
        except NotImplementedError:
            out[arch] = "unported"
            continue
        params = lm.init_params(args.seed, cfg)
        dev = params["final_norm"].device
        rng = np.random.default_rng(args.seed)
        batch = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (SLICE8_BATCH, t)), device=dev)}
        pre = 0
        if frontend is not None:
            name, n = frontend
            batch[name] = torch.as_tensor(rng.standard_normal(
                (SLICE8_BATCH, n, cfg.frontend_dim)),
                dtype=torch.float32).to(dev)
            pre = n if name == "patches" else 0
        pos = pre + t
        rounds = []
        with torch.no_grad():
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = lm.prefill(params, cfg, batch,
                                           max_len=pos + SLICE8_NEW)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
                for i in range(SLICE8_NEW - 1):
                    logits, cache = lm.decode_step(params, cfg, cache,
                                                   pos + i, {"tokens": tok})
                    tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
                torch.cuda.synchronize()
                rounds.append({"prefill_ms": 1e3 * (t1 - t0),
                               "decode_ms": 1e3 * (time.perf_counter() - t1)
                               / (SLICE8_NEW - 1)})
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                lm.decode_step(params, cfg, cache, pos + SLICE8_NEW - 1,
                               {"tokens": tok})
                torch.cuda.synchronize()
        calls = sum(e.count for e in prof.key_averages()
                    if e.key.startswith("aten::"))
        out[arch] = {"layers": cfg.n_layers, "rounds": rounds,
                     "aten_calls_a_step": calls,
                     "aten_calls_a_layer": calls / cfg.n_layers}
        del params, cache, logits
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"src": os.path.dirname(repro_torch.__file__),
                      "card": smi("name,power.limit"),
                      "decode_times": out}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tuples", type=int, default=131072)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--aa-times", metavar="SRC",
                    help="only time the match and slide kernels of the port "
                         "under SRC (the src/ directory of a checkout) at "
                         "phase 4's shapes, on random shares of the "
                         "Employee relation's shape, and print them as JSON")
    ap.add_argument("--ripple-times", metavar="SRC",
                    help="only time the ripple kernel of the port under SRC "
                         "at phase 4's shapes, on a random 13-bit column, "
                         "and print the times as JSON")
    ap.add_argument("--setup-peak", metavar="SRC",
                    help="only measure the device memory and seconds of the "
                         "embedding table's set-up (slices 4 and 7) with the "
                         "port under SRC, and print them as JSON")
    ap.add_argument("--onehot-times", metavar="SRC",
                    help="only time share_onehot of the port under SRC at "
                         "phase 4's shapes (device time of CUDA-graph "
                         "replays, the kernels inside them, routes) and "
                         "print the rows as JSON")
    ap.add_argument("--decode-times", metavar="SRC",
                    help="only time prefill and decode steps and count a "
                         "decode step's aten calls for slices 7, 8 and 9's "
                         "configurations with the port under SRC, and print "
                         "them as JSON")
    args = ap.parse_args()
    only = (args.aa_times or args.ripple_times or args.setup_peak
            or args.decode_times or args.onehot_times)
    if only:
        sys.path.insert(0, os.path.abspath(only))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.aa_times:
        return aa_times_only(torch, args)
    if args.ripple_times:
        return ripple_times_only(torch, args)
    if args.setup_peak:
        return setup_peak_only(torch, args)
    if args.decode_times:
        return decode_times_only(torch, args)
    if args.onehot_times:
        return onehot_times_only(torch, args)
    from repro_torch.api import planner
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"built kernels in {time.perf_counter() - t0:.1f} s")
    for name, info in _build.BUILD_INFO.items():
        log(f"[{name}] nvcc {info['seconds']:.1f} s\n{info['log'].strip()}")
    igmma = sass_igmma(_build)
    log(f"[ss_matmul] SASS IGMMA instructions per kernel (cuobjdump): "
        f"{json.dumps(igmma) if igmma else 'cuobjdump not found'}")
    check(not igmma or all(v > 0 for k, v in igmma.items()
                           if k.startswith("ss_matmul_kernel<")),
          "an ss_matmul kernel issues no int8 tensor-core instruction")

    dev = torch.device("cuda")
    errs = {name: 0 for name in ("aa_match_batch", "aa_slide_batch",
                                 "ss_matmul", "ss_matmul_tall",
                                 "ripple_segment", "ripple_carry",
                                 "share_onehot")}
    compare_small(torch, dev, errs)
    log("kernels == plain versions on extremes and ragged shapes")

    def expect_strategy(client, ell):
        return planner.choose_select_strategy(client.stats(),
                                              ell=ell).strategy

    db, client, rows, path1 = main_path(torch, args, expect_strategy)
    log("slice-1 path: every answer equals the plaintext evaluation")
    price_step(torch, "slice-1 Eq count (FirstName = Quinn)",
               lambda: client.count("FirstName", "Quinn"),
               kernels=("aa_match_batch",))
    path2 = range_agg_path(torch, client, rows)
    log("slice-2 path: every answer equals the plaintext evaluation")
    path3 = pattern_path(torch, client, rows)
    log("slice-3 path: every answer equals the plaintext evaluation")
    path5, assign_db = join_path(torch, args, db, rows)
    log("slice-5 path: every join equals the plaintext join")
    path6 = serve_path(torch, args, db, rows, assign_db)
    log("slice-6 path: every served answer equals the plaintext "
        "evaluation and every ledger a solo replay")
    path11 = slice11_path(torch, args, db, rows)
    log("slice-11 path: on a 2 x 2 grid of the card and on distinct "
        "devices every answer equals the plaintext and every answer and "
        "ledger the 1 x 1 grid's, with no byte between cloud groups")
    path4, table = embed_path(torch, args)
    log("slice-4 path: every embedding equals the quantized table's row")
    launches = {k: sum(p[k] for p in (path1, path2, path3, path4, path5,
                                      path6, path11)) for k in path1}
    torch.cuda.reset_peak_memory_stats()
    onehot = embed_full_shapes(torch, table, errs, launches)
    del table
    onehot_rows, onehot_calls = onehot_device_times(torch, args)
    check(all(r["route"] == "quad" for r in onehot_rows),
          "a phase-4 share_onehot shape did not take the quad route")
    int64 = onehot_calls["int64"]
    check(int64["graph"] == {"nodes": 1, "kernels": 1}
          and all("onehot" in k for k in int64["profiler"]),
          f"share_onehot with int64 tokens ran {int64}, not exactly one "
          f"device kernel")
    kernels = full_shape_kernels(torch, db, errs, launches) + [onehot] \
        + join_full_shapes(torch, db, assign_db, errs, launches)
    log(f"phase 4 peak device memory {torch.cuda.max_memory_allocated() / 1e9}"
        f" GB (the relation included; the table until slice 5's shapes)")
    log("kernels == plain versions at the main paths' full shapes")

    # slice 7 last, on a card freed of the earlier slices' relations
    del db, client, assign_db
    gc.collect()
    torch.cuda.empty_cache()
    path7 = lm_path(torch, args, errs)
    log("slice-7 path: private, EmbedLookup and plaintext generations are "
        "identical and decode matches forward")
    gc.collect()
    torch.cuda.empty_cache()
    path8 = families_path(torch, args)
    log("slice-8 path: private and plaintext generations are identical "
        "for every family")
    gc.collect()
    torch.cuda.empty_cache()
    path9 = slice9_path(torch, args)
    log("slice-9 path: private and plaintext generations are identical "
        "for the encoder-decoder and the ViT-prefixed families")
    gc.collect()
    torch.cuda.empty_cache()
    path10 = train_path(torch, args, errs)
    log("slice-10 path: training at full Qwen1.5-4B width through the "
        "launcher, the private embedding, accumulation with compression "
        "and a restart all pass")
    log("slice-12 summary " + json.dumps({
        "seconds": sum(r["seconds"] for r in SLICE12),
        "measured_over_roofline": {r["step"]: r["measured_over_roofline"]
                                   for r in SLICE12},
        "predicted_over_measured_peak": {
            r["step"]: (r["predicted_peak_gb"] / r["measured_peak_gb"]
                        if r["measured_peak_gb"] else None)
            for r in SLICE12}}))
    check(len(SLICE12) == 3, f"slice 12 priced {len(SLICE12)} steps, not 3")
    for entry in kernels:
        name = entry["name"].split("[")[0]
        entry["launches"] += sum(p.get(name, 0) for p in (path7, path8,
                                                          path9, path10))
        entry["max_abs_err"] = max(entry["max_abs_err"], errs[name])

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
