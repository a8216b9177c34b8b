#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--tuples 131072] [--seed 0]
    python3 chip_smoke.py --aa-times SRC      # only the match/slide times
    python3 chip_smoke.py --ripple-times SRC  # only the ripple times
    python3 chip_smoke.py --setup-peak SRC    # only the table set-up peak
    python3 chip_smoke.py --decode-times SRC  # only LM prefill/decode times
    python3 chip_smoke.py --onehot-times SRC  # only the share_onehot times
    python3 chip_smoke.py --mesh-only         # only t1, slices 13 to 15
    python3 chip_smoke.py --grids             # only the multi-card phases
    python3 chip_smoke.py --grids-train       # only training on 4 cards

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
   Slice 23 (after slice 10, on a freed card): training for every other
   family whose training state one card holds, each at its full published
   configuration (every layer, bf16, remat) on synthetic weights from
   ``--seed``, one after another: Gemma3-1B, MiniCPM3-4B, Mamba2-2.7B,
   Hymba-1.5B and SeamlessM4T-medium. Each runs slice 10's t1 (4 steps of
   4 x 512 tokens through ``launch.train.main``; SeamlessM4T-medium
   through ``make_train_step``, 640 audio frames a sequence beside the
   tokens, which the launcher's batches do not carry), its float32 check
   (2 layers, 2 + 2 for the encoder-decoder; Gemma3-1B at 640 tokens, past
   its 512-token windows) and t2 (2 private-embedding steps, each exactly
   one ``share_onehot`` and one general ``ss_matmul`` on the card, the
   embeddings equal to the dequantized rows, times sqrt(d_model) for
   Gemma3-1B, and ``embed`` on the AdamW rule of its moments: an untied
   table gets no gradient, Gemma3-1B's tied one the head's), then both
   kernels at the family's shape (M = 2,048, K = V, N = d, c = 4) against
   their plain versions. A ``slice-23 <family> summary`` line gives ms a
   step, tokens/s, the peak beside its reckoning, the idle share, device
   ms by kernel kind, the float32 differences and the kernels' ms beside
   their bounds.
   Slice 13 (after slice 23): the production mesh, a
   (1, 1) ``DeviceMesh`` of one NCCL rank started by
   ``launch.mesh.init_ranks`` from ``torchrun``'s environment variables
   (a free localhost port). 3 steps of ``launch.train.main(mesh=)`` at
   t1's shapes, DTensor parameters, moments and batches: losses within
   1e-6 (step 0) and 2e-3 (steps 1–2) relative of t1's; ms a step, the
   idle share over a profiled step and the peak. One private-embedding
   step through ``make_train_step`` on DTensors launches exactly one
   ``share_onehot`` and one ``ss_matmul`` (each rank's blocks), each
   call equal to its plain version afterwards, the opened rows equal to
   the unsharded lookup's. The smoke config's parameters and AdamW
   state saved at the mesh restore unsharded and at the mesh bit for
   bit. The walker prices a 2-layer full-width step on the mesh as the
   unsharded step (flops by class, HBM bytes), with no collective byte.
   Slice 14 (last, after slice 13, on a freed card): the MoE family on
   the production mesh, at the full Granite-3.0-3B-A800M configuration
   (32 layers, d 1,536, 24 heads with 8 KV heads, 40 experts top-8 of
   expert d_ff 512, V 49,155, bf16, remat, the einsum dispatch; 3.37 B
   synthetic parameters from ``--seed``) on slice 10's batches and AdamW.
   (a) 3 steps of ``launch.train.main`` unsharded: finite losses, ms a
   step, the idle share over a profiled step, the peak; (b) the same on
   a (1, 1) NCCL mesh, losses within 1e-6 (step 0) and 2e-3 (steps 1–2)
   relative of (a)'s; (c) one step with the sort dispatch at capacity
   1.25, unsharded and on the mesh, losses within 1e-6 relative, and the
   pairs the unsharded forward drops; (d) one private-embedding step on
   the mesh, slice 13's check at this configuration: exactly one
   ``share_onehot`` and one general ``ss_matmul`` (4, 2,048, 49,155) @
   (4, 49,155, 1,536), each equal to its plain version afterwards, the
   opened rows the unsharded lookup's. A
   ``slice-14 summary`` line gives the card, ms a step, peaks, idle
   shares, the largest loss difference and the seconds.
   Slice 15 (last, after slice 14, on a freed card): serving on the
   production mesh, at the full ChatGLM3-6B configuration (28 layers, d
   4,096, 32 query heads with 2 KV heads, d_ff 13,696, V 65,024, partial
   RoPE 0.5, QKV bias, bf16; 6.24 B synthetic parameters from ``--seed``,
   the table shared over c = 4 clouds). (a) Slice 8's private and
   plaintext ``BatchServer`` generation, 4 requests of 128 prompt tokens
   and 32 new ones: identical tokens and prefill logits, one
   ``share_onehot`` and one contraction a lookup (the general
   ``ss_matmul`` at the 512-row prefills, the tall one at the decode
   steps), each kernel shape equal to its plain version; (b) the same
   prompts through ``lm.prefill`` and ``lm.decode_step`` on a (1, 1) NCCL
   mesh, DTensor parameters, batches and a cache placed by
   ``sharding.cache_spec``: greedy tokens equal to (a)'s and the first
   two steps' logits equal to the unsharded run's bit for bit. Then
   Gemma3-1B in full (26 layers, d 1,152, 4 heads with 1 KV
   head of 256, a 512-token window on 5 of 6 layers, V 262,144, tied
   embeddings) as (a), 4 × 64 prompt tokens. A ``slice-15 summary`` line
   gives the card's name and power limit, (a)'s prefill ms, ms a decode
   step, tokens/s, idle share and peak, (b)'s, Gemma3's and the seconds.
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

The default run takes one card and logs one line for each multi-card
phase, which it does not run. ``--grids`` runs only those, on NCCL ranks
over the cards of one host (4 or more run them all; each phase that needs
more cards than the host has logs that it did not run). For each grid
size (1, 2 and 4 cards) a world of that many ranks is spawned as
``torchrun --nproc-per-node=N`` starts one (its environment variables);
each rank starts through the port's ``launch.mesh.init_ranks``, lays each
grid of that size over the whole world with ``make_mesh`` (row by row)
and tears its process group down at the end. Qwen1.5-4B at
t1's shapes (4 x 512, 3 steps of ``launch.train.main(mesh=)``) on (1, 1),
(1, 2), (2, 1) and (2, 2): losses within 2e-3 of (1, 1)'s, and one
private-embedding step a grid with one ``share_onehot`` and one
``ss_matmul`` on each rank's card, each equal to its plain version, the
opened rows the unsharded lookup's. Checkpoints: a full Qwen1.5-4B run
at (2, 2) killed after its step-1 checkpoint (39.5 GB of parameters and
AdamW moments), restored at (1, 4) and unsharded bit for bit against
what the run held, and restarted at (1, 4) within 2e-3 of the
uninterrupted losses. Granite-3.0-3B-A800M
on (1, 1), (1, 2), (2, 1), (1, 4) and (2, 2): 3 einsum-dispatch steps
within 2e-3 of (1, 1)'s, one sort-dispatch step at capacity 1.25 in bf16
within 2e-3 of the unsharded step's and, at full width in float32,
within 1e-6 with equal dropped pairs: on 16 of its 32 layers against the
unsharded step at (1, 2), (2, 1) and (4, 1), on all 32 at (1, 4) and
(2, 2) against (4, 1). Every family at its full width and depth
(``FAMILY_SERVE``, ChatGLM3-6B among them; InternVL2-76B's 80 layers at
(1, 4), 20 at (2, 2)) on (1, 4) with one request and on (2, 2) with
four, each rank drawing only its own parameter blocks
(``init_params(mesh=)``), the first decode step private: tokens equal
to the unsharded run's up to near-ties (for InternVL2-76B and Moonlight
an unsharded run on rank 0's card that draws each layer when it reaches
it), the cache placed as each grid splits it, one ``share_onehot`` and
one ``ss_matmul`` on each rank's card with the table's rows opened bit
for bit, each rank's peak logged beside its reckoning. One step of Qwen
at (2, 2) and of Granite at (1, 4) profiled: NCCL's kernels' device ms
by collective beside the cost walker's bytes and ``t_collective`` for
the same step; each collective alone beside the walker's time for it
(logged, with their ratio). ``MeshDispatcher`` (slice 11 (b)) over 2 and 4 distinct
cards in strict mode, equal to the 1 x 1 grid, group 0's clouds
unmoved, every kernel launched on each card. Logs ms a step or a decode
step, each rank's peak and rank 0's idle share; every failed check is
gathered and fails the run at its end.

``--grids-train`` trains, on one world of four NCCL ranks over four
cards, the families whose training state no card holds, at their full
published width in bf16 with remat, 4 sequences a step, each rank drawing
only its own blocks: ChatGLM3-6B's 28 layers at (1, 4) and (2, 2)
through ``launch.train.main(mesh=)``, Moonlight at 38 of 48 layers and
InternVL2-76B at 24 of 80 (each sequence 256 patches and 256 tokens) at
(1, 4) through the launcher's loop. Each trained run: three steps (finite
losses, grad_norm > 0, the scheduled lr, layer 0 moved), step 0's loss
within 2e-3 of an unsharded forward on rank 0's card that draws each
layer when it reaches it; at 2 layers in float32 every gradient leaf
within 1e-4 relative of one card's; at a depth one card holds (16, 4
and 2 layers) three steps within 2e-3 of one card's; ChatGLM3-6B's two
grids within 2e-3 of each other; a private-embedding step at (1, 4) with
one ``share_onehot`` and one ``ss_matmul`` over each rank's vocabulary
block, each equal to its plain version. Logs ms a step, tokens/s, each
rank's peak beside the dry-run's, rank 0's idle share, device ms by
kernel kind and NCCL's ms by collective.

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


#: a spawned rank's lines begin with its rank (:func:`rank_main`)
LOG_PREFIX = ""


def log(msg: str) -> None:
    print(LOG_PREFIX + msg, flush=True)


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


def employee_db(rows: np.ndarray, seed: int):
    """The Employee relation outsourced as the README's schema: c = 20
    clouds, degree 1, words of 8, Salary also in SALARY_BITS-bit binary."""
    from repro_torch.core import Codec, outsource
    return outsource(rows.tolist(), n_shares=20, column_names=NAMES,
                     codec=Codec(word_length=8), degree=1, seed=seed,
                     numeric_columns={NAMES.index("Salary"): SALARY_BITS})


def main_path(torch, args, expect_strategy):
    """Phase 3, slice 1: outsourcing, count and selection at full size
    through the public entry points."""
    from repro_torch.api import Count, Eq, Padding, QueryClient, Select
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
    db = employee_db(rows, args.seed)
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
    Returns the launches of the ``grid`` run, in all and by card."""
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
    launches, by_card = ops.launch_counts(), ops.card_launch_counts()
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
        f"launches {json.dumps(launches)}, by card {json.dumps(by_card)}; "
        f"peak device memory above the resident relations, GB "
        + json.dumps({k: round(v, 3) for k, v in peaks.items()}))
    return launches, by_card


def slice11_isolation(torch, args, db, plans, want, grid, label):
    """The non-communicating clouds on ``grid``: run the count and the
    one-round select with every cloud step run twice, the first time with
    each share of the blocks of the cloud groups after group 0 raised by
    one (mod p) in place (a block on the relation's own card is a view of
    it, a block on another card its copy there), then as shared. Group
    0's clouds of each step's result must be bit-identical in both runs
    and the other clouds must differ, so a block that read another
    group's shares fails; the answers must stay the plaintext's."""
    from repro_torch import _tree
    from repro_torch.api import MeshDispatcher, QueryClient

    class Isolating(MeshDispatcher):
        steps = moved = 0

        def run_set(self, plane, ds):
            k = self.groups(plane.db.n_shares)[0][1]
            self.bind_plane(plane)
            held = [t for blk, view in plane._placed.items() if blk.group
                    for t in [view.relation.values] + [
                        s.values for s in view.numeric.values()]]
            for t in held:
                t.add_(1).remainder_(P)
            try:
                changed = super().run_set(plane, ds)
            finally:
                for t in held:
                    t.sub_(1).remainder_(P)
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


def slice11_child(args, rows, n_child):
    """(rows, shares) of the first ``n_child`` rows of slice 5's
    Assignment relation over ``rows``, the PK/FK join's child."""
    from repro_torch.core import Codec, outsource
    assign = make_assignments(rows, args.seed)[:n_child]
    return assign, outsource(assign.tolist(), n_shares=20,
                             column_names=ASSIGN_NAMES,
                             codec=Codec(word_length=8), degree=1,
                             seed=args.seed + 5)


def slice11_path(torch, args, db, rows):
    """Phase 3, slice 11: the Employee relation's cloud steps through
    ``MeshDispatcher`` on a grid. (a) A 2 x 2 grid of ``cuda:0`` at the
    full n (2 data rows, 2 groups of 10 clouds); every kernel of the path
    must launch there. (b) Distinct devices: every card (n_model 2 when
    their count is even) at the full n, or on a one-card host
    ``[cuda:0, cpu]`` on the model axis at HOST_HALF_TUPLES, cloud group 1
    on the host. Returns the launches of both grid runs."""
    from repro_torch.launch.mesh import make_dispatch_mesh

    t0 = time.perf_counter()
    assign, child_db = slice11_child(args, rows, N_ASSIGN)
    plans, want = slice11_cases(rows, assign, child_db, args.seed)
    grid = make_dispatch_mesh(2, devices=["cuda:0"] * 4)
    launches, _ = slice11_check(torch, args, db, plans, want, grid,
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
        db_b = employee_db(rows_b, args.seed)
        assign_b, child_b = slice11_child(args, rows_b, HOST_HALF_CHILD)
    log(f"slice 11 {label}: {db_b.n_tuples} tuples, a "
        f"{child_b.n_tuples}-row child relation")
    plans, want = slice11_cases(rows_b, assign_b, child_b, args.seed)
    launches_b, _ = slice11_check(torch, args, db_b, plans, want, grid,
                                  label)
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
                slice_no=8, keep=None):
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
    encoder's. With ``keep`` (a dict), stores there the configuration
    (``cfg``), the prompts, route (a)'s tokens and route (c)'s parameters
    (``plain``) for a later phase. Returns (the route windows' launches,
    the family's summary)."""
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
    if cfg.tie_embeddings:
        # a tied head reads the table, which the operator holds as its
        # quantized form: both routes' heads read the dequantized rows
        params["embed"] = plain["embed"]
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
    if keep is not None:
        keep.update(cfg=cfg, prompts=prompts, tokens=toks_a, plain=plain)
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
#: t1's losses, which slice 13 holds its mesh steps against
SLICE10_T1_LOSSES = []


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
    """A profiled kernel's kind by its name: NCCL's collectives, matrix
    products (cuBLAS's ``nvjet``/``gemm``/``cutlass`` kernels),
    elementwise, reductions, or other (copies, index and scatter kernels,
    the log-softmax)."""
    low = name.lower()
    if "nccl" in low:
        return "nccl"
    if any(k in low for k in ("nvjet", "gemm", "cutlass", "sm90_xmma")):
        return "matmul"
    if "elementwise" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduce"
    return "other"


def train_batch(cfg, stream, i, frontend=None, seed=0):
    """Batch ``i`` of ``stream`` (a ``TokenStream``) as the reference's
    smoke test builds a training batch (``tests/test_arch_smoke.py``
    ``make_batch``): tokens and labels int64 (B, T), the integers of
    ``jax.random.randint`` under the reference's 64-bit mode, and, for a
    family with a frontend, its input beside them: ``frontend`` = (name,
    n), ``frames`` or ``patches`` float32 (B, n, frontend_dim), standard
    normal, drawn with numpy from (``seed``, ``i``)."""
    out = {k: a.astype(np.int64) for k, a in stream.batch_at(i).items()}
    if frontend is not None:
        name, n = frontend
        rng = np.random.default_rng((seed, 23, i))
        out[name] = rng.standard_normal(
            (stream.batch, n, cfg.frontend_dim)).astype(np.float32)
    return out


def frontend_train(torch, args, cfg, steps, frontend, on_step, mesh=None,
                   seq=None):
    """``launch.train.main``'s loop for a family whose batches carry a
    frontend input, which the launcher's token batches do not (nor the
    reference's), or for a depth the launcher does not take (it trains
    ``configs.full``'s): its AdamW settings, weights and token stream from
    ``--seed`` (``seq`` tokens a sequence, default TRAIN_SEQ), each batch
    from :func:`train_batch`, through ``make_train_step``,
    ``on_step(step, params, opt_state, metrics)`` after each step. On
    ``mesh`` each rank draws its own blocks (``init_params(mesh=)``) and
    uploads its data-axis rows of every batch entry, as the launcher
    does. Returns the last step's loss."""
    from repro_torch import sharding
    from repro_torch.data import make_lm_batches
    from repro_torch.data.pipeline import to_device
    from repro_torch.models import lm
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=max(2, steps // 10),
                      total_steps=steps)
    step_fn = make_train_step(cfg, opt)
    params = lm.init_params(args.seed, cfg, mesh=mesh)
    state = init_state(params)
    stream = make_lm_batches(cfg, TRAIN_BATCH, seq or TRAIN_SEQ,
                             seed=args.seed)
    dev = (params["final_norm"].device if mesh is None
           else sharding.mesh_device(mesh))
    dp = None if mesh is None else sharding.dp_entry(mesh)
    metrics = None
    for step in range(steps):
        b = train_batch(cfg, stream, step, frontend, args.seed)
        specs = None if mesh is None else {
            k: (dp,) + (None,) * (a.ndim - 1) for k, a in b.items()}
        batch = to_device(b, dev, mesh=mesh, specs=specs)
        params, state, metrics = step_fn(params, state, batch)
        on_step(step, params, state, metrics)
    return float(metrics["loss"])


def train_peak(cfg, frontend=None, private=False) -> dict:
    """A full-width training step's peak device memory (GB), reckoned from
    the shapes before it runs: the state (bf16 parameters and gradients,
    float32 AdamW m and v: 12 B a parameter), the checkpoints remat keeps
    (each decoder layer's bf16 input, and each encoder layer's over the
    frames), three float32 copies of the (B, T, V) logits (the logits,
    their exponentials, their gradient) and, with the private lookup, its
    int32 one-hot shares (c, B·T, V) and a1 (B·T, V) and the table's
    shares (c, V, d)."""
    m, v, d = TRAIN_BATCH * TRAIN_SEQ, cfg.vocab_size, cfg.d_model
    enc = TRAIN_BATCH * frontend[1] if cfg.n_enc_layers else 0
    out = {"state": 12 * cfg.param_count(),
           "remat": 2 * d * (cfg.n_layers * m + cfg.n_enc_layers * enc),
           "logits": 3 * 4 * m * v,
           "lookup": (4 * ((EMBED_SHARES + 1) * m * v + EMBED_SHARES * v * d)
                      if private else 0)}
    out = {k: n / 1e9 for k, n in out.items()}
    out["total"] = sum(out.values())
    return out


def layer_probe(params):
    """(path, layer 0's corner) of the decoder stack's first matrix (its
    first stacked leaf of three or more dims; on a mesh, of this rank's
    block of it): a view, moved by a step."""
    from repro_torch import _device, _tree
    path, w = next((p, t) for p, t in _tree.leaves_with_paths(
        params["blocks"]) if t.ndim >= 3)
    return path, _device.local(w)[0, :8, :64]


def train_t1(torch, args, cfg, arch=TRAIN_ARCH, tag="slice-10",
             frontend=None, price=True):
    """t1: ``launch.train.main`` for T1_STEPS steps of ``arch`` at full
    width (with ``frontend``, :func:`frontend_train`, the launcher's loop
    over batches that carry the frontend's input). Checks finite losses,
    grad_norm > 0, ``lr`` = ``schedule(step + 1)``, the final norm moved
    off its zero init and layer 0's first matrix moved between the first
    and last step. Times steps 1 and 3 (host clock between synchronizes),
    profiles step 2 (``torch.profiler`` device time) for the idle share,
    and reads the peak memory beside :func:`train_peak`'s reckoning. With
    ``price``, slice 12 prices one more step of the model."""
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
        if price and step == T1_STEPS - 1:         # kept for slice 12
            snap["state"] = (params, opt_state)
        m = {k: float(v) for k, v in metrics.items()}
        want_lr = float(schedule(opt, step + 1))
        rec.append(m)
        check(math.isfinite(m["loss"]) and m["grad_norm"] > 0
              and abs(m["lr"] - want_lr) <= 1e-6 * want_lr,
              f"{tag} t1 step {step}: {m} (lr should be {want_lr})")
        path, w = layer_probe(params)
        if step == 0:
            snap["w"] = w.clone()
            check(bool((params["final_norm"] != 0).any()),
                  f"{tag} t1: final_norm did not move off its init")
        if step == 1:
            prof["p"] = profile(activities=[ProfilerActivity.CUDA])
            prof["p"].__enter__()
        if step == 2:
            prof["p"].__exit__(None, None, None)
        if step == T1_STEPS - 1:
            check(not torch.equal(w, snap["w"]),
                  f"{tag} t1: layer 0's {path} did not move")

    reckoned = train_peak(cfg, frontend)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if frontend is None:
        final = train_launcher.main(
            ["--arch", arch, "--steps", str(T1_STEPS), "--batch",
             str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr",
             str(TRAIN_LR), "--log-every", "1", "--seed", str(args.seed)],
            on_step=on_step)
    else:
        final = frontend_train(torch, args, cfg, T1_STEPS, frontend,
                               on_step)
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(len(rec) == T1_STEPS and final == rec[-1]["loss"],
          f"{tag} t1: the loop did not run every step")
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
           "peak_gb": peak, "reckoned_peak_gb": reckoned,
           "profiled_step_device_ms": device_ms,
           "idle_share": 1.0 - device_ms / plain_ms,
           "profiled_step_kernels": launches,
           "device_ms_by_kind": dict(kinds),
           "slowest_kernels_ms": top}
    route = "launch.train.main" if frontend is None \
        else f"make_train_step, {frontend[1]} {frontend[0]} a sequence"
    log(f"{tag} t1 ({route}, plaintext) " + json.dumps(out))
    if not price:
        return out
    # slice 12: one more step of t1's model and optimizer state, priced
    from repro_torch.data import make_lm_batches
    from repro_torch.data.pipeline import to_device
    from repro_torch.train import make_train_step
    params, opt_state = snap.pop("state")
    step_fn = make_train_step(cfg, opt)
    batch = to_device(make_lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                      seed=args.seed).batch_at(T1_STEPS),
                      params["final_norm"].device)
    price_step(torch, f"slice-10 t1 {arch} train step "
               f"({TRAIN_BATCH} x {TRAIN_SEQ} tokens)",
               lambda: step_fn(params, opt_state, batch))
    del params, opt_state, batch, step_fn
    return out


def f32_train_check(torch, args, cfg, tag="slice-10",
                    tokens=F32_TRAIN_TOKENS, frontend=None):
    """t1's float32 check: F32_TRAIN_LAYERS layers (and as many encoder
    layers) at full width, one step's loss and gradients on the card
    against the same port code on the CPU (weights drawn on the card,
    copied to the host; ``tokens`` = (B, T), with ``frontend`` its input
    from :func:`train_batch`): loss within F32_TRAIN_TOL, each leaf's
    gradient within a relative F32_TRAIN_TOL. Returns the largest
    differences."""
    import dataclasses

    from repro_torch import _tree
    from repro_torch.data import TokenStream
    from repro_torch.models import lm
    from repro_torch.train import step as tstep

    check(not torch.backends.cuda.matmul.allow_tf32,
          f"{tag}: TF32 matmuls are on; the float32 check needs them off")
    f32 = dataclasses.replace(
        cfg, n_layers=F32_TRAIN_LAYERS, dtype="float32",
        n_enc_layers=min(cfg.n_enc_layers, F32_TRAIN_LAYERS))
    _free(torch)
    params = lm.init_params(args.seed, f32)
    host = _tree.map_leaves(lambda t: t.cpu(), params)
    b, t = tokens
    batch = train_batch(f32, TokenStream(f32.vocab_size, b, t,
                                         seed=args.seed), 7, frontend,
                        args.seed)
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
          f"{tag}: float32 step on the card differs from the CPU: loss "
          f"{out['card'][0]} vs {out['cpu'][0]}, gradient {worst} relative "
          f"{rel[worst]} (tolerance {F32_TRAIN_TOL})")
    res = {"layers": F32_TRAIN_LAYERS, "enc_layers": f32.n_enc_layers,
           "tokens": [b, t], "frontend": frontend,
           "loss_card": out["card"][0], "loss_cpu": out["cpu"][0],
           "loss_abs_err": loss_err, "worst_grad": worst,
           "worst_grad_rel_err": rel[worst],
           "card_s": out["card"][2], "cpu_s": out["cpu"][2]}
    log(f"{tag} float32 card vs CPU " + json.dumps(res))
    del params, host, out
    _free(torch)
    return res


def adamw_replay(torch, opt, before, m, v, step, lr):
    """A decayed matrix's values after an AdamW update, from ``before``
    (its values before the step), its moments ``m`` and ``v`` after it,
    the step counter after it and the step's ``lr`` (a tensor), by the
    operations of ``train.optim._update_slice``: so bit for bit."""
    step = step.to(torch.float32)
    bc1 = 1.0 - opt.beta1 ** step
    bc2 = 1.0 - opt.beta2 ** step
    denom = (v / bc2).sqrt_().add_(opt.eps)
    delta = (m / bc1).div_(denom)
    pf = before.to(torch.float32)
    delta.add_(pf, alpha=opt.weight_decay)
    return (pf - lr * delta).to(before.dtype)


def train_t2(torch, args, cfg, errs, tag="slice-10", frontend=None):
    """t2: ``private_embed=True`` through ``make_train_step``, T2_STEPS
    steps at full width (with ``frontend``, batches from
    :func:`train_batch`). Each step's forward re-shares the table (c = 4)
    and launches one ``share_onehot`` and one general ``ss_matmul``
    (2,048 rows: not tall) on the card, counted by card from zero just
    before the step and read after a synchronize. One step's embeddings
    must equal the dequantized table's rows exactly (times
    sqrt(d_model) where ``embed_scale`` is set), with no gradient path,
    and ``embed`` must follow the AdamW rule on its moments: an untied one
    gets no gradient (m stays zero, so it only decays), a tied one gets
    the head's. Then, on a freed card, both kernels at these shapes
    against their plain versions (the contraction PLAIN_COLS columns at a
    time), and timed. Returns (launches, summary)."""
    import dataclasses

    from repro_torch.core.queries import embed as eq
    from repro_torch.data import TokenStream
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    pcfg = dataclasses.replace(cfg, private_embed=True)
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=T2_STEPS)
    reckoned = train_peak(cfg, frontend, private=True)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params((args.seed, 10, 2), pcfg)
    state = init_state(params)
    step_fn = make_train_step(pcfg, opt)
    stream = TokenStream(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                         seed=args.seed)
    card = params["embed"].device.index
    seen = {}
    inner = lm._embed_tokens

    def recording(*a, **kw):
        out = inner(*a, **kw)
        seen["emb"] = out.clone()
        seen["grad"] = out.requires_grad
        return out

    total = collections.Counter()
    rec = []
    lm._embed_tokens = recording
    try:
        for i in range(T2_STEPS):
            batch = train_batch(cfg, stream, i, frontend, args.seed)
            dev_batch = to_device(batch, params["embed"].device)
            toks = dev_batch["tokens"].long()
            rows = params["embed"][toks].clone()
            probe = params["embed"][:64].clone()
            _free(torch)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            params, state, mt = step_fn(params, state, dev_batch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            got = ops.card_launch_counts()
            total.update({k: sum(n.values()) for k, n in got.items()})
            check_onehot_quad(ops, f"{tag} t2 step {i}")
            want = {k: ({card: 1} if k in SLICE10_KERNELS else {})
                    for k in got}
            check(got == want, f"{tag} t2 step {i}: launched {got} by "
                  f"card, one lookup a step wants {want}")
            m = {k: float(v) for k, v in mt.items()}
            check(math.isfinite(m["loss"]) and m["grad_norm"] > 0,
                  f"{tag} t2 step {i}: {m}")
            want_emb = eq.dequantize_from_field(eq.quantize_to_field(
                rows, device=rows.device)).to(rows.dtype)
            if cfg.embed_scale:
                want_emb = want_emb * torch.tensor(
                    math.sqrt(cfg.d_model), dtype=want_emb.dtype,
                    device=want_emb.device)
            check(torch.equal(seen["emb"], want_emb) and not seen["grad"],
                  f"{tag} t2 step {i}: the private embeddings differ "
                  f"from the dequantized table's rows"
                  f"{' times sqrt(d_model)' if cfg.embed_scale else ''}, "
                  f"or a gradient reaches the table through them")
            after = adamw_replay(torch, opt, probe,
                                 state.m["embed"][:64],
                                 state.v["embed"][:64], state.step,
                                 mt["lr"])
            # the lookup passes no gradient: an untied embed gets none (in
            # bf16 its decay of lr·wd ~ 3e-5 mostly rounds back to the
            # stored value; the rule, not a visible change, is checked), a
            # tied one gets the head's
            got_grad = bool(state.m["embed"].any())
            check(torch.equal(params["embed"][:64], after)
                  and got_grad == cfg.tie_embeddings,
                  f"{tag} t2 step {i}: embed "
                  f"{'got' if got_grad else 'got no'} gradient (tied: "
                  f"{cfg.tie_embeddings}) or did not follow the AdamW "
                  f"rule on its moments")
            moved = int((params["embed"][:64] != probe).sum())
            rec.append(dict(m, step_s=step_s, embed_probe_moved=moved))
    finally:
        lm._embed_tokens = inner
    peak = torch.cuda.max_memory_allocated() / 1e9
    dev = probe.device
    del params, state, seen, rows, probe
    _free(torch)

    # the kernels at t2's shapes, on a freed card
    summary = {"steps": rec, "peak_gb": peak, "reckoned_peak_gb": reckoned,
               "launches": dict(total)}
    summary.update(lookup_kernel_times(
        torch, args.seed + 10, dev, cfg.vocab_size, cfg.d_model, errs, tag))
    log(f"{tag} t2 (private embedding, make_train_step) "
        + json.dumps(summary))
    return dict(total), summary


def lookup_kernel_times(torch, seed, dev, v, d, errs, tag):
    """The private lookup's two kernels at a training step's shapes on
    ``dev``: ``share_onehot`` of TRAIN_BATCH x TRAIN_SEQ random tokens over
    ``v`` rows into EMBED_SHARES shares, then ``ss_matmul`` of those shares
    with a random (EMBED_SHARES, v, d) table, each held to its plain
    version bit for bit (the contraction PLAIN_COLS columns at a time;
    the largest difference into ``errs``) and timed beside it (CUDA
    events) and its bound -> {kernel: shape, ms, plain_ms, bound}."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ss_matmul as ssm

    gen = torch.Generator(device=dev).manual_seed(seed)
    c, mrows = EMBED_SHARES, TRAIN_BATCH * TRAIN_SEQ
    toks = torch.randint(0, v, (mrows,), generator=gen, device=dev)
    a1 = rand_field(torch, gen, (mrows, v), dev)
    shared = ops.share_onehot(toks, a1, n_shares=c)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want_sh = ssm.share_onehot_plain(toks, a1, n_shares=c)
    stop.record()
    torch.cuda.synchronize()
    onehot_plain_ms = start.elapsed_time(stop)
    check(torch.equal(shared, want_sh), f"{tag}: share_onehot at "
          f"{(c, mrows, v)} differs from its plain version")
    errs["share_onehot"] = max(errs["share_onehot"],
                               max_err(torch, shared, want_sh))
    del want_sh
    onehot_ms = time_ms(torch, lambda: ops.share_onehot(toks, a1,
                                                        n_shares=c), 5)
    del a1
    table = rand_field(torch, gen, (c, v, d), dev)
    check(not ssm.is_tall_skinny(mrows, v, d),
          f"{tag}: the train lookup should not be tall")
    got_mm = ops.ss_matmul(shared, table)
    plain_ms = 0.0
    for lo in range(0, d, PLAIN_COLS):
        start.record()
        want_mm = ssm.ss_matmul_plain(shared, table[..., lo:lo + PLAIN_COLS])
        stop.record()
        torch.cuda.synchronize()
        plain_ms += start.elapsed_time(stop)
        check(torch.equal(got_mm[..., lo:lo + PLAIN_COLS], want_mm),
              f"{tag}: ss_matmul at M = {mrows}, columns {lo}.. differs "
              f"from its plain version")
        errs["ss_matmul"] = max(errs["ss_matmul"],
                                max_err(torch, got_mm[..., lo:lo + PLAIN_COLS],
                                        want_mm))
        del want_mm
    del got_mm
    mm_ms = time_ms(torch, lambda: ops.ss_matmul(shared, table), 3)
    mm_bytes = 4 * (c * mrows * v + c * v * d + c * mrows * d)
    mm_ops = 32 * c * mrows * v * d
    out = {"share_onehot": {"shape": [c, mrows, v], "ms": onehot_ms,
                            "plain_ms": onehot_plain_ms,
                            "bound": bound(4 * (mrows * v + mrows
                                                + c * mrows * v),
                                           (c + 1) * mrows * v)},
           "ss_matmul": {"shape": [c, mrows, v, d], "ms": mm_ms,
                         "plain_ms": plain_ms,
                         "bound": bound(mm_bytes, mm_ops,
                                        INT8_TENSOR_OPS_PER_S)}}
    del shared, table
    _free(torch)
    return out


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
    SLICE10_T1_LOSSES[:] = t1["losses"]
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


#: slice 23 trains, on one card, every family besides slice 10's whose
#: training state a card holds (12 B a parameter: bf16 parameters and
#: gradients, float32 AdamW m and v), each at its full published
#: configuration (FAMILY_SERVE's fields, every layer, bf16, remat), the
#: likeliest trouble first: Gemma3-1B (12.0 GB of state; sliding windows,
#: QK-norm, a tied 262,144-row table), MiniCPM3-4B (51.1; MLA over 62
#: layers), Mamba2-2.7B (34.0; the chunked scan over 64 layers),
#: Hymba-1.5B (19.7; attention beside the SSM; V 32,001 leaves the
#: lookup's matmul a last K stage of one column, d 1,600 is 25 column
#: tiles of 64) and
#: SeamlessM4T-medium (11.7; the encoder and its cross-attention over 640
#: frames). ChatGLM3-6B (74.9 GB), Moonlight (347) and InternVL2-76B (847)
#: need more than one card.
SLICE23_FAMILIES = ("gemma3_1b", "minicpm3_4b", "mamba2_2_7b", "hymba_1_5b",
                    "seamless_m4t_medium")
#: the float32 check's tokens where F32_TRAIN_TOKENS would leave a path
#: unrun: Gemma3's 512-token windows mask only keys 512 or more positions
#: back (t1's 512 tokens mask none), and 640 take two 512-key blocks
F32_TRAIN_TOKENS_OF = {"gemma3_1b": (1, 640)}


def slice23_family(torch, args, errs, arch):
    """Slice 23, one family: t1 (T1_STEPS plaintext steps), the float32
    card-against-CPU check and t2 (the private embedding and its kernels
    at the family's shapes), each on a freed card. Returns (t2's
    launches, the family's summary)."""
    t0 = time.perf_counter()
    cfg, _, frontend = family_cfg(arch)
    check(cfg.remat, f"slice 23: {arch} trains without remat")
    tag = f"slice-23 {arch}"
    t1 = train_t1(torch, args, cfg, arch=arch, tag=tag, frontend=frontend,
                  price=False)
    f32 = f32_train_check(torch, args, cfg, tag=tag, frontend=frontend,
                          tokens=F32_TRAIN_TOKENS_OF.get(arch,
                                                         F32_TRAIN_TOKENS))
    launches, t2 = train_t2(torch, args, cfg, errs, tag=tag,
                            frontend=frontend)
    summary = {
        "card": smi("name,power.limit"), "layers": cfg.n_layers,
        "enc_layers": cfg.n_enc_layers, "parameters": cfg.param_count(),
        "ms_per_step": t1["ms_per_step"],
        "tokens_per_s": t1["tokens_per_s"], "peak_gb": t1["peak_gb"],
        "reckoned_peak_gb": t1["reckoned_peak_gb"]["total"],
        "idle_share": t1["idle_share"],
        "device_ms_by_kind": t1["device_ms_by_kind"],
        "losses": t1["losses"],
        "f32_loss_abs_err": f32["loss_abs_err"],
        "f32_worst_grad": f32["worst_grad"],
        "f32_worst_grad_rel_err": f32["worst_grad_rel_err"],
        "t2_step_s": [s["step_s"] for s in t2["steps"]],
        "t2_peak_gb": t2["peak_gb"],
        "t2_reckoned_peak_gb": t2["reckoned_peak_gb"]["total"],
        "share_onehot_ms": t2["share_onehot"]["ms"],
        "share_onehot_bound": t2["share_onehot"]["bound"],
        "ss_matmul_ms": t2["ss_matmul"]["ms"],
        "ss_matmul_plain_ms": t2["ss_matmul"]["plain_ms"],
        "ss_matmul_bound": t2["ss_matmul"]["bound"],
        "launches": launches, "seconds": time.perf_counter() - t0}
    log(f"{tag} summary " + json.dumps(summary))
    return launches, summary


def slice23_path(torch, args, errs):
    """Phase 3, slice 23 (after slice 10, on a freed card): training at
    the full published configuration of each family of SLICE23_FAMILIES,
    one after another (:func:`slice23_family`). Returns the launches of
    the t2 step windows, summed over the families."""
    total = collections.Counter()
    t0 = time.perf_counter()
    for arch in SLICE23_FAMILIES:
        got, _ = slice23_family(torch, args, errs, arch)
        total.update(got)
        _free(torch)
    for name in SLICE10_KERNELS:
        check(total[name] == T2_STEPS * len(SLICE23_FAMILIES),
              f"slice 23 launched {total[name]} {name}, not one a t2 step")
    log(f"slice-23 launches {dict(total)} in "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(total)


#: slice 13: the production-mesh path (DTensor parameters over a
#: ("data", "model") DeviceMesh of NCCL ranks) at t1's shapes
SLICE13_STEPS = 3
#: slice 13's losses against t1's (same seed, batches and weights): step
#: 0 is the same forward (within 1e-6 relative); the later steps follow
#: updates whose global norm sums the leaves in another order, so their
#: bf16 parameters may differ in a last bit: within 2e-3 relative
SLICE13_STEP0_RTOL, SLICE13_LOSS_RTOL = 1e-6, 2e-3
SLICE13_KERNELS = ("share_onehot", "ss_matmul")
#: layers of the full-width step the walker prices at (1, 1)
SLICE13_WALK_LAYERS = 2


def slice13_mesh(torch):
    """A one-rank NCCL process group on this card, started as ``torchrun``
    would (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, a free localhost
    port) through ``launch.mesh.init_ranks``, and its (1, 1) mesh."""
    from repro_torch.launch.mesh import init_ranks, make_mesh
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dev = init_ranks()
    check(dev == torch.device("cuda", 0), f"slice 13: init_ranks gave {dev}")
    return make_mesh((1, 1), ("data", "model"))


def placed_params(torch, seed, cfg, mesh, tag):
    """``lm.init_params(seed, cfg, mesh=mesh)``: this rank draws each
    leaf and keeps its own block only. On a one-rank mesh (the default
    run's slices 13 and 14), where the rank's blocks are the whole tree, the
    largest leaf of the decoder stack is held with ``torch.equal`` to the
    whole init's (drawn after it on the same card, then dropped)."""
    from repro_torch import _tree, sharding
    from repro_torch.models import lm
    params = lm.init_params(seed, cfg, mesh=mesh)
    if mesh.size() == 1:
        path, got = max(((p, t) for p, t in _tree.leaves_with_paths(params)
                         if p.startswith("blocks/")),
                        key=lambda pt: pt[1].numel())
        whole = lm.init_params(seed, cfg, device=sharding.mesh_device(mesh))
        same = torch.equal(got.to_local(),
                           dict(_tree.leaves_with_paths(whole))[path])
        del whole
        _free(torch)
        log(f"{tag}: the placed init's {path} {tuple(got.shape)} equals "
            f"the whole init's: {same}")
        check(same, f"{tag}: the placed init's {path} differs from the "
              "whole init's")
    return params


def slice13_argv(args, steps):
    return ["--arch", TRAIN_ARCH, "--steps", str(steps), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR),
            "--log-every", "1", "--seed", str(args.seed)]


def slice13_train(torch, args, mesh, t1_losses):
    """SLICE13_STEPS steps of ``launch.train.main(mesh=)`` at full width:
    DTensor parameters, moments and batches; the losses against t1's; ms a
    step (host clock between synchronizes, steps 0 and 2), the idle share
    over a profiled step 1 and the peak memory."""
    from repro_torch.launch import train as train_launcher
    from torch.profiler import ProfilerActivity, profile

    marks, losses, prof, seen = [], [], {}, {}

    def on_step(step, params, opt_state, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        losses.append(float(metrics["loss"]))
        if step == 0:
            w = params["blocks"]["mlp"]["w_up"]
            seen["placements"] = [repr(p) for p in w.placements]
            seen["dtensor"] = type(w).__name__
            seen["moment"] = type(opt_state.m["blocks"]["mlp"]["w_up"]
                                  ).__name__
            prof["p"] = profile(activities=[ProfilerActivity.CUDA])
            prof["p"].__enter__()
        if step == 1:
            prof["p"].__exit__(None, None, None)

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final = train_launcher.main(slice13_argv(args, SLICE13_STEPS), mesh=mesh,
                                on_step=on_step)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(seen.get("dtensor") == "DTensor" and seen.get("moment")
          == "DTensor", f"slice 13: the parameters or moments were not "
          f"DTensors: {seen}")
    check(len(losses) == SLICE13_STEPS and final == losses[-1],
          "slice 13: main did not run every step")
    for i, (got, want) in enumerate(zip(losses, t1_losses)):
        tol = SLICE13_STEP0_RTOL if i == 0 else SLICE13_LOSS_RTOL
        check(abs(got - want) <= tol * abs(want),
              f"slice 13 step {i}: loss {got} on the mesh, {want} in "
              f"slice 10's t1 (rtol {tol})")
    device_ms = 0.0
    for e in prof["p"].key_averages():
        device_ms += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0)) / 1e3
    step_ms = 1e3 * (marks[1] - marks[0])             # step 1, profiled
    plain_ms = 1e3 * (marks[2] - marks[1])            # step 2
    out = {"losses": losses, "t1_losses": t1_losses[:SLICE13_STEPS],
           "loss_rel_diff": [abs(a - b) / abs(b) for a, b in
                             zip(losses, t1_losses)],
           "placements_w_up": seen["placements"], "ms_per_step": plain_ms,
           "profiled_step_ms": step_ms, "profiled_step_device_ms": device_ms,
           "idle_share": 1.0 - device_ms / step_ms, "peak_gb": peak,
           "first_step_and_init_s": marks[0] - t0}
    log("slice-13 train (launch.train.main on the (1, 1) mesh) "
        + json.dumps(out))
    return out


def slice13_private(torch, args, mesh, errs, cfg=None, tag="slice 13"):
    """One private-embedding step at full width on ``mesh`` (the (1, 1)
    mesh, or a grid of ``--grids``; ``make_train_step`` on DTensor
    parameters and batch) of ``cfg`` (default slice 10's configuration):
    launch counters zeroed just before it, each kernel launched once, on
    this rank's card, its operands there too; the DTensor path's ``share_onehot`` and ``ss_matmul`` calls
    (the kernels' wrappers in ``kernels.ss_matmul`` wrapped, their
    operands kept) held after the step, on a freed card, against their
    plain versions (the contraction PLAIN_COLS columns at a time); the
    opened rows equal to the unsharded lookup's (the dequantized table's
    rows) bit for bit. ``tag`` names the slice in its lines."""
    import dataclasses

    from repro_torch import sharding
    from repro_torch.core.queries import embed as eq
    from repro_torch.data import TokenStream
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels import ops
    from repro_torch.kernels import ss_matmul as ssm
    from repro_torch.models import private_embed as pe
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    pcfg = dataclasses.replace(cfg or train_cfg(torch), private_embed=True)
    _free(torch)
    params = placed_params(torch, (args.seed, 13), pcfg, mesh, tag)
    state = init_state(params)
    step_fn = make_train_step(pcfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                                                total_steps=2))
    batch = TokenStream(pcfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                        seed=args.seed).batch_at(0)
    dp, card = sharding.dp_entry(mesh), sharding.mesh_device(mesh)
    dbatch = to_device(batch, card, mesh=mesh,
                       specs={k: (dp, None) for k in batch})
    rows = params["embed"].full_tensor()[
        torch.as_tensor(batch["tokens"], device=card).long()]
    want_rows = eq.dequantize_from_field(eq.quantize_to_field(
        rows, device=rows.device)).to(rows.dtype)
    del rows
    calls, seen = collections.Counter(), {}
    inner_share, inner_mm = ssm.share_onehot_cuda, ssm.ss_matmul_cuda
    inner_lookup = pe.private_lookup_inline

    def share(tokens, a1, *, n_shares):
        out = inner_share(tokens, a1, n_shares=n_shares)
        calls["share_onehot"] += 1
        seen["share"] = (tokens, a1, n_shares, out)
        return out

    def matmul(a, b):
        out = inner_mm(a, b)
        calls["ss_matmul"] += 1
        seen["matmul"] = (a, b, out)
        return out

    def lookup(p, c, tokens, **kw):
        out = inner_lookup(p, c, tokens, **kw)
        seen["rows"] = out.full_tensor().clone()
        seen["type"] = type(out).__name__
        return out

    ssm.share_onehot_cuda, ssm.ss_matmul_cuda = share, matmul
    pe.private_lookup_inline = lookup
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, dbatch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches, by_card = ops.launch_counts(), ops.card_launch_counts()
    finally:
        ssm.share_onehot_cuda, ssm.ss_matmul_cuda = inner_share, inner_mm
        pe.private_lookup_inline = inner_lookup
    check_onehot_quad(ops, f"{tag} private step")
    for name in SLICE13_KERNELS:
        check(launches[name] == 1 and calls[name] == 1
              and by_card[name] == {card.index: 1},
              f"{tag}: the private step launched {launches} (by card "
              f"{by_card}), wrapper calls {dict(calls)}: one {name} a step "
              f"on this rank's card {card} wanted")
    on = {str(t.device) for t in seen["share"][:2] + seen["share"][3:]
          + seen["matmul"]}
    check(on == {str(card)}, f"{tag}: the kernels' operands lie on {on}, "
          f"not on this rank's card {card}")
    check(seen.get("type") == "DTensor" and torch.equal(seen["rows"],
                                                        want_rows),
          f"{tag}: the mesh lookup's opened rows differ from the "
          "unsharded lookup's (the dequantized table's rows)")
    m = {k: float(v) for k, v in m.items()}
    check(math.isfinite(m["loss"]) and m["grad_norm"] > 0,
          f"{tag} private step: {m}")
    # the kernels' calls against their plain versions, on a freed card
    del params, state, dbatch, want_rows
    _free(torch)
    tokens, a1, n_shares, shared = seen.pop("share")
    want = ssm.share_onehot_plain(tokens, a1, n_shares=n_shares)
    if not torch.equal(shared, want):
        errs["share_onehot"] = max(errs["share_onehot"],
                                   max_err(torch, shared, want))
        check(False, f"{tag}: share_onehot on the mesh path differs "
              "from its plain version")
    del want, a1, tokens
    a, b, got = seen.pop("matmul")
    for lo in range(0, b.shape[-1], PLAIN_COLS):
        want = ssm.ss_matmul_plain(a, b[..., lo:lo + PLAIN_COLS])
        if not torch.equal(got[..., lo:lo + PLAIN_COLS], want):
            errs["ss_matmul"] = max(errs["ss_matmul"], max_err(
                torch, got[..., lo:lo + PLAIN_COLS], want))
            check(False, f"{tag}: ss_matmul on the mesh path differs "
                  f"from its plain version at columns {lo}..")
        del want
    out = {"launches": {k: launches[k] for k in SLICE13_KERNELS},
           "card": str(card),
           "shapes": {"share_onehot": list(shared.shape),
                      "ss_matmul": [list(a.shape), list(b.shape)]},
           "step_s": step_s, "metrics": m}
    log(f"{tag.replace(' ', '-')} private step (DTensor path) "
        + json.dumps(out))
    del seen, shared, a, b, got
    _free(torch)
    return launches


def slice13_checkpoint(torch, args, mesh):
    """The smoke configuration's parameters and AdamW state, DTensors on
    the (1, 1) mesh, saved; restored unsharded and at the mesh again:
    every leaf bit for bit."""
    import shutil

    from repro_torch import _tree, configs, sharding
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.models import lm
    from repro_torch.train import init_state
    from repro_torch.train.optim import AdamWState

    cfg = configs.smoke(TRAIN_ARCH)
    params = placed_params(torch, args.seed, cfg, mesh, "slice 13")
    p_sh = sharding.param_shardings(cfg, mesh, params)
    state = init_state(params)
    state.m["final_norm"].to_local().add_(1.5)    # not all zeros
    tree = (params, state)
    whole = [t.full_tensor().clone() for t in _tree.leaves(tree)]
    root = os.path.join(ROOT, "build", "slice13_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    save_checkpoint(root, 1, tree)
    plain = lm.init_params(args.seed, cfg)
    _, back = restore_checkpoint(root, (plain, init_state(plain)),
                                 device=plain["embed"].device)
    same_plain = all(torch.equal(a, b) for a, b in
                     zip(_tree.leaves(back), whole))
    o_sh = AdamWState(step=sharding.NamedSharding(mesh, sharding.REP),
                      m=p_sh, v=p_sh)
    _, again = restore_checkpoint(root, tree, shardings=(p_sh, o_sh))
    same_mesh = all(type(a).__name__ == "DTensor"
                    and torch.equal(a.full_tensor(), b)
                    for a, b in zip(_tree.leaves(again), whole))
    shutil.rmtree(root, ignore_errors=True)
    check(same_plain and same_mesh, f"slice 13: checkpoint leaves differ "
          f"(unsharded {same_plain}, at the mesh {same_mesh})")
    out = {"leaves": len(whole), "unsharded_equal": same_plain,
           "mesh_equal": same_mesh}
    log("slice-13 checkpoint " + json.dumps(out))
    return out


def slice13_walk(torch, args, mesh):
    """The cost walker on one train step at full width and
    SLICE13_WALK_LAYERS layers, unsharded and on the (1, 1) mesh (each on
    its own copy of the weights, the same batch): the mesh walk must give
    the unsharded walk's flops by class and HBM bytes, with no collective
    byte and no unpriced op."""
    import dataclasses

    from repro_torch import sharding
    from repro_torch.data import make_lm_batches
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import hlo_cost
    from repro_torch.models import lm
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    cfg = dataclasses.replace(train_cfg(torch),
                              n_layers=SLICE13_WALK_LAYERS)
    batch = make_lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ,
                            seed=args.seed).batch_at(0)
    dp = sharding.dp_entry(mesh)
    costs = {}
    for name in ("unsharded", "mesh"):
        _free(torch)
        if name == "mesh":
            params = placed_params(torch, args.seed, cfg, mesh, "slice 13")
            dbatch = to_device(batch, "cuda", mesh=mesh,
                               specs={k: (dp, None) for k in batch})
        else:
            params = lm.init_params(args.seed, cfg)
            dbatch = to_device(batch, "cuda")
        state = init_state(params)
        step_fn = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR))
        step_fn(params, state, dbatch)                 # untimed
        with hlo_cost.CostMode(device="cuda") as mode:
            step_fn(params, state, dbatch)
        torch.cuda.synchronize()
        costs[name] = mode.cost
        del params, state, dbatch, step_fn
    a, b = costs["unsharded"], costs["mesh"]
    out = {"flops": [a.flops, b.flops], "hbm_bytes": [a.hbm_bytes,
                                                      b.hbm_bytes],
           "collective_bytes_by_kind": b.collective_kinds,
           "collectives": b.collective_count,
           "link_bytes": [a.collectives, b.collectives],
           "op_count_diff": {k: [a.op_counts.get(k, 0),
                                 b.op_counts.get(k, 0)]
                             for k in set(a.op_counts) | set(b.op_counts)
                             if a.op_counts.get(k, 0)
                             != b.op_counts.get(k, 0)},
           "host_ops": [a.host_ops, b.host_ops],
           "flops_by_class_equal": a.flops_by_class == b.flops_by_class,
           "unpriced": [a.unpriced, b.unpriced]}
    log("slice-13 walk (a full-width step at "
        f"{SLICE13_WALK_LAYERS} layers, unsharded and on the (1, 1) mesh) "
        + json.dumps(out))
    check(a.flops == b.flops and a.flops_by_class == b.flops_by_class
          and a.hbm_bytes == b.hbm_bytes
          and sum(b.collective_kinds.values()) == 0
          and not a.unpriced and not b.unpriced,
          f"slice 13: the walker prices the (1, 1) mesh step otherwise "
          f"than the unsharded one: {out}")
    return out


def slice13_path(torch, args, errs, t1_losses):
    """Phase 3, slice 13 (after slice 10, on a freed card): the
    production-mesh path on a (1, 1) mesh of one NCCL rank — full-width
    training through ``launch.train.main(mesh=)``, a private-embedding
    step through the DTensor path, a checkpoint across grids, the walker
    on a mesh step. Its grids across cards are ``--grids``' (
    :func:`grids_path`). Returns the private step's launches."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    mesh = slice13_mesh(torch)
    try:
        train = slice13_train(torch, args, mesh, t1_losses)
        launches = slice13_private(torch, args, mesh, errs)
        slice13_checkpoint(torch, args, mesh)
        walk = slice13_walk(torch, args, mesh)
    finally:
        dist.destroy_process_group()
    _free(torch)
    card = smi("name,power.limit")
    log("slice-13 summary " + json.dumps({
        "card": card, "ms_per_step": train["ms_per_step"],
        "peak_gb": train["peak_gb"], "idle_share": train["idle_share"],
        "loss_rel_diff": train["loss_rel_diff"],
        "walk_flops": walk["flops"][1],
        "seconds": time.perf_counter() - t0}))
    return launches


#: slice 14: the MoE family on the production mesh, training the full
#: Granite-3.0-3B-A800M configuration of the port's registry (32 layers,
#: d 1,536, 24 heads with 8 KV heads, 40 experts top-8 of expert d_ff
#: 512, V 49,155, bf16, remat, the einsum dispatch) on synthetic weights
#: from ``--seed`` and slice 10's batches (4 x 512 tokens) and AdamW
SLICE14_ARCH = "granite_moe_3b_a800m"
SLICE14_FIELDS = dict(n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
                      d_ff=512, vocab_size=49155, n_experts=40, top_k=8,
                      n_shared_experts=0, dtype="bfloat16", remat=True,
                      moe_dispatch="einsum")
#: steps of (a) and (b), and the capacity factor of (c)'s sort dispatch
SLICE14_STEPS, SLICE14_SORT_CAPACITY = 3, 1.25
SLICE14_KERNELS = ("share_onehot", "ss_matmul")


def slice14_cfg(torch):
    """The full Granite-3.0-3B-A800M configuration, checked against its
    published fields."""
    from repro_torch import configs
    cfg = configs.full(SLICE14_ARCH)
    bad = {k: getattr(cfg, k) for k, v in SLICE14_FIELDS.items()
           if getattr(cfg, k) != v}
    check(not bad, f"slice 14: {SLICE14_ARCH} is not the published "
          f"configuration: {bad}")
    return cfg


def slice14_argv(args, steps):
    return ["--arch", SLICE14_ARCH, "--steps", str(steps), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR),
            "--log-every", "1", "--seed", str(args.seed)]


def slice14_train(torch, args, label, mesh=None):
    """SLICE14_STEPS steps of ``launch.train.main`` (on ``mesh`` when it
    is given, DTensor parameters, moments and batches): finite losses and
    grad norms; ms a step (host clock between synchronizes, step 2), the
    idle share over a profiled step 1 and the peak memory."""
    from repro_torch.launch import train as train_launcher
    from torch.profiler import ProfilerActivity, profile

    marks, rec, prof, seen = [], [], {}, {}

    def on_step(step, params, opt_state, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        m = {k: float(v) for k, v in metrics.items()}
        rec.append(m)
        check(math.isfinite(m["loss"]) and m["grad_norm"] > 0,
              f"slice 14 {label} step {step}: {m}")
        if step == 0:
            w = params["blocks"]["moe"]["w_up"]
            seen["type"] = type(w).__name__
            seen["placements"] = [repr(p) for p in getattr(w, "placements",
                                                           ())]
            prof["p"] = profile(activities=[ProfilerActivity.CUDA])
            prof["p"].__enter__()
        if step == 1:
            prof["p"].__exit__(None, None, None)

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final = train_launcher.main(slice14_argv(args, SLICE14_STEPS),
                                mesh=mesh, on_step=on_step)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(len(rec) == SLICE14_STEPS and final == rec[-1]["loss"],
          f"slice 14 {label}: main did not run every step")
    check(seen["type"] == ("Tensor" if mesh is None else "DTensor"),
          f"slice 14 {label}: the expert weights were a {seen['type']}")
    kinds, launches = collections.Counter(), 0
    for e in prof["p"].key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us:
            launches += e.count
            kinds[train_kernel_kind(e.key)] += us / 1e3
    device_ms = sum(kinds.values())
    step_ms = 1e3 * (marks[1] - marks[0])             # step 1, profiled
    plain_ms = 1e3 * (marks[2] - marks[1])            # step 2
    out = {"losses": [r["loss"] for r in rec],
           "grad_norms": [r["grad_norm"] for r in rec],
           "placements_w_up": seen["placements"], "ms_per_step": plain_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (plain_ms / 1e3),
           "profiled_step_ms": step_ms, "profiled_step_device_ms": device_ms,
           "idle_share": 1.0 - device_ms / step_ms,
           "profiled_step_kernels": launches,
           "device_ms_by_kind": dict(kinds), "peak_gb": peak,
           "first_step_and_init_s": marks[0] - t0}
    log(f"slice-14 {label} (launch.train.main) " + json.dumps(out))
    _free(torch)
    return out


def sort_step(torch, args, cfg, mesh=None):
    """One step of ``make_train_step`` with the sort dispatch at capacity
    SLICE14_SORT_CAPACITY, on fresh weights from ``--seed`` and t1's first
    batch, unsharded or on ``mesh`` -> its loss, grad norm and seconds,
    and the (token, expert) pairs of this rank's tokens that the first
    forward drops past an expert's capacity: an expert's pairs are ranked
    in token order over the whole batch (on a mesh after the pairs of the
    rows before this rank's block, ``_pairs_before``), and those ranked
    at the capacity or past it drop. Every model rank of a data row
    counts the same pairs, so a grid's drops are the sum over its ranks
    at model coordinate 0."""
    import dataclasses

    from repro_torch import sharding
    from repro_torch.data import make_lm_batches
    from repro_torch.data.pipeline import to_device
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    scfg = dataclasses.replace(cfg, moe_dispatch="sort",
                               capacity_factor=SLICE14_SORT_CAPACITY)
    batch = make_lm_batches(scfg, TRAIN_BATCH, TRAIN_SEQ,
                            seed=args.seed).batch_at(0)
    drops, inner = [], L._moe_sort_dispatch

    def spy(p, c, x2, weights, idx, first=0, n_total=None, before=None):
        if len(drops) < c.n_layers:           # the first forward's layers
            cap = math.ceil((x2.shape[0] if n_total is None else n_total)
                            * c.top_k / c.n_experts * c.capacity_factor)
            se = torch.sort(idx.reshape(-1), stable=True).values
            pos = torch.arange(se.numel(), device=se.device) \
                - torch.searchsorted(se, se, side="left")
            if before is not None:
                pos = pos + before[se]
            drops.append(int((pos >= cap).sum()))
        return inner(p, c, x2, weights, idx, first, n_total, before)

    _free(torch)
    if mesh is not None:
        params = placed_params(torch, args.seed, scfg, mesh, "sort step")
        dp = sharding.dp_entry(mesh)
        dbatch = to_device(batch, sharding.mesh_device(mesh), mesh=mesh,
                           specs={k: (dp, None) for k in batch})
    else:
        params = lm.init_params(args.seed, scfg)
        dbatch = to_device(batch, "cuda")
    state = init_state(params)
    step_fn = make_train_step(scfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                                                total_steps=2))
    L._moe_sort_dispatch = spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step_fn(params, state, dbatch)
        torch.cuda.synchronize()
    finally:
        L._moe_sort_dispatch = inner
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "step_s": time.perf_counter() - t0, "dropped_pairs": sum(drops),
           "coordinate": None if mesh is None else mesh.get_coordinate()}
    del params, state, dbatch, step_fn, m
    _free(torch)
    return out


def slice14_sort_step(torch, args, cfg, mesh):
    """(c): :func:`sort_step` unsharded and on ``mesh``: the losses within
    SLICE13_STEP0_RTOL relative; logs the pairs the unsharded step's
    first forward drops."""
    out = {"unsharded": sort_step(torch, args, cfg),
           "mesh": sort_step(torch, args, cfg, mesh)}
    a, b = out["unsharded"]["loss"], out["mesh"]["loss"]
    out["loss_rel_diff"] = abs(a - b) / abs(a)
    out["dropped_pairs_first_forward"] = out["unsharded"]["dropped_pairs"]
    out["pairs_first_forward"] = (cfg.n_layers * TRAIN_BATCH * TRAIN_SEQ
                                  * cfg.top_k)
    log("slice-14 (c) sort dispatch at capacity "
        f"{SLICE14_SORT_CAPACITY} " + json.dumps(out))
    check(math.isfinite(a) and out["loss_rel_diff"] <= SLICE13_STEP0_RTOL,
          f"slice 14 (c): the sort dispatch's loss {b} on the mesh, {a} "
          f"unsharded (rtol {SLICE13_STEP0_RTOL})")
    return out


def slice14_path(torch, args, errs):
    """Phase 3, slice 14 (last, after slice 13, on a freed card): the MoE
    family on the production mesh at the full Granite-3.0-3B-A800M
    configuration — (a) SLICE14_STEPS steps through ``launch.train.main``
    unsharded, (b) the same on a (1, 1) NCCL mesh, its losses against
    (a)'s, (c) one sort-dispatch step unsharded and on the mesh, (d) one
    private-embedding step on the mesh (slice 13's check at this
    configuration). Its grids across cards are ``--grids``' (
    :func:`grids_path`). Returns (d)'s launches."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    cfg = slice14_cfg(torch)
    a = slice14_train(torch, args, "(a) unsharded")
    mesh = slice13_mesh(torch)
    try:
        b = slice14_train(torch, args, "(b) on the (1, 1) mesh", mesh=mesh)
        diffs = [abs(x - y) / abs(y) for x, y in zip(b["losses"],
                                                     a["losses"])]
        for i, d in enumerate(diffs):
            tol = SLICE13_STEP0_RTOL if i == 0 else SLICE13_LOSS_RTOL
            check(d <= tol, f"slice 14 (b) step {i}: loss {b['losses'][i]} "
                  f"on the mesh, {a['losses'][i]} unsharded (rtol {tol})")
        c = slice14_sort_step(torch, args, cfg, mesh)
        launches = slice13_private(torch, args, mesh, errs, cfg=cfg,
                                   tag="slice 14")
    finally:
        dist.destroy_process_group()
    _free(torch)
    log("slice-14 summary " + json.dumps({
        "card": smi("name,power.limit"),
        "ms_per_step": {"a": a["ms_per_step"], "b": b["ms_per_step"]},
        "peak_gb": {"a": a["peak_gb"], "b": b["peak_gb"]},
        "idle_share": {"a": a["idle_share"], "b": b["idle_share"]},
        "max_loss_rel_diff": max(diffs + [c["loss_rel_diff"]]),
        "sort_dropped_pairs": c["dropped_pairs_first_forward"],
        "launches": {k: launches[k] for k in SLICE14_KERNELS},
        "seconds": time.perf_counter() - t0}))
    return launches


#: slice 15: serving on the production mesh at the full ChatGLM3-6B
#: configuration of the port's registry (28 layers, d 4,096, 32 query
#: heads with 2 KV heads, d_ff 13,696, V 65,024, partial RoPE on half of
#: each head, QKV bias, bf16; 6.24 B synthetic parameters from --seed),
#: SLICE8_BATCH requests of SLICE15_PROMPT tokens and SLICE8_NEW new ones.
#: 4 x 128 prompt rows are not tall-skinny, so the private prefill runs
#: the general ``ss_matmul`` and the decode steps the tall one
SLICE15_ARCH, SLICE15_PROMPT = "chatglm3_6b", 128
SLICE15_FIELDS = dict(n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
                      d_ff=13696, vocab_size=65024, rope_fraction=0.5,
                      qkv_bias=True, family="dense")
#: Gemma3-1B in full (26 layers, d 1,152, 4 query heads with 1 KV head of
#: 256 dims, a 512-token window on 5 of every 6 layers, d_ff 6,912,
#: V 262,144, QK-norm, GeGLU, tied embeddings), 4 x 64 prompt tokens
SLICE15_GEMMA, SLICE15_GEMMA_PROMPT = "gemma3_1b", 64
SLICE15_GEMMA_FIELDS = dict(n_layers=26, d_model=1152, n_heads=4,
                            n_kv_heads=1, head_dim=256, d_ff=6912,
                            vocab_size=262144, sliding_window=512,
                            global_every=6, qk_norm=True,
                            tie_embeddings=True, act="geglu")
#: (b)'s first two steps' logits against the unsharded run's: on the
#: (1, 1) mesh no dim splits over more than one rank, so every layer runs
#: the unsharded ops on whole local tensors and an all-reduce over one
#: rank is a copy: bit for bit
SLICE15_LOGIT_ATOL = 0.0
#: a grid's near-tie (``--grids``): a gap between a request's two largest unsharded
#: logits that another order of bf16 sums may close. (a) logs bf16's
#: noise floor for ChatGLM3-6B, the same forward's logits at two lengths,
#: at 0.078; this is 1.6 times that
SLICE15_TIE_ATOL = 0.125


def slice15_generate(torch, params, cfg, prompts, mesh, n_new):
    """Greedy generation of ``n_new`` tokens after ``prompts`` (B, T)
    through ``lm.prefill`` and ``lm.decode_step`` on ``mesh``: DTensor
    parameters, batches and cache (``lm.prefill`` places it by
    ``sharding.cache_spec``). Returns the tokens (B, n_new), the first
    two steps' whole logits, the cache's placements, prefill ms and ms a
    decode step (host clock between synchronizes)."""
    from repro_torch import sharding
    from repro_torch.data.pipeline import to_device
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig

    spec = (sharding.dp_entry(mesh), None)
    pls = sharding.placements(spec, mesh)
    t = prompts.shape[1]
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(params, cfg, to_device(
            {"tokens": prompts.astype(np.int32)}, "cuda", mesh=mesh,
            specs={"tokens": spec}), max_len=t + n_new)
        first = [logits.full_tensor()]
        gen = [torch.argmax(first[0][:, -1], dim=-1)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(n_new - 1):            # tokens stay on the card
            tok = sharding.place(gen[-1][:, None].to(torch.int32), mesh, pls)
            logits, cache = lm.decode_step(params, cfg, cache, t + i,
                                           {"tokens": tok})
            whole = logits.full_tensor()
            if i == 0:
                first.append(whole)
            gen.append(torch.argmax(whole[:, -1], dim=-1))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    kv = cache["kv"][0]
    out = {"tokens": torch.stack(gen, 1).cpu().numpy().astype(np.int32),
           "logits": first, "cache_type": type(kv).__name__,
           "cache_placements": [repr(p) for p in kv.placements],
           "cache_local_shape": list(kv.to_local().shape),
           "wq_placements": [repr(p) for p in
                             params["blocks"]["attn"]["wq"].placements],
           "prefill_ms": 1e3 * (t1 - t0),
           "decode_ms_per_step": 1e3 * (t2 - t1) / (n_new - 1)}
    want = sharding.placements(sharding.cache_spec(cfg, mesh, ShapeConfig(
        "cache", t + n_new, prompts.shape[0], "decode"))["kv"][0], mesh)
    out["cache_placed_by_spec"] = list(kv.placements) == list(want)
    del cache, logits
    return out


def slice15_unsharded(torch, keep):
    """Route (c)'s greedy generation again, unsharded, through
    ``lm.prefill`` and ``lm.decode_step``: its tokens (route (a)'s, when
    ``keep`` holds them), the first two steps' logits, and each step's gap
    between the two largest logits of each request (where a grid's other
    order of sums may pick the other token)."""
    from repro_torch.models import lm
    plain, cfg, prompts = keep["plain"], keep["cfg"], keep["prompts"]
    dev = plain["final_norm"].device
    t = prompts.shape[1]
    first, gen, gaps = [], [], []
    with torch.no_grad():
        logits, cache = lm.prefill(plain, cfg, {"tokens": torch.as_tensor(
            prompts, dtype=torch.int64, device=dev)},
            max_len=t + SLICE8_NEW)
        for i in range(SLICE8_NEW):
            if i:
                logits, cache = lm.decode_step(plain, cfg, cache, t + i - 1,
                                               {"tokens": gen[-1]})
            if i < 2:
                first.append(logits)
            top = torch.topk(logits[:, -1], 2, dim=-1).values
            gaps.append(top[:, 0] - top[:, 1])
            gen.append(torch.argmax(logits[:, -1], dim=-1, keepdim=True))
    del cache
    out = {"logits": first,
           "tokens": torch.cat(gen, 1).cpu().numpy().astype(np.int32),
           "gaps": torch.stack(gaps, 1).cpu().numpy()}
    check("tokens" not in keep or np.array_equal(out["tokens"],
                                                 keep["tokens"]),
          "slice 15: the unsharded greedy loop's tokens differ from route "
          "(a)'s")
    return out


def slice15_mesh(torch, keep, want, mesh):
    """(b): route (c)'s parameters as DTensors on the (1, 1) NCCL mesh,
    the same prompts through ``lm.prefill`` and ``lm.decode_step`` with a
    DTensor cache placed by ``sharding.cache_spec``: the greedy tokens must
    equal route (a)'s and the first two steps' logits the unsharded
    run's within SLICE15_LOGIT_ATOL. Frees route (c)'s parameters."""
    from repro_torch import sharding

    cfg = keep["cfg"]
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    params = sharding.distribute(keep["plain"], mesh, sharding.
                                 param_shardings(cfg, mesh, keep["plain"]))
    del keep["plain"]
    _free(torch)
    res = slice15_generate(torch, params, cfg, keep["prompts"], mesh,
                           SLICE8_NEW)
    peak = torch.cuda.max_memory_allocated() / 1e9
    diffs = [float((g - w).abs().max()) for g, w in zip(res.pop("logits"),
                                                        want["logits"])]
    tokens = res.pop("tokens")
    del params
    _free(torch)
    out = dict(res, logits_max_abs_diff=diffs, peak_gb=peak,
               tokens_equal=bool(np.array_equal(tokens, keep["tokens"])))
    log("slice-15 (b) on the (1, 1) mesh " + json.dumps(out))
    check(out["cache_type"] == "DTensor" and out["cache_placed_by_spec"],
          f"slice 15 (b): the cache was not placed by cache_spec: {out}")
    check(out["tokens_equal"], "slice 15 (b): the mesh's greedy tokens "
          "differ from the unsharded route (a)'s")
    check(all(d <= SLICE15_LOGIT_ATOL for d in diffs),
          f"slice 15 (b): the first two steps' logits differ from the "
          f"unsharded run's by {diffs} (atol {SLICE15_LOGIT_ATOL})")
    return out


def slice15_path(torch, args, errs):
    """Phase 3, slice 15 (last, after slice 14, on a freed card): serving
    on the production mesh. (a) ChatGLM3-6B's private and plaintext
    generation unsharded (:func:`family_path`: tokens equal, its
    ``share_onehot`` and tall and general ``ss_matmul`` launches held
    against their plain versions); (b) the same prompts on a (1, 1) NCCL
    mesh (:func:`slice15_mesh`); then Gemma3-1B's private and plaintext
    generation unsharded. Its grids across cards are ``--grids``' (
    :func:`grids_path`). Returns the launches of (a)'s and Gemma3's
    route windows."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    keep, launches = {}, collections.Counter()
    got, chat = family_path(torch, args, 0, SLICE15_ARCH, None,
                            SLICE15_PROMPT, SLICE15_FIELDS, slice_no=15,
                            keep=keep)
    launches.update(got)
    check(got["ss_matmul"] > 0 and got["ss_matmul_tall"] > 0,
          f"slice 15 (a) launched {got}: the general and the tall "
          "ss_matmul wanted")
    want = slice15_unsharded(torch, keep)
    mesh = slice13_mesh(torch)
    try:
        b = slice15_mesh(torch, keep, want, mesh)
    finally:
        dist.destroy_process_group()
    keep.clear()
    del want
    _free(torch)
    got, gemma = family_path(torch, args, 1, SLICE15_GEMMA, None,
                             SLICE15_GEMMA_PROMPT, SLICE15_GEMMA_FIELDS,
                             slice_no=15)
    launches.update(got)
    for name in SLICE8_KERNELS + ("ss_matmul",):
        check(launches[name] > 0, f"slice 15 launched no {name}")
    log("slice-15 summary " + json.dumps({
        "card": smi("name,power.limit"),
        "chatglm3_6b": {k: chat[k] for k in (
            "prefill_ms", "decode_ms_per_step", "tokens_per_s",
            "idle_share", "peak_gb")},
        "mesh_1x1": {k: b[k] for k in ("prefill_ms", "decode_ms_per_step",
                                       "peak_gb", "logits_max_abs_diff")},
        "gemma3_1b": {k: gemma[k] for k in ("prefill_ms",
                                            "decode_ms_per_step",
                                            "peak_gb")},
        "launches": {k: launches[k] for k in SLICE8_KERNELS
                     + ("ss_matmul",)},
        "seconds": time.perf_counter() - t0}))
    return dict(launches)


# ---------------------------------------------------------------------------
# --grids: the production mesh across the cards of one host
# ---------------------------------------------------------------------------

#: --grids spawns one world of ranks for each size in GRID_WORLDS that the
#: host's cards allow, one rank a card, as ``torchrun --nproc-per-node=N``
#: does, and lays each grid of that size over the whole world with the
#: port's ``make_mesh`` (rank r at (r // n_model, r % n_model))
GRID_WORLDS = (1, 2, 4)
GRID_AXES = ("data", "model")
#: a world's ranks must end, their process group torn down, within this
#: many seconds of their start, by world size (the world of four serves
#: every family of FAMILY_SERVE on two grids and checkpoints the full
#: Qwen1.5-4B)
WORLD_DEADLINE_S = {1: 300, 2: 300, 4: 1500}
#: the grids of each phase. Qwen1.5-4B trains at t1's shapes, and its
#: private-embedding step runs on each grid; Granite-3.0-3B-A800M's 40
#: experts split 20 a rank at (1, 2), 10 at (1, 4) and (2, 2), and stay
#: whole at (2, 1), where only the tokens split
QWEN_GRIDS = ((1, 1), (1, 2), (2, 1), (2, 2))
GRANITE_GRIDS = ((1, 1), (1, 2), (2, 1), (1, 4), (2, 2))
#: the grid of each family whose step 1 is profiled for its NCCL kernels
#: and walked by the cost walker
PROFILED_GRID = {"qwen": (2, 2), "granite": (1, 4)}
#: the collectives timed alone (:func:`grid_links`) on LINK_GRID's
#: groups, LINK_BYTES of output a call
LINK_GRID, LINK_BYTES = (2, 2), 1 << 28
#: checkpoints: saved at CKPT_GRID, restored at CKPT_RESTORE_GRID (and
#: unsharded on one card); a run killed after a save at CKPT_GRID
#: restarts at CKPT_RESTORE_GRID
CKPT_GRID, CKPT_RESTORE_GRID = (2, 2), (1, 4)
#: seconds the killed run's step-1 checkpoint may take to be written
#: (39.5 GB at the full Qwen1.5-4B configuration: bf16 parameters and
#: float32 moments); the restarted run checkpoints every CKPT_NEVER
#: steps, so only at its end
CKPT_WAIT_S, CKPT_NEVER = 300, 1000
#: the free disk the checkpoint unit needs before it starts: the killed
#: run's step-1 checkpoint and the restarted run's last one, 39.5 GB
#: each, with room to spare
CKPT_MIN_FREE_GB = 85
#: the sort dispatch held exactly across grids: Granite's full width in
#: float32 on SORT_EXACT_LAYERS of its 32 layers against the unsharded
#: step (which runs on one card: float32 weights, gradients and moments of
#: all 32 layers with their activations would need about 85 GB). In bf16 a
#: grid's partial sums round otherwise than one card's and the router then
#: picks other experts at near-ties: the full bf16 step is held to
#: SLICE13_LOSS_RTOL and its dropped pairs logged (at the smoke
#: configuration on 4 gloo ranks, bf16 dropped 9 pairs to one card's 10,
#: float32 the same 9 at an equal loss). The grids of SORT_FULL_GRIDS run
#: all SORT_FULL_LAYERS in float32, held to SORT_BRIDGE_GRID, which splits
#: only the batch (every expert whole on each rank, a quarter of the
#: activations) and is itself held to the unsharded step at
#: SORT_EXACT_LAYERS
SORT_EXACT_LAYERS, SORT_FULL_LAYERS = 16, 32
SORT_FULL_GRIDS, SORT_BRIDGE_GRID = ((1, 4), (2, 2)), (4, 1)
#: MeshDispatcher (slice 11 (b)) over this many distinct cards at n_model
#: 2: a 1 x 2 and a 2 x 2 grid
DISPATCH_CARDS = (2, 4)
#: the grids' device type (a CPU rehearsal of the ranks sets "cpu")
MESH_DEVICE = "cuda"


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def rank_main(rank, world, port, device_type, fn, fn_args):
    """A spawned rank, started as ``torchrun --nproc-per-node=world``
    starts one: its environment variables (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), then the port's
    entry ``launch.mesh.init_ranks`` (NCCL, ``cuda:LOCAL_RANK`` made
    current and bound to the group; gloo for ``device_type`` "cpu"),
    then ``fn(torch, *fn_args)``, a world barrier and the process group
    torn down. An error ends the rank, and ``spawn_ranks`` the others."""
    global LOG_PREFIX
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks
    LOG_PREFIX = f"[rank {rank}/{world}] "
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    if device_type == "cuda":
        dev = init_ranks()
        check(dev == torch.device("cuda", rank)
              and torch.cuda.current_device() == rank,
              f"rank {rank}: init_ranks gave {dev}")
    else:
        init_ranks(device=device_type)
    fn(torch, *fn_args)
    dist.barrier()
    dist.destroy_process_group()


def spawn_ranks(world, fn, *fn_args, deadline_s=None):
    """``world`` ranks on a free localhost port, each :func:`rank_main`
    on MESH_DEVICE. Raises if a rank fails (the others are ended) or if
    the ranks have not all ended within ``deadline_s`` (all are then
    killed), so no rank outlives the call."""
    import torch.multiprocessing as mp
    if deadline_s is None:
        deadline_s = WORLD_DEADLINE_S[world]
    ctx = mp.start_processes(rank_main, args=(world, free_port(),
                                              MESH_DEVICE, fn, fn_args),
                             nprocs=world, join=False, start_method="spawn")
    end = time.perf_counter() + deadline_s
    while not ctx.join(timeout=1):
        if time.perf_counter() > end:
            for proc in ctx.processes:
                proc.kill()
                proc.join()
            raise TimeoutError(f"{world} ranks did not end within "
                               f"{deadline_s} s")


def grid_phases():
    """(phase, grid, the cards it needs, the entry that runs it) of every
    multi-card phase: ``--grids``' and ``--grids-train``'s."""
    out = [("qwen1.5-4b training", s, math.prod(s)) for s in QWEN_GRIDS]
    out += [("granite-3.0-3b-a800m training", s, math.prod(s))
            for s in GRANITE_GRIDS]
    out += [("checkpoint", f"{CKPT_GRID} -> {CKPT_RESTORE_GRID}", 4)]
    out += [(f"{arch} serving, batch {b}", s, math.prod(s))
            for arch, *_ in FAMILY_SERVE for s, b in FAMILY_GRIDS]
    out += [(f"granite-3.0-3b-a800m float32 sort step, {SORT_FULL_LAYERS} "
             "layers", s, math.prod(s))
            for s in (SORT_BRIDGE_GRID,) + SORT_FULL_GRIDS]
    out += [(f"collectives against the walker, {k}", s, math.prod(s))
            for k, s in PROFILED_GRID.items()]
    out += [("MeshDispatcher slice 11 (b)", f"{k} cards", k)
            for k in DISPATCH_CARDS]
    out = [p + ("--grids",) for p in out]
    out += [(name, s, math.prod(s), "--grids-train")
            for name, s in train4_phases()]
    return [p for p in out if p[2] > 1]


def log_grids_not_run(cards: int, entry: str = "default") -> None:
    """One line for each multi-card phase that does not run: in the
    default run all of them but slice 11 (b) over every card of the host,
    which slice 11 runs; under ``--grids`` or ``--grids-train`` the other
    entry's and this entry's that need more cards than the host has."""
    for phase, grid, need, runs_it in grid_phases():
        if entry == "default" and phase.startswith("MeshDispatcher") \
                and need == cards:
            continue
        if entry == "default":
            log(f"grids {phase} {grid}: not run, the default run takes one "
                f"card; `chip_smoke.py {runs_it}` runs it on {need} cards")
        elif runs_it != entry:
            log(f"grids {phase} {grid}: not run here; `chip_smoke.py "
                f"{runs_it}` runs it on {need} cards")
        elif need > cards:
            log(f"grids {phase} {grid}: not run, needs {need} cards, this "
                f"host has {cards}")


#: :func:`grid_mesh`'s meshes, by shape
MESHES = {}


def grid_mesh(torch, shape):
    """The port's ``make_mesh(shape)`` over the whole world, made once a
    shape. Every rank calls it (a new group is a collective of the
    world)."""
    from repro_torch.launch.mesh import make_mesh
    if shape not in MESHES:
        MESHES[shape] = make_mesh(shape, GRID_AXES, device_type=MESH_DEVICE)
    return MESHES[shape]


def nccl_kind(name: str):
    """An NCCL kernel's collective (``hlo_analysis.COLLECTIVES``' names)
    by its name, None for another kernel."""
    low = name.lower().replace("_", "")
    if "nccl" not in low:
        return None
    for key, kind in (("allreduce", "all-reduce"), ("allgather", "all-gather"),
                      ("reducescatter", "reduce-scatter"),
                      ("alltoall", "all-to-all"),
                      ("sendrecv", "collective-permute"),
                      ("broadcast", "collective-permute")):
        if key in low:
            return kind
    return "other"


def mesh_train(torch, argv, mesh, run=None):
    """``launch.train.main(argv, mesh=)`` (or ``run(on_step)``, a loop of
    its own that calls ``on_step(step, params, opt_state, metrics)`` after
    each step) -> its losses, grad norms and lrs, ms a step (host clock
    between synchronizes, step 2), over a profiled step 1 the device ms by
    kernel kind, NCCL's kernels' ms by collective and the idle share, the
    ``w_up`` placements, whether this rank's block of layer 0's first
    matrix (:func:`layer_probe`) moved from step 0 to the last, and this
    rank's peak."""
    from repro_torch import _tree
    from repro_torch.launch import train as train_launcher
    from torch.profiler import ProfilerActivity, profile

    marks, rec, prof, seen, probe = [], [], {}, {}, {}

    def on_step(step, params, opt_state, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        rec.append({k: float(v) for k, v in metrics.items()})
        _, w = layer_probe(params)
        probe.setdefault("first", w.clone())
        probe["moved"] = not torch.equal(w, probe["first"])
        if step == 0:
            seen.update({p: [repr(x) for x in t.placements] for p, t in
                         _tree.leaves_with_paths(params)
                         if p.endswith("w_up") and hasattr(t, "placements")})
            prof["p"] = profile(activities=[ProfilerActivity.CUDA])
            prof["p"].__enter__()
        if step == 1:
            prof["p"].__exit__(None, None, None)

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if run is None:
        train_launcher.main(argv, mesh=mesh, on_step=on_step)
    else:
        run(on_step)
    kinds, nccl = collections.Counter(), collections.Counter()
    for e in prof["p"].key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us:
            kinds[train_kernel_kind(e.key)] += us / 1e3
            if nccl_kind(e.key):
                nccl[nccl_kind(e.key)] += us / 1e3
    step_ms = 1e3 * (marks[1] - marks[0])
    out = {"losses": [r["loss"] for r in rec],
           "grad_norms": [r["grad_norm"] for r in rec],
           "lrs": [r["lr"] for r in rec],
           "layer0_moved": probe.get("moved", False),
           "ms_per_step": 1e3 * (marks[2] - marks[1]),
           "profiled_step_ms": step_ms,
           "device_ms_by_kind": dict(kinds), "nccl_ms_by_kind": dict(nccl),
           "idle_share": 1.0 - sum(kinds.values()) / step_ms,
           "placements_w_up": seen,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "first_step_and_init_s": marks[0] - t0}
    _free(torch)
    return out


def grid_walk(torch, args, cfg, mesh, steps):
    """The cost walker (``hlo_cost.CostMode``) on step 1 of ``steps`` of
    ``cfg`` on ``mesh`` as ``launch.train.main(mesh=)`` takes it (fresh
    weights from ``--seed``, step 0 run first, unwalked) -> this rank's
    collective output bytes by kind (``hlo_analysis.collective_bytes``),
    link bytes, and ``t_collective`` (each collective's bus bytes for its
    kind and group size at the kind's bus rate), also by kind."""
    from repro_torch import sharding
    from repro_torch.data import make_lm_batches
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import hlo_analysis, hlo_cost
    from repro_torch.models import lm
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    _free(torch)
    params = lm.init_params(args.seed, cfg, mesh=mesh)
    state = init_state(params)
    step_fn = make_train_step(cfg, AdamWConfig(
        lr=TRAIN_LR, warmup_steps=max(2, steps // 10), total_steps=steps))
    stream = make_lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=args.seed)
    dp = sharding.dp_entry(mesh)

    def batch(i):
        b = stream.batch_at(i)
        return to_device(b, sharding.mesh_device(mesh), mesh=mesh,
                         specs={k: (dp, None) for k in b})

    params, state, _ = step_fn(params, state, batch(0))
    t0 = time.perf_counter()
    with hlo_cost.CostMode(device=MESH_DEVICE) as mode:
        step_fn(params, state, batch(1))
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    cost = mode.cost
    kinds = hlo_analysis.collective_bytes(cost)
    roof = cost.roofline(n_chips=mesh.size())
    del params, state
    _free(torch)
    return {"collective_bytes": kinds, "link_bytes": dict(cost.collectives),
            "t_collective_ms": 1e3 * roof.t_collective,
            "predicted_ms_by_kind": {
                k: 1e3 * v for k, v in hlo_analysis.seconds_by_kind(
                    cost.collective_groups).items()},
            "t_compute_ms": 1e3 * roof.t_compute,
            "t_memory_ms": 1e3 * roof.t_memory,
            "unpriced": dict(cost.unpriced), "walk_s": walk_s}


def grid_qwen(torch, args, mesh, keep):
    """Qwen1.5-4B on a grid: SLICE13_STEPS steps of ``launch.train.main``
    at t1's shapes (:func:`mesh_train`), walked at PROFILED_GRID, then one
    private-embedding step (:func:`slice13_private`: one ``share_onehot``
    and one ``ss_matmul`` on this rank's card, each equal to its plain
    version, the opened rows the unsharded lookup's)."""
    shape = tuple(mesh.shape)
    out = mesh_train(torch, slice13_argv(args, SLICE13_STEPS), mesh)
    keep[f"qwen {shape} losses"] = out["losses"]
    if shape == PROFILED_GRID["qwen"]:
        out["walk"] = grid_walk(torch, args, train_cfg(torch), mesh,
                                SLICE13_STEPS)
    errs = collections.Counter()
    out["private_launches"] = slice13_private(
        torch, args, mesh, errs, tag=f"grids qwen {shape}")
    out["private_errs"] = dict(errs)
    return out


def sort_steps(torch, args, mesh=None, exact=None, bf16=True):
    """:func:`sort_step` of the full Granite-3.0-3B-A800M configuration
    (``bf16``, unless ``bf16`` is False) and of its full width in float32
    on each number of layers of ``exact`` (``float32 <layers>``; default
    SORT_EXACT_LAYERS), unsharded or on ``mesh``."""
    import dataclasses
    cfg = slice14_cfg(torch)
    out = {"bf16": sort_step(torch, args, cfg, mesh)} if bf16 else {}
    for n in exact or (SORT_EXACT_LAYERS,):
        out[f"float32 {n}"] = sort_step(torch, args, dataclasses.replace(
            cfg, dtype="float32", n_layers=n), mesh)
    return out


def grid_granite(torch, args, mesh, keep):
    """Granite-3.0-3B-A800M on a grid: SLICE14_STEPS einsum-dispatch steps
    of ``launch.train.main`` (:func:`mesh_train`), walked at PROFILED_GRID,
    then the sort dispatch's steps (:func:`sort_steps`)."""
    shape = tuple(mesh.shape)
    out = mesh_train(torch, slice14_argv(args, SLICE14_STEPS), mesh)
    if shape == PROFILED_GRID["granite"]:
        out["walk"] = grid_walk(torch, args, slice14_cfg(torch), mesh,
                                SLICE14_STEPS)
    out["sort"] = sort_steps(torch, args, mesh, exact=(
        SORT_FULL_LAYERS if shape in SORT_FULL_GRIDS else SORT_EXACT_LAYERS,))
    return out


def grid_sort_bridge(torch, args, mesh, keep):
    """SORT_BRIDGE_GRID: the float32 sort step at SORT_EXACT_LAYERS (held
    to the unsharded step) and at SORT_FULL_LAYERS (the grids of
    SORT_FULL_GRIDS are held to it)."""
    return {"sort": sort_steps(torch, args, mesh, bf16=False, exact=(
        SORT_EXACT_LAYERS, SORT_FULL_LAYERS))}


def grid_sort_unsharded(torch, args, mesh, keep):
    """Rank 0: :func:`sort_steps` unsharded, the grids' reference."""
    return sort_steps(torch, args)


def grid_checkpoint(torch, args, mesh, keep):
    """Checkpoints across cards at the full Qwen1.5-4B configuration
    (slice 10's, t1's shapes). A ``launch.train.main`` run at CKPT_GRID
    writing a checkpoint every step is killed after step 1, its step-1
    checkpoint written: the parameters and AdamW moments after step 0,
    which rank 0 also gathers to its host leaf by leaf as the run held
    them. The checkpoint restores at CKPT_RESTORE_GRID and, on rank 0,
    unsharded on its card, every leaf bit for bit; the run restarted at
    CKPT_RESTORE_GRID from it gives the uninterrupted run's losses of
    steps 1 and 2 (:func:`grid_qwen`'s at CKPT_GRID) within
    SLICE13_LOSS_RTOL. Logs the checkpoint's bytes and its disk's use
    (``shutil.disk_usage``) before, at the checkpoint and at the end."""
    import shutil

    import torch.distributed as dist

    from repro_torch import _tree, sharding
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.launch import train as train_launcher
    from repro_torch.train.optim import AdamWState

    rank = dist.get_rank()
    root = os.path.join(ROOT, "build", "grids_ckpt")
    run = os.path.join(root, "run")
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
    dist.barrier()

    def disk():
        u = shutil.disk_usage(root)
        return {"total_gb": u.total / 1e9, "used_gb": u.used / 1e9,
                "free_gb": u.free / 1e9}

    out = {"disk_before": disk()}
    check(out["disk_before"]["free_gb"] >= CKPT_MIN_FREE_GB,
          f"grids checkpoint: {out['disk_before']} free, "
          f"{CKPT_MIN_FREE_GB} GB wanted for two checkpoints")
    held, tree = [], {}

    class Crash(Exception):
        pass

    def argv(every):
        return slice13_argv(args, SLICE13_STEPS) + [
            "--ckpt-dir", run, "--ckpt-every", str(every)]

    def die(step, params, opt_state, metrics):
        if step == 0:             # what the step-1 checkpoint holds
            tree["t"] = (params, opt_state)
            for leaf in _tree.leaves(tree["t"]):
                whole = (leaf.full_tensor() if hasattr(leaf, "full_tensor")
                         else leaf)
                if rank == 0:
                    held.append(whole.to("cpu", copy=True))
                del whole
        if step == 1:
            raise Crash

    t0 = time.perf_counter()
    try:
        train_launcher.main(argv(1), mesh=mesh, on_step=die)
        check(False, "grids checkpoint: the crash did not happen")
    except Crash:
        pass
    if rank == 0:    # the step-1 writer thread outlives the crash
        deadline = time.perf_counter() + CKPT_WAIT_S
        while latest_step(run) != 1 and time.perf_counter() < deadline:
            time.sleep(0.05)
        step_dir = os.path.join(run, "step_1")
        out["checkpoint_gb"] = sum(
            os.path.getsize(os.path.join(step_dir, f))
            for f in os.listdir(step_dir)) / 1e9 if os.path.isdir(
                step_dir) else 0.0
        out["leaves"] = len(held)
        out["held_gb"] = sum(h.numel() * h.element_size()
                             for h in held) / 1e9
    dist.barrier()
    out.update(disk_at_checkpoint=disk(),
               killed_run_s=time.perf_counter() - t0)
    template = tree.pop("t")
    _free(torch)
    other = grid_mesh(torch, CKPT_RESTORE_GRID)
    cfg = train_cfg(torch)
    p_sh = sharding.param_shardings(cfg, other, template[0])
    o_sh = AdamWState(step=sharding.NamedSharding(other, sharding.REP),
                      m=p_sh, v=p_sh)
    t1 = time.perf_counter()
    _, again = restore_checkpoint(run, template, step=1,
                                  shardings=(p_sh, o_sh))
    out["restore_at_grid_s"] = time.perf_counter() - t1
    at_other = []
    for i, leaf in enumerate(_tree.leaves(again)):
        ok = (type(leaf).__name__ != "DTensor"
              or leaf.device_mesh is other)
        whole = leaf.full_tensor() if hasattr(leaf, "full_tensor") else leaf
        if rank == 0:
            ok = ok and torch.equal(whole.cpu(), held[i])
        at_other.append(ok)
        del whole
    del again
    _free(torch)
    out["restored_at_grid_equal"] = all(at_other)
    if rank == 0:
        t1 = time.perf_counter()
        _, back = restore_checkpoint(run, template, step=1,
                                     device=sharding.mesh_device(mesh))
        out["restore_unsharded_s"] = time.perf_counter() - t1
        out["restored_unsharded_equal"] = all(
            torch.equal(a.cpu(), h)
            for a, h in zip(_tree.leaves(back), held))
        out["restored_unsharded_leaves"] = len(_tree.leaves(back))
        del back
    del template, held
    _free(torch)
    dist.barrier()
    resumed = []
    t1 = time.perf_counter()
    train_launcher.main(argv(CKPT_NEVER), mesh=other,
                        on_step=lambda s, p, o, m:
                        resumed.append((s, float(m["loss"]))))
    out.update(resumed=resumed, restarted_run_s=time.perf_counter() - t1,
               disk_after=disk())
    full = keep.get(f"qwen {CKPT_GRID} losses", [])
    out["losses"] = full
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    check(all(at_other) and out.get("restored_unsharded_equal", True),
          f"grids checkpoint: restored leaves differ: {out}")
    check([s for s, _ in resumed] == [1, 2] and len(full) == 3 and all(
        abs(got - full[s]) <= SLICE13_LOSS_RTOL * abs(full[s])
        for s, got in resumed),
          f"grids checkpoint: the run restarted at {CKPT_RESTORE_GRID} "
          f"gave {resumed}, the uninterrupted run {full}")
    return out


#: every family served across four cards (``--grids``), each at its full
#: published width and depth, its fields checked (slices 8 and 9 cut
#: InternVL2-76B to 20 of 80 layers and Moonlight to 24 of 48 on one card;
#: on a grid each rank draws its own blocks only, ``init_params(mesh=)``):
#: (arch, None, prompt tokens, published fields, frontend input and its
#: length or None), the prompts and inputs of slices 8, 9 and 15. At
#: (1, 4) ChatGLM3-6B's 32 query heads split and its 2 KV heads do not, so
#: its cache splits on the sequence
FAMILY_SERVE = tuple(
    [(TRAIN_ARCH, None, 64, TRAIN_FIELDS, None)]
    + [f + (None,) for f in SLICE8_FAMILIES if f[0] == "minicpm3_4b"]
    + [(f[0], None) + f[2:] for f in SLICE9_FAMILIES
       if f[0] == "internvl2_76b"]
    + [(f[0], None) + f[2:] + (None,) for f in SLICE8_FAMILIES
       if f[0] != "minicpm3_4b"]
    + [f for f in SLICE9_FAMILIES if f[0] == "seamless_m4t_medium"]
    + [(SLICE15_GEMMA, None, SLICE15_GEMMA_PROMPT, SLICE15_GEMMA_FIELDS,
        None),
       (SLICE15_ARCH, None, SLICE15_PROMPT, SLICE15_FIELDS, None)])
#: each family's serving grids and the requests a grid serves: one user
#: on a model split over the four cards' ``model`` axis, and four split
#: two by two; FAMILY_NEW new tokens a request, the first through the
#: private lookup
FAMILY_GRIDS = (((1, 4), 1), ((2, 2), 4))
FAMILY_NEW = 32
#: the depths cut on a grid: InternVL2-76B's 80 layers would put ~68 GB of
#: weights on each rank of (2, 2), where only the data axis splits the
#: batch, so it serves 20 there (its 80 at (1, 4): ~34 GB a rank)
FAMILY_DEPTH = {("internvl2_76b", (2, 2)): 20}
#: the families held to an unsharded run that draws each layer when it is
#: reached (:class:`DrawnLayers`) instead of the whole tree: InternVL2-76B's
#: 80 layers (~141 GB) fit no card, and Moonlight's 48 (57.8 GB) would
#: leave rank 0's card little room
FAMILY_STREAMED = ("internvl2_76b", "moonshot_v1_16b_a3b")
#: each family's peak a rank reckoned before the four-card run (GB, low
#: and high), at (1, 4) with one request and at (2, 2) with four: its
#: blocks (exact from the shapes), the table's and head's blocks, the
#: private step's shares of its block of the table (c = 4, int32) and
#: their set-up, the cache and activations; logged beside the measured
#: peak, not checked
FAMILY_PEAK_GB = {
    "qwen1_5_4b": ((5, 7), (9, 12)),
    "minicpm3_4b": ((4, 6), (7, 9.5)),
    "internvl2_76b": ((45, 55), (34, 40)),
    "granite_moe_3b_a800m": ((2.3, 4), (4.5, 6.5)),
    "moonshot_v1_16b_a3b": ((17.5, 24), (34, 40)),
    "mamba2_2_7b": ((2.5, 4.5), (4.8, 7)),
    "hymba_1_5b": ((2.3, 4), (2.6, 4.5)),
    "seamless_m4t_medium": ((2.8, 4), (5, 6.5)),
    "gemma3_1b": ((3.1, 4.5), (5.6, 7)),
    "chatglm3_6b": ((5.5, 7.5), (10, 12)),
}


def family_cfg(arch, shape=None):
    """A FAMILY_SERVE row's configuration (its published fields checked,
    its depth cut where FAMILY_DEPTH says for grid ``shape``), prompt
    length and frontend."""
    import dataclasses

    from repro_torch import configs
    _, layers, t, fields, frontend = next(f for f in FAMILY_SERVE
                                          if f[0] == arch)
    cfg = configs.full(arch)
    bad = {k: getattr(cfg, k) for k, v in fields.items()
           if getattr(cfg, k) != v}
    check(not bad and cfg.dtype == "bfloat16",
          f"grids {arch} is not the published configuration: {bad}")
    layers = FAMILY_DEPTH.get((arch, shape), layers)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg, t, frontend


def family_depths(arch):
    """The depths ``arch`` serves at on FAMILY_GRIDS, in the grids'
    order."""
    out = []
    for s, _ in FAMILY_GRIDS:
        n = family_cfg(arch, s)[0].n_layers
        if n not in out:
            out.append(n)
    return out


def want_unit(arch, layers):
    """The name of the unsharded unit a grid of ``arch`` at ``layers`` is
    held to (its depth named where the family serves at two)."""
    deep = len(family_depths(arch)) > 1
    return f"{arch} unsharded" + (f", {layers} layers" if deep else "")


def family_inputs(args, arch, cfg, t, frontend):
    """A family's SLICE8_BATCH requests: prompt tokens and, for a
    frontend, its frames or patches, drawn from ``--seed`` (numpy)."""
    idx = [f[0] for f in FAMILY_SERVE].index(arch)
    rng = np.random.default_rng(args.seed + 2100 + idx)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (SLICE8_BATCH, t)).astype(np.int32)}
    if frontend is not None:
        name, n = frontend
        out[name] = rng.standard_normal(
            (SLICE8_BATCH, n, cfg.frontend_dim)).astype(np.float32)
    return out


def family_params(torch, args, cfg, mesh=None, streamed=False):
    """The family's weights from ``--seed`` with the dequantized table
    (the rows the private lookup opens; a tied head reads them too). On
    ``mesh`` each rank draws its own blocks only
    (``init_params(mesh=)``) and dequantizes its block of the table (the
    dequantization is elementwise). ``streamed`` leaves the decoder
    stack out: its layers are drawn as they are reached
    (:class:`DrawnLayers`)."""
    import dataclasses

    from repro_torch import _device
    from repro_torch.models import lm
    if streamed:
        # the table's, the head's and the frontend's keys do not depend
        # on the depth: the stem of the same tree
        params = lm.init_params(args.seed, dataclasses.replace(
            cfg, n_layers=0))
        params["blocks"] = DrawnLayers(args.seed, cfg,
                                       params["final_norm"].device)
    else:
        params = lm.init_params(args.seed, cfg, mesh=mesh)
    table = _device.local(params["embed"])
    table.copy_(dequantized(torch, table))
    del table
    _free(torch)
    return params


class DrawnLayers:
    """The decoder stack of ``init_params(seed, cfg)`` a layer at a time:
    indexing it draws layer ``i`` on ``device`` (``lm.block_params``, the
    same bits as the stack's row ``i``), which ``lm``'s block loop runs
    and drops before the next: an unsharded run of a model larger than
    one card. ``draws`` counts the layers drawn."""

    def __init__(self, seed, cfg, device):
        self.seed, self.cfg, self.device = seed, cfg, device
        self.draws = 0

    def __getitem__(self, i):
        from repro_torch.models import lm
        self.draws += 1
        return lm.block_params(self.seed, self.cfg, i, self.device)


def rank_gb(torch, tree) -> float:
    """GB of this rank's blocks of a tree's tensors (a plain tensor whole;
    a :class:`DrawnLayers` stack none)."""
    from repro_torch import _device, _tree
    return sum(_device.local(t).numel() * t.element_size()
               for t in _tree.leaves(tree)
               if isinstance(t, torch.Tensor)) / 1e9


def serve_run(torch, params, cfg, inputs, n_new, mesh=None, private=None):
    """Greedy generation of ``n_new`` tokens after ``inputs`` (numpy:
    tokens (B, T), frames or patches) through ``lm.prefill`` and
    ``lm.decode_step``, unsharded or on ``mesh`` (DTensor parameters,
    batch and cache) -> the tokens (B, n_new), the first two steps' whole
    logits, each step's top-two gap, prefill ms and ms a plaintext decode
    step (host clock between synchronizes). With ``private`` (a dict),
    the first decode step looks its tokens up through
    ``private_lookup_inline`` (``cfg.private_embed``): its launches by
    kernel, by card and by route, its wrapper calls, its opened rows and
    the tokens it looked up, and its ms go there."""
    import dataclasses

    from repro_torch import sharding
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels import ops
    from repro_torch.kernels import ss_matmul as ssm
    from repro_torch.models import lm
    from repro_torch.models import private_embed as pe

    if mesh is None:
        dev = params["final_norm"].device
        batch = to_device(inputs, dev)

        def put(tok):
            return tok
    else:
        dev = sharding.mesh_device(mesh)
        dp = sharding.dp_entry(mesh)
        batch = to_device(inputs, dev, mesh=mesh, specs={
            k: (dp,) + (None,) * (v.ndim - 1) for k, v in inputs.items()})
        pls = sharding.placements((dp, None), mesh)

        def put(tok):
            return sharding.place(tok, mesh, pls)

    def whole(x):
        return x.full_tensor() if mesh is not None else x

    t = inputs["tokens"].shape[1] + (cfg.n_prefix if "patches" in inputs
                                     else 0)
    first, gen, gaps = [], [], []

    def take(logits):
        w = whole(logits)
        if len(first) < 2:
            first.append(w.cpu())
        w = w[:, -1].float()
        top = torch.topk(w, 2, dim=-1).values
        gaps.append(top[:, 0] - top[:, 1])
        gen.append(torch.argmax(w, dim=-1, keepdim=True).to(torch.int32))

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(params, cfg, batch, max_len=t + n_new)
        take(logits)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if private is not None:
            pcfg = dataclasses.replace(cfg, private_embed=True)
            calls = collections.Counter()
            inner = {k: getattr(ssm, k) for k in (
                "share_onehot_cuda", "ss_matmul_cuda", "ss_matmul_tall_cuda")}
            inner_lookup = pe.private_lookup_inline

            def counted(name):
                def fn(*a, **kw):
                    calls[name] += 1
                    return inner[name](*a, **kw)
                return fn

            def lookup(p, c, tokens, **kw):
                out = inner_lookup(p, c, tokens, **kw)
                private["rows"] = whole(out).clone()
                private["type"] = type(out).__name__
                return out

            for k in inner:
                setattr(ssm, k, counted(k))
            pe.private_lookup_inline = lookup
            try:
                ops.reset_launch_counts()
                logits, cache = lm.decode_step(params, pcfg, cache, t,
                                               {"tokens": put(gen[-1])})
                torch.cuda.synchronize()
                private.update(
                    launches=ops.launch_counts(),
                    by_card=ops.card_launch_counts(),
                    routes=ops.onehot_route_counts(), calls=dict(calls),
                    tokens=gen[-1].cpu(),
                    ms=1e3 * (time.perf_counter() - t1))
            finally:
                for k, fn in inner.items():
                    setattr(ssm, k, fn)
                pe.private_lookup_inline = inner_lookup
            take(logits)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        plain_steps = n_new - len(gen)    # step k feeds gen[k] at t + k
        for k in range(len(gen) - 1, n_new - 1):
            logits, cache = lm.decode_step(params, cfg, cache, t + k,
                                           {"tokens": put(gen[-1])})
            take(logits)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    out = {"tokens": torch.cat(gen, 1).cpu().numpy(), "logits": first,
           "gaps": torch.stack(gaps, 1).cpu().numpy(),
           "prefill_ms": 1e3 * (t1 - t0),
           "decode_ms_per_step": 1e3 * (t3 - t2) / max(1, plain_steps)}
    if mesh is not None:
        from repro_torch import _tree
        from repro_torch.models.config import ShapeConfig
        spec = sharding.cache_spec(cfg, mesh, ShapeConfig(
            "cache", t + n_new, inputs["tokens"].shape[0], "decode"))
        placed = _tree.map_leaves(lambda c, sp: list(c.placements) == list(
            sharding.placements(sp, mesh)), cache, spec)
        out["cache_placements"] = {
            p: [repr(x) for x in c.placements]
            for p, c in _tree.leaves_with_paths(cache)}
        out["cache_placed_by_spec"] = all(_tree.leaves(placed))
    del cache, logits
    return out


def grid_family_want(torch, args, mesh, keep, arch, layers):
    """Rank 0: a FAMILY_SERVE family's greedy generation at ``layers``
    unsharded over its SLICE8_BATCH requests (:func:`serve_run`,
    plaintext lookups in the dequantized table), kept for its serving
    grids at that depth. A family of FAMILY_STREAMED draws each layer when
    the block loop reaches it (:class:`DrawnLayers`: every step draws
    every layer), so no card holds its stack; its ms then count the
    draws."""
    import dataclasses
    cfg, t, frontend = family_cfg(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers)
    streamed = arch in FAMILY_STREAMED
    params = family_params(torch, args, cfg, streamed=streamed)
    want = serve_run(torch, params, cfg,
                     family_inputs(args, arch, cfg, t, frontend), FAMILY_NEW)
    draws = params["blocks"].draws if streamed else None
    weights_gb = rank_gb(torch, params)
    del params
    _free(torch)
    keep[(arch, layers)] = want
    out = {"layers": cfg.n_layers, "streamed": streamed,
           "layer_draws": draws, "weights_gb": weights_gb,
           "prefill_ms": want["prefill_ms"],
           "decode_ms_per_step": want["decode_ms_per_step"],
           "tokens_first_request": want["tokens"][0].tolist()}
    if streamed:
        check(draws == layers * FAMILY_NEW,
              f"grids {arch}: the layer-streamed run drew {draws} layers, "
              f"{layers} a step of {FAMILY_NEW} wanted")
    return out


def grid_family(torch, args, mesh, keep, arch, batch):
    """A FAMILY_SERVE family on a serving grid of FAMILY_GRIDS: its weights
    placed by ``sharding.param_shardings``, the first ``batch`` requests
    served (:func:`serve_run`) with the first decode step private. That
    step must launch one ``share_onehot`` and one contraction (the tall
    ``ss_matmul`` where the shape calls for it) on this rank's own card,
    each through its wrapper, and open the rows of the dequantized table
    at its tokens bit for bit. The cache must sit as
    ``sharding.cache_spec`` places it. Rank 0 holds the tokens to the
    unsharded run's up to a near-tie (a request may part from them only
    at a step whose unsharded top-two gap is at most SLICE15_TIE_ATOL;
    every parting is logged with its gap) and logs the first two steps'
    largest logit differences."""
    import torch.distributed as dist

    from repro_torch import sharding

    shape = tuple(mesh.shape)
    tag = f"grids {arch} {shape}"
    cfg, t, frontend = family_cfg(arch, shape)
    params = family_params(torch, args, cfg, mesh)
    weights_gb = rank_gb(torch, params)
    inputs = {k: v[:batch] for k, v in family_inputs(
        args, arch, cfg, t, frontend).items()}
    private = {}
    res = serve_run(torch, params, cfg, inputs, FAMILY_NEW, mesh=mesh,
                    private=private)
    table = params["embed"].full_tensor()
    rows_equal = private.get("type") == "DTensor" and torch.equal(
        private["rows"], table[private["tokens"].to(table.device).long()])
    del params, table
    _free(torch)
    card = sharding.mesh_device(mesh)
    launches, by_card = private["launches"], private["by_card"]
    mm = [k for k in ("ss_matmul", "ss_matmul_tall") if launches[k]]
    res.update(layers=cfg.n_layers, batch=batch, card=str(card),
               weights_gb=weights_gb,
               predicted_peak_gb=FAMILY_PEAK_GB[arch][
                   [s for s, _ in FAMILY_GRIDS].index(shape)],
               private_ms=private["ms"], private_rows_equal=rows_equal,
               private_launches={k: launches[k] for k in (
                   "share_onehot", "ss_matmul", "ss_matmul_tall")},
               private_calls=private["calls"],
               private_onehot_routes=private["routes"])
    logits, got = res.pop("logits"), res.pop("tokens")
    res.pop("gaps")
    if dist.get_rank() == 0:
        want = keep[(arch, cfg.n_layers)]
        res["logits_max_abs_diff"] = [
            float((g - w[:batch]).abs().max())
            for g, w in zip(logits, want["logits"])]
        parted = {}
        for r in range(batch):
            steps = np.flatnonzero(got[r] != want["tokens"][r])
            if steps.size:
                parted[r] = (int(steps[0]),
                             float(want["gaps"][r, steps[0]]))
        res.update(tokens_equal=not parted, parted_at_step_gap=parted)
        check(all(gap <= SLICE15_TIE_ATOL for _, gap in parted.values()),
              f"{tag}: greedy tokens part from the unsharded run's where "
              f"no near-tie lies: {parted}")
        check(all(np.isfinite(x) for x in res["logits_max_abs_diff"]),
              f"{tag}: logits not finite: {res['logits_max_abs_diff']}")
    del logits
    check(launches["share_onehot"] == 1 and len(mm) == 1
          and launches[mm[0]] == 1
          and all(by_card[k] == {card.index: 1}
                  for k in ["share_onehot"] + mm)
          and private["calls"].get("share_onehot_cuda") == 1
          and sum(private["calls"].values()) == 2,
          f"{tag}: the private step launched {launches} (by card "
          f"{by_card}, wrapper calls {private['calls']}): one share_onehot "
          f"and one ss_matmul on this rank's card {card} wanted")
    check(rows_equal, f"{tag}: the private step's opened rows differ from "
          "the dequantized table's rows at its tokens")
    check(res["cache_placed_by_spec"],
          f"{tag}: the cache is not placed as cache_spec says: "
          f"{res['cache_placements']}")
    return res


def grid_links(torch, args, mesh, keep):
    """NCCL's all-reduce, all-gather and reduce-scatter alone, each over
    both axes' groups of ``mesh`` and over the whole world: a call's
    device ms by CUDA events around it, the ranks set off together by a
    barrier (the median of 5 after 2 untimed), for LINK_BYTES of output
    -> the output and NCCL's bus bytes a second, beside the walker's ms
    for the same collective (``hlo_cost.CostMode`` over its
    ``_functional_collectives`` form, run once: ``t_collective``, its bus
    bytes at ``hlo_analysis.bus_rate``) and their ratio, logged: rates
    measured on a card at another power limit, or on a busier host, move
    the ratio without a fault in the walker."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    from repro_torch import sharding
    from repro_torch.launch import hlo_analysis, hlo_cost

    dev, n = sharding.mesh_device(mesh), LINK_BYTES // 4
    out = {}
    for gname, group, dim in (("world", dist.group.WORLD, None),
                              ("data", mesh.get_group("data"), 0),
                              ("model", mesh.get_group("model"), 1)):
        k = dist.get_world_size(group)
        dst = torch.ones(n, dtype=torch.float32, device=dev)
        calls = {
            "all-reduce": lambda: dist.all_reduce(dst, group=group),
            "all-gather": lambda: dist.all_gather_into_tensor(
                dst, src[:n // k], group=group),
            "reduce-scatter": lambda: dist.reduce_scatter_tensor(
                dst, src, group=group)}
        ref = group if dim is None else (mesh, dim)
        walked = {
            "all-reduce": lambda: funcol.all_reduce(dst, "sum", ref),
            "all-gather": lambda: funcol.all_gather_tensor(
                src[:n // k], 0, ref),
            "reduce-scatter": lambda: funcol.reduce_scatter_tensor(
                src, "sum", 0, ref)}
        src = torch.ones(n * k, dtype=torch.float32, device=dev)
        for kind, call in calls.items():
            for _ in range(2):
                call()
            ms = []
            for _ in range(5):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                call()
                t1.record()
                torch.cuda.synchronize()
                ms.append(t0.elapsed_time(t1))
            med = sorted(ms)[len(ms) // 2]
            with hlo_cost.CostMode(device=MESH_DEVICE) as mode:
                funcol.wait_tensor(walked[kind]())
            torch.cuda.synchronize()
            walker_ms = 1e3 * mode.cost.roofline(
                n_chips=dist.get_world_size()).t_collective
            out[f"{kind} {gname} ({k} ranks)"] = {
                "ms": med, "output_gb_per_s": LINK_BYTES / med / 1e6,
                "bus_gb_per_s": hlo_analysis.bus_factor(kind, k)
                * LINK_BYTES / med / 1e6,
                "walker_ms": walker_ms,
                "walker_groups": dict(mode.cost.collective_groups),
                "walker_over_measured": walker_ms / med}
        del dst, src
    log("grids links measured " + json.dumps(out))
    return out


def grid_units(world: int):
    """(name, grid or None for rank 0 alone, function) of every unit a
    world of ``world`` ranks runs, in order: the grids of that size, and
    on one rank the unsharded runs they are held to."""
    import functools
    units = [(f"qwen {s}", s, grid_qwen) for s in QWEN_GRIDS
             if math.prod(s) == world]
    if world == math.prod(LINK_GRID):
        units.append(("links", LINK_GRID, grid_links))
    grids = [(s, b) for s, b in FAMILY_GRIDS if math.prod(s) == world]
    for arch, *_ in (FAMILY_SERVE if grids else ()):
        for layers in family_depths(arch):
            units.append((want_unit(arch, layers), None, functools.partial(
                grid_family_want, arch=arch, layers=layers)))
        units += [(f"{arch} {s}", s, functools.partial(
            grid_family, arch=arch, batch=b)) for s, b in grids]
    if world == 1:
        units.append(("granite sort unsharded", None, grid_sort_unsharded))
    units += [(f"granite {s}", s, grid_granite) for s in GRANITE_GRIDS
              if math.prod(s) == world]
    if world == math.prod(SORT_BRIDGE_GRID):
        units.append((f"granite sort {SORT_BRIDGE_GRID}", SORT_BRIDGE_GRID,
                      grid_sort_bridge))
    if world == math.prod(CKPT_GRID):
        units.append(("checkpoint", CKPT_GRID, grid_checkpoint))
    return units


def grids_rank(torch, seed, out_dir, units_of=None):
    """One rank of ``--grids`` (or of ``--grids-train``: ``units_of`` =
    :func:`train4_units`): every unit of ``units_of(world)`` (default
    :func:`grid_units`) in turn,
    each on every rank of the world (a unit of no grid on rank 0 alone),
    a world barrier after each. A failed check is recorded and the rank
    goes on to the next unit (every check follows the unit's collectives,
    so the other ranks are not left waiting in one); any other error ends
    the rank, and :func:`spawn_ranks` then ends the others. After each
    unit the rank writes what it has to ``out_dir/rank<r>.json``, marked
    ``done`` after the last. An error every rank meets alike (DTensor's
    refusal of an op, say) is recorded as a failed check is; one that
    leaves another rank waiting in a collective ends the world at its
    deadline. An out-of-memory error ends the rank (and the world) where
    it happens: no later unit runs on what it left behind."""
    import torch.distributed as dist

    args = argparse.Namespace(seed=seed)
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank, "card": str(torch.device(
        MESH_DEVICE, torch.cuda.current_device())), "units": {},
        "failed": {}}
    keep = {}
    units = (units_of or grid_units)(world)
    for i, (name, shape, fn) in enumerate(units):
        mesh = grid_mesh(torch, shape) if shape else None
        if shape or rank == 0:
            t0 = time.perf_counter()
            log(f"grids {name}: start")
            torch.cuda.reset_peak_memory_stats()
            try:
                res = fn(torch, args, mesh, keep)
            except Exception as e:
                import traceback
                if isinstance(e, torch.cuda.OutOfMemoryError):
                    raise
                out["failed"][name] = (
                    str(e) if isinstance(e, AssertionError)
                    else traceback.format_exc()[-4000:])
                log(f"grids {name}: failed: {out['failed'][name]}")
                res = {}
            res["seconds"] = time.perf_counter() - t0
            res.setdefault("peak_gb", torch.cuda.max_memory_allocated() / 1e9)
            out["units"][name] = res
            log(f"grids {name}: " + json.dumps(res, default=str))
        _free(torch)
        out["done"] = i == len(units) - 1
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f, default=str)
        dist.barrier()


def sort_held(ranks, want, tol, same_drops):
    """A grid's sort step (each rank's :func:`sort_step`, rank 0 first)
    against ``want`` (another's, or the unsharded one): the loss within
    ``tol`` relative and, with ``same_drops``, equal dropped pairs (a
    grid's summed over its ranks at model coordinate 0) -> (the row, held
    or not)."""
    def drops(rs):
        return sum(x["dropped_pairs"] for x in rs
                   if x["coordinate"] is None or x["coordinate"][1] == 0)

    ref = want[0].get("loss", math.nan) if want else math.nan
    rel = abs(ranks[0]["loss"] - ref) / abs(ref)
    row = {"loss": ranks[0]["loss"], "held_to_loss": ref,
           "loss_rel_diff": rel, "dropped_pairs": drops(ranks),
           "held_to_dropped_pairs": drops(want) if want else None}
    return row, rel <= tol and not (
        same_drops and row["dropped_pairs"] != row["held_to_dropped_pairs"])


def grids_losses(units, failed):
    """Hold each family's grids to its (1, 1) mesh (losses within
    SLICE13_LOSS_RTOL) and the sort dispatch to the unsharded steps: in
    bf16 the loss within SLICE13_LOSS_RTOL (its dropped pairs logged), in
    float32 within SLICE13_STEP0_RTOL relative with equal dropped pairs
    (:func:`sort_held`); at SORT_FULL_LAYERS to SORT_BRIDGE_GRID's, which
    is held to the unsharded step at SORT_EXACT_LAYERS -> the summary by
    grid. ``units`` maps a unit's name to its ranks' results, rank 0
    first."""
    out = {}
    plain = units.get("granite sort unsharded", [{}])[0]
    bridge = units.get(f"granite sort {SORT_BRIDGE_GRID}", [])

    def held_to(key):
        """The ranks' results a grid's ``key`` sort step is held to."""
        if key == f"float32 {SORT_FULL_LAYERS}":
            return [r["sort"][key] for r in bridge]
        return [plain[key]] if key in plain else []

    if bridge:
        key = f"float32 {SORT_EXACT_LAYERS}"
        row, ok = sort_held([r["sort"][key] for r in bridge], held_to(key),
                            SLICE13_STEP0_RTOL, True)
        out[f"granite sort {SORT_BRIDGE_GRID}"] = {"sort": {key: row}}
        if not ok:
            failed[f"granite sort {SORT_BRIDGE_GRID} {key}"] = json.dumps(
                row)
    for fam, grids in (("qwen", QWEN_GRIDS), ("granite", GRANITE_GRIDS)):
        base = units.get(f"{fam} (1, 1)", [{}])[0].get("losses")
        for s in grids:
            name = f"{fam} {s}"
            ranks = units.get(name, [])
            if not ranks or "losses" not in ranks[0]:
                continue
            got = ranks[0]["losses"]
            diff = [abs(a - b) / abs(b) for a, b in zip(got, base or [])]
            row = {"losses": got, "loss_rel_diff": diff,
                   "ms_per_step": ranks[0]["ms_per_step"],
                   "idle_share_rank0": ranks[0]["idle_share"],
                   "nccl_ms_rank0": ranks[0]["nccl_ms_by_kind"],
                   "peak_gb_by_rank": [r.get("peak_gb") for r in ranks]}
            if not base or len(diff) != len(got) or not all(
                    math.isfinite(x) for x in got) or max(diff) > \
                    SLICE13_LOSS_RTOL:
                failed[f"{name} losses"] = (f"{got} against the (1, 1) "
                                            f"mesh's {base}")
            if fam == "qwen":
                row["private_launches_by_rank"] = [
                    r.get("private_launches") for r in ranks]
            elif all("sort" in r for r in ranks):
                row["sort"] = {}
                for key in ranks[0]["sort"]:
                    bf16 = key == "bf16"
                    got, ok = sort_held(
                        [r["sort"][key] for r in ranks], held_to(key),
                        SLICE13_LOSS_RTOL if bf16 else SLICE13_STEP0_RTOL,
                        not bf16)
                    row["sort"][key] = got
                    if not ok:
                        failed[f"{name} sort dispatch {key}"] = json.dumps(
                            got)
            out[name] = row
    return out


def grids_collectives(units):
    """Each profiled grid's NCCL kernels' device ms by collective on rank
    0 against the walker's prediction (``hlo_analysis.seconds_by_kind``) by kind and
    its ``t_collective``, with the ratio measured / predicted."""
    out = {}
    for fam, s in PROFILED_GRID.items():
        unit = units.get(f"{fam} {s}", [{}])[0]
        if "walk" not in unit:
            continue
        got, walk = unit["nccl_ms_by_kind"], unit["walk"]
        pred = walk["predicted_ms_by_kind"]
        out[f"{fam} {s}"] = {
            "measured_ms_by_kind": got, "predicted_ms_by_kind": pred,
            "ratio_by_kind": {k: got.get(k, 0.0) / v for k, v in pred.items()
                              if v},
            "measured_ms": sum(got.values()),
            "t_collective_ms": walk["t_collective_ms"],
            "ratio": sum(got.values()) / walk["t_collective_ms"]
            if walk["t_collective_ms"] else None,
            "collective_bytes": walk["collective_bytes"],
            "profiled_step_ms": unit["profiled_step_ms"],
            "walk_unpriced": walk["unpriced"]}
        log(f"grids collectives {fam} {s} (measured on rank 0 against the "
            f"walker) " + json.dumps(out[f"{fam} {s}"]))
    return out


def grids_families(units, cards, failed):
    """The serving grids of FAMILY_SERVE by family and grid: rank 0's ms a
    decode step, prefill ms, the private step's ms and launches, tokens
    against the unsharded run's (partings and their gaps), the first two
    steps' largest logit differences, and every rank's peak and private
    launches by card; a family grid that the host's ``cards`` allow and
    that did not run is a failure."""
    out = {}
    for arch, *_ in FAMILY_SERVE:
        for s, b in FAMILY_GRIDS:
            name = f"{arch} {s}"
            ranks = units.get(name, [])
            if math.prod(s) > cards:
                continue                    # logged as not run
            if not ranks:
                failed[name] = "did not run"
            if not ranks or "decode_ms_per_step" not in ranks[0]:
                continue                    # its failure is recorded
            r0 = ranks[0]
            want = units.get(want_unit(arch, r0.get("layers")), [{}])[0]
            out[name] = {
                "batch": b, "layers": r0.get("layers"),
                "decode_ms_per_step": r0["decode_ms_per_step"],
                "unsharded_decode_ms_per_step": want.get(
                    "decode_ms_per_step"),
                "unsharded_streamed": want.get("streamed"),
                "unsharded_peak_gb": want.get("peak_gb"),
                "prefill_ms": r0["prefill_ms"],
                "private_ms": r0.get("private_ms"),
                "tokens_equal": r0.get("tokens_equal"),
                "parted_at_step_gap": r0.get("parted_at_step_gap"),
                "logits_max_abs_diff": r0.get("logits_max_abs_diff"),
                "private_launches_by_rank": {
                    r.get("card"): r.get("private_launches")
                    for r in ranks},
                "peak_gb_by_rank": [r.get("peak_gb") for r in ranks],
                "weights_gb_by_rank": [r.get("weights_gb") for r in ranks],
                "predicted_peak_gb": r0.get("predicted_peak_gb"),
                "seconds": r0.get("seconds")}
    log("grids families " + json.dumps(out, default=str))
    return out


def grids_dispatch(torch, args, cards, failed):
    """Slice 11 (b) over DISPATCH_CARDS distinct cards (n_model 2: a 1 x 2
    and a 2 x 2 grid) at ``--tuples``: the answers and ledgers the 1 x 1
    grid's under strict mode (:func:`slice11_check`), group 0's clouds
    bit-identical in the isolation steps, and every slice-11 kernel
    launched on each card of the grid."""
    from repro_torch.launch.mesh import make_dispatch_mesh

    ks = [k for k in DISPATCH_CARDS if k <= cards]
    if not ks:
        return {}
    rows = make_rows(args.tuples, args.seed)
    db = employee_db(rows, args.seed)
    assign, child_db = slice11_child(args, rows, N_ASSIGN)
    plans, want = slice11_cases(rows, assign, child_db, args.seed)
    out = {}
    for k in ks:
        t0 = time.perf_counter()
        grid = make_dispatch_mesh(2, devices=[f"cuda:{i}" for i in range(k)])
        label = f"(b) {k} cards"
        try:
            _, by_card = slice11_check(torch, args, db, plans, want, grid,
                                       label)
            slice11_isolation(torch, args, db, plans, want, grid, label)
            missing = {n: sorted(set(range(k)) - set(by_card[n]))
                       for n in SLICE11_KERNELS
                       if set(range(k)) - set(by_card[n])}
            check(not missing, f"slice 11 {label}: kernels launched on no "
                  f"block of these cards: {missing}")
            out[label] = {"launches_by_card": by_card}
        except AssertionError as e:
            failed[f"slice 11 {label}"] = str(e)
        log(f"slice 11 {label} took {time.perf_counter() - t0:.1f} s")
    del db, child_db
    _free(torch)
    return out


def grids_path(torch, args) -> int:
    """``--grids``: the production mesh across the cards of one host. For
    each world size of GRID_WORLDS that the host's cards allow (none on
    one card), that many ranks spawned through :func:`rank_main` run
    :func:`grids_rank`'s units; then, in this process, MeshDispatcher
    over distinct cards (:func:`grids_dispatch`). Phases needing more
    cards than the host has log that they did not run. Every failure is
    gathered and the run fails at its end."""
    import shutil

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    worlds = [w for w in GRID_WORLDS if w <= cards] if cards >= 2 else []
    log(f"grids: {cards} cards ({smi('name,power.limit')}), worlds of "
        f"{worlds} ranks")
    log_grids_not_run(cards, "--grids")
    failed, units = {}, {}
    for world in worlds:
        t1 = time.perf_counter()
        out_dir = os.path.join(ROOT, "build", "grids", f"world{world}")
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        try:
            spawn_ranks(world, grids_rank, args.seed, out_dir)
        except Exception as e:               # a rank's error: reported
            failed[f"world of {world}"] = repr(e)
        res = []
        for r in range(world):
            path = os.path.join(out_dir, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    res.append(json.load(f))
        for r in res:
            failed.update({f"rank {r['rank']} of {world} {k}": v
                           for k, v in r["failed"].items()})
            for name, v in r["units"].items():
                units.setdefault(name, []).append(v)
        log(f"grids world of {world} ranks took "
            f"{time.perf_counter() - t1:.1f} s; every rank ran every unit: "
            f"{len(res) == world and all(r['done'] for r in res)}; "
            f"ended: {f'world of {world}' not in failed}")
    grids = grids_losses(units, failed)
    log("grids training " + json.dumps(grids))
    coll = grids_collectives(units)
    links = units.get("links", [None])[0]
    log("grids links (each collective alone, rank 0) " + json.dumps(links))
    families = grids_families(units, cards, failed)
    dispatch = grids_dispatch(torch, args, cards, failed)
    log("grids summary " + json.dumps({
        "card": smi("name,power.limit"), "cards": cards, "worlds": worlds,
        "training": {k: {f: v[f] for f in ("ms_per_step", "loss_rel_diff",
                                           "peak_gb_by_rank")}
                     for k, v in grids.items() if "ms_per_step" in v},
        "sort": {k: v["sort"] for k, v in grids.items() if "sort" in v},
        "checkpoint": units.get("checkpoint", [None])[0],
        "families": families,
        "collectives_ratio": {k: v["ratio"] for k, v in coll.items()},
        "links_gb_per_s": {k: v["output_gb_per_s"] for k, v in (
            links or {}).items() if isinstance(v, dict)},
        "links_walker_over_measured": {
            k: v["walker_over_measured"] for k, v in (links or {}).items()
            if isinstance(v, dict)},
        "dispatch": list(dispatch), "failed": failed,
        "seconds": time.perf_counter() - t0}, default=str))
    check(not failed, f"--grids: {len(failed)} checks failed: "
          + json.dumps(failed, default=str))
    return 0


# ---------------------------------------------------------------------------
# --grids-train: training across four cards for the families no card holds
# ---------------------------------------------------------------------------

#: --grids-train trains each family whose training state (12 B a
#: parameter) no card holds across the four cards of one host, on the
#: production mesh, each rank drawing its own blocks only: (arch, trained
#: depth or None for every layer, trained grids, held depth, tokens a
#: sequence, frontend input and its length or None), at full published
#: width (FAMILY_SERVE's fields), bf16, remat, TRAIN_BATCH sequences a
#: step. Parameters split over ``model`` only, so (2, 2) doubles a rank's
#: state: only (1, 4) holds Moonlight at 38 of 48 layers and InternVL2-76B
#: at 24 of 80 (the port's dry-run: 72.44 and 70.33 GB a rank; 91.02 at
#: Moonlight's 48). ChatGLM3-6B's 28 layers (20.34 GB a rank at (1, 4),
#: 44.75 at (2, 2)) go through ``launch.train.main(mesh=)``, the cut
#: depths through its loop (:func:`frontend_train`), InternVL2's
#: sequences 256 patches before 256 tokens (the dry-run's train_4k). The
#: held depth is what one card trains too (ChatGLM3-6B at 16 layers,
#: 46.83 GB; Moonlight at 4, 39.23; InternVL2-76B at 2, 49.84)
TRAIN4_FAMILIES = (
    ("chatglm3_6b", None, ((1, 4), (2, 2)), 16, TRAIN_SEQ, None),
    ("internvl2_76b", 24, ((1, 4),), 2, 256, ("patches", 256)),
    ("moonshot_v1_16b_a3b", 38, ((1, 4),), 4, TRAIN_SEQ, None),
)
TRAIN4_WORLD, TRAIN4_STEPS, TRAIN4_DEADLINE_S = 4, 3, 1500
#: the grid of every family's private-embedding step (at its held depth:
#: at the trained depth a rank has no room for the table's shares); its
#: table splits over the vocabulary, K = V / 4 rows a rank
TRAIN4_PRIVATE_GRID = (1, 4)
#: each trained run's peak a rank (GB), predicted before the first
#: four-card run by the port's dry-run (``launch.dryrun.price_cell`` on
#: meta, 4 x 512 positions, no accumulation: bf16 parameters, float32
#: AdamW moments, temporaries with the bf16 gradients); logged beside the
#: measured peaks, not checked
TRAIN4_PEAK_GB = {("chatglm3_6b", (1, 4)): 20.34,
                  ("chatglm3_6b", (2, 2)): 44.75,
                  ("internvl2_76b", (1, 4)): 70.33,
                  ("moonshot_v1_16b_a3b", (1, 4)): 72.44}
#: the float32 step's loss on a grid against one card's (relative)
TRAIN4_F32_LOSS_RTOL = 1e-5
#: the ranks' CUDA caching allocator: the trained runs hold 70-72 GB a
#: rank of the card's 79.18 GiB, and with the default fixed segments
#: Moonlight's backward at 38 layers ran out asking for its 3.27 GiB
#: stack of expert gradients with 9.95 GiB reserved but unallocated
#: (fragmented) beside 64.28 GiB in use; expandable segments grow in
#: place instead
TRAIN4_ALLOC_CONF = "expandable_segments:True"


def train4_row(arch):
    return next(r for r in TRAIN4_FAMILIES if r[0] == arch)


def train4_cfg(arch, layers=None):
    """``arch``'s configuration (its published fields checked,
    :func:`family_cfg`) at ``layers`` (default its trained depth), its
    tokens a sequence and its frontend input."""
    import dataclasses
    _, depth, _, _, seq, frontend = train4_row(arch)
    cfg, _, _ = family_cfg(arch)
    check(cfg.remat, f"grids-train: {arch} trains without remat")
    n = layers or depth
    if n is not None:
        cfg = dataclasses.replace(cfg, n_layers=n)
    return cfg, seq, frontend


def train4_phases():
    """(phase, grid) of every multi-card phase of ``--grids-train``."""
    out = []
    for arch, _, grids, held, _, frontend in TRAIN4_FAMILIES:
        n = train4_cfg(arch)[0].n_layers
        with_ = f", {frontend[1]} {frontend[0]}" if frontend else ""
        out += [(f"{arch} training, {n} layers{with_}", s) for s in grids]
        out += [(f"{arch} float32 gradients, {F32_TRAIN_LAYERS} layers", s)
                for s in grids]
        out += [(f"{arch} training, {held} layers against one card", s)
                for s in grids]
        out += [(f"{arch} private step, {held} layers", TRAIN4_PRIVATE_GRID)]
    return out


def train4_units(world: int):
    """(name, grid or None for rank 0 alone, function) of every unit of
    ``--grids-train``'s world, in order: family by family the float32
    gradients on one card and on each grid, three bf16 steps at the held
    depth on one card and on each grid, the private step at the held
    depth and the unsharded forward at the trained depth (each layer
    drawn when it is reached); then, last, the trained runs, whose peaks
    are the largest (an out-of-memory error ends the world)."""
    import functools
    p = functools.partial
    units, trained = [], []
    for arch, _, grids, held, _, _ in TRAIN4_FAMILIES:
        if any(math.prod(s) != world for s in grids):
            continue
        n = train4_cfg(arch)[0].n_layers
        units.append((f"{arch} float32 one card", None,
                      p(train4_f32, arch=arch)))
        units += [(f"{arch} float32 {s}", s, p(train4_f32, arch=arch))
                  for s in grids]
        units += [(f"{arch} {where}, {held} layers", s,
                   p(train4_steps, arch=arch, layers=held))
                  for where, s in [("one card", None)]
                  + [(str(s), s) for s in grids]]
        units.append((f"{arch} private {TRAIN4_PRIVATE_GRID}, {held} layers",
                      TRAIN4_PRIVATE_GRID, p(train4_private, arch=arch)))
        units.append((f"{arch} streamed step 0, {n} layers", None,
                      p(train4_streamed, arch=arch)))
        trained += [(f"{arch} {s}, {n} layers", s, p(train4_steps, arch=arch))
                    for s in grids]
    return units + trained


def train4_steps(torch, args, mesh, keep, arch, layers=None):
    """TRAIN4_STEPS bf16 steps of ``arch`` at ``layers`` (default its
    trained depth) on ``mesh`` or, without one, on this rank's card
    (:func:`mesh_train`): ``launch.train.main(mesh=)`` at the full
    configuration's depth for a family without a frontend input, else its
    loop (:func:`frontend_train`). Also records the lr each step should
    have (``schedule(step + 1)``) and the tokens a step."""
    from repro_torch.train import AdamWConfig
    from repro_torch.train.optim import schedule

    cfg, seq, frontend = train4_cfg(arch, layers)
    full = family_cfg(arch)[0].n_layers
    if mesh is not None and frontend is None and cfg.n_layers == full \
            and seq == TRAIN_SEQ:
        argv = ["--arch", arch, "--steps", str(TRAIN4_STEPS), "--batch",
                str(TRAIN_BATCH), "--seq", str(seq), "--lr", str(TRAIN_LR),
                "--log-every", "1", "--seed", str(args.seed)]
        out = mesh_train(torch, argv, mesh)
        out["route"] = "launch.train.main"
    else:
        out = mesh_train(torch, None, mesh, run=lambda on_step:
                         frontend_train(torch, args, cfg, TRAIN4_STEPS,
                                        frontend, on_step, mesh=mesh,
                                        seq=seq))
        out["route"] = "make_train_step (the launcher's loop)"
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=max(2, TRAIN4_STEPS // 10),
                      total_steps=TRAIN4_STEPS)
    out.update(layers=cfg.n_layers, tokens_a_step=TRAIN_BATCH * seq,
               positions_a_step=TRAIN_BATCH * (
                   seq + (frontend[1] if frontend else 0)),
               want_lrs=[float(schedule(opt, i + 1))
                         for i in range(TRAIN4_STEPS)])
    return out


def train4_streamed(torch, args, mesh, keep, arch):
    """Rank 0: step 0's loss at ``arch``'s trained depth, unsharded on this
    card, forward only (``no_grad``), each layer drawn when the block
    loop reaches it (:class:`DrawnLayers`: the bits of the grids' blocks)
    and dropped before the next, on the batch step 0 of the trained runs
    takes."""
    import dataclasses

    from repro_torch.data import make_lm_batches
    from repro_torch.data.pipeline import to_device
    from repro_torch.models import lm

    cfg, seq, frontend = train4_cfg(arch)
    params = lm.init_params(args.seed, dataclasses.replace(cfg, n_layers=0))
    dev = params["final_norm"].device
    params["blocks"] = DrawnLayers(args.seed, cfg, dev)
    stream = make_lm_batches(cfg, TRAIN_BATCH, seq, seed=args.seed)
    batch = to_device(train_batch(cfg, stream, 0, frontend, args.seed), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, _ = lm.train_loss(params, cfg, batch)
    loss = float(loss)
    out = {"layers": cfg.n_layers, "loss": loss,
           "layer_draws": params["blocks"].draws,
           "forward_s": time.perf_counter() - t0}
    del params, batch
    check(out["layer_draws"] == cfg.n_layers and math.isfinite(loss),
          f"grids-train {arch}: the streamed forward drew "
          f"{out['layer_draws']} of {cfg.n_layers} layers, loss {loss}")
    return out


def train4_f32(torch, args, mesh, keep, arch):
    """``arch`` at F32_TRAIN_LAYERS layers, full width, in float32: one
    step's loss and every leaf's gradient (``train.step._grads``) on
    F32_TRAIN_TOKENS tokens (with the family's frontend input, from
    :func:`train_batch`). Without ``mesh`` (rank 0, first) they are kept
    on the host; on ``mesh`` each gradient is gathered whole, one leaf at
    a time (every rank), and rank 0 holds it to the kept one -> the loss's
    relative difference, the worst leaf and its relative difference
    (norm of the difference over the norm)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import _tree, sharding
    from repro_torch.data import TokenStream
    from repro_torch.data.pipeline import to_device
    from repro_torch.models import lm
    from repro_torch.train import step as tstep

    check(not torch.backends.cuda.matmul.allow_tf32,
          "grids-train: TF32 matmuls are on; the float32 check needs them "
          "off")
    cfg, _, frontend = train4_cfg(arch)
    f32 = dataclasses.replace(cfg, n_layers=F32_TRAIN_LAYERS,
                              dtype="float32")
    b, t = F32_TRAIN_TOKENS
    batch = train_batch(f32, TokenStream(f32.vocab_size, b, t,
                                         seed=args.seed), 7, frontend,
                        args.seed)
    if mesh is None:
        keep.pop("f32", None)
    _free(torch)
    params = lm.init_params(args.seed, f32, mesh=mesh)
    names = [n for n, x in _tree.leaves_with_paths(params)
             if x.is_floating_point()]
    if mesh is None:
        dev = params["final_norm"].device
        dbatch = to_device(batch, dev)
    else:
        dev = sharding.mesh_device(mesh)
        dp = sharding.dp_entry(mesh)
        dbatch = to_device(batch, dev, mesh=mesh, specs={
            k: (dp,) + (None,) * (a.ndim - 1) for k, a in batch.items()})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = tstep._grads(f32, params, tstep._trainable(params), dbatch)
    loss = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                 else loss)
    out = {"layers": F32_TRAIN_LAYERS, "tokens": [b, t],
           "frontend": frontend, "loss": loss, "leaves": len(grads),
           "grads_s": time.perf_counter() - t0}
    del params, dbatch
    if mesh is None:
        keep["f32"] = (arch, loss, [None if g is None else g.cpu()
                                    for g in grads])
        del grads
        _free(torch)
        return out
    lead = dist.get_rank() == 0
    want = keep.get("f32", (None,)) if lead else (None,)
    rel = {}
    for i, name in enumerate(names):
        g = grads[i]
        whole = None if g is None else (
            g.full_tensor() if hasattr(g, "full_tensor") else g)
        grads[i] = None
        if lead and want[0] == arch:
            w = want[2][i]
            if whole is None or w is None:
                rel[name] = 0.0 if whole is None and w is None \
                    else math.inf
            else:
                w = w.to(dev)
                rel[name] = float((whole - w).norm()) / (
                    float(w.norm()) or 1.0)
            del w
        del whole
    del grads
    if lead:
        check(want[0] == arch, f"grids-train {arch}: no one-card float32 "
              "gradients to hold the grid's to")
        worst = max(rel, key=rel.get)
        out.update(one_card_loss=want[1],
                   loss_rel_diff=abs(loss - want[1]) / abs(want[1]),
                   worst_grad=worst, worst_grad_rel_err=rel[worst])
    _free(torch)
    return out


def train4_private(torch, args, mesh, keep, arch):
    """One private-embedding step of ``arch`` at its held depth on
    TRAIN4_PRIVATE_GRID (:func:`slice13_private`: one ``share_onehot`` and
    one ``ss_matmul`` on this rank's card over its vocabulary block of the
    table, each equal to its plain version; the opened rows the unsharded
    lookup's bit for bit); then, on rank 0, both kernels at a rank's
    shapes (M = TRAIN_BATCH x TRAIN_SEQ, K = V / 4, N = d) timed beside
    their plain versions and bounds (:func:`lookup_kernel_times`)."""
    import torch.distributed as dist

    from repro_torch import sharding
    cfg, _, _ = train4_cfg(arch, train4_row(arch)[3])
    tag = f"grids-train {arch} {tuple(mesh.shape)}"
    errs = collections.Counter()
    launches = slice13_private(torch, args, mesh, errs, cfg=cfg, tag=tag)
    out = {"layers": cfg.n_layers,
           "private_launches": {k: launches[k] for k in SLICE13_KERNELS}}
    if dist.get_rank() == 0:
        rows = cfg.vocab_size // math.prod(TRAIN4_PRIVATE_GRID)
        check(rows * math.prod(TRAIN4_PRIVATE_GRID) == cfg.vocab_size,
              f"{tag}: the vocabulary does not split evenly")
        out["kernels"] = lookup_kernel_times(
            torch, args.seed + 34, sharding.mesh_device(mesh), rows,
            cfg.d_model, errs, tag)
    out["private_errs"] = {k: v for k, v in errs.items() if v}
    return out


def train4_check(units, failed):
    """Hold ``--grids-train``'s units (by name, each its ranks' results,
    rank 0 first) to what the slice asks, recording each failure in
    ``failed`` -> the summary by family: for each trained run TRAIN4_STEPS
    finite losses with grad_norm > 0, each lr ``schedule(step + 1)`` and
    layer 0's block moved on every rank; step 0's loss within
    SLICE13_LOSS_RTOL of the streamed unsharded forward's; the float32
    loss within TRAIN4_F32_LOSS_RTOL and every gradient leaf within
    F32_TRAIN_TOL of one card's; the held depth's losses within
    SLICE13_LOSS_RTOL of one card's, step 0 included; two grids' trained
    losses within SLICE13_LOSS_RTOL of each other; the private step's
    kernels once each on every rank, equal to their plain versions."""
    out = {}

    def get(name):
        ranks = units.get(name, [])
        if not ranks or not ranks[0].get("losses", ranks[0].get("loss")):
            failed.setdefault(name, "did not run")
            return None
        return ranks

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]

    def steps_ok(name, r0, ranks):
        got = r0["losses"]
        ok = (len(got) == TRAIN4_STEPS
              and all(math.isfinite(x) for x in got)
              and all(g > 0 for g in r0["grad_norms"])
              and all(abs(a - b) <= 1e-6 * b for a, b in
                      zip(r0["lrs"], r0["want_lrs"]))
              and all(r.get("layer0_moved") for r in ranks))
        if not ok:
            failed[f"{name} steps"] = json.dumps(
                {k: r0.get(k) for k in ("losses", "grad_norms", "lrs",
                                        "want_lrs")}
                | {"layer0_moved": [r.get("layer0_moved") for r in ranks]})

    for arch, _, grids, held, seq, frontend in TRAIN4_FAMILIES:
        n = train4_cfg(arch)[0].n_layers
        fam = {"layers": n, "held_layers": held, "tokens_a_sequence": seq,
               "frontend": frontend, "grids": {}}
        streamed = get(f"{arch} streamed step 0, {n} layers")
        one32 = get(f"{arch} float32 one card")
        one = get(f"{arch} one card, {held} layers")
        trained = {}
        for s in grids:
            row = {}
            name = f"{arch} {s}, {n} layers"
            ranks = get(name)
            if ranks:
                r0 = ranks[0]
                steps_ok(name, r0, ranks)
                trained[s] = r0["losses"]
                ms = r0["ms_per_step"]
                row.update(
                    route=r0.get("route"), losses=r0["losses"],
                    ms_per_step=ms,
                    tokens_per_s=r0["tokens_a_step"] / (ms / 1e3),
                    positions_per_s=r0["positions_a_step"] / (ms / 1e3),
                    peak_gb_by_rank=[r.get("peak_gb") for r in ranks],
                    predicted_peak_gb=TRAIN4_PEAK_GB.get((arch, s)),
                    idle_share_rank0=r0["idle_share"],
                    device_ms_by_kind_rank0=r0["device_ms_by_kind"],
                    nccl_ms_by_kind_rank0=r0["nccl_ms_by_kind"],
                    profiled_step_ms=r0["profiled_step_ms"],
                    first_step_and_init_s=r0["first_step_and_init_s"],
                    seconds=r0.get("seconds"))
                if streamed:
                    want = streamed[0]["loss"]
                    d = rel([r0["losses"][0]], [want])[0]
                    row.update(streamed_step0_loss=want, step0_rel_diff=d)
                    if not d <= SLICE13_LOSS_RTOL:
                        failed[f"{name} step 0"] = (
                            f"{r0['losses'][0]} against the streamed "
                            f"unsharded {want} (rtol {SLICE13_LOSS_RTOL})")
            g32 = get(f"{arch} float32 {s}")
            if g32 and one32:
                f = g32[0]
                row["float32"] = {k: f.get(k) for k in (
                    "loss", "one_card_loss", "loss_rel_diff", "worst_grad",
                    "worst_grad_rel_err", "leaves")}
                if not (f.get("loss_rel_diff", math.inf)
                        <= TRAIN4_F32_LOSS_RTOL
                        and f.get("worst_grad_rel_err", math.inf)
                        <= F32_TRAIN_TOL):
                    failed[f"{arch} float32 {s}"] = json.dumps(
                        row["float32"])
            hname = f"{arch} {s}, {held} layers"
            hg = get(hname)
            if hg and one:
                steps_ok(hname, hg[0], hg)
                d = rel(hg[0]["losses"], one[0]["losses"])
                row["held"] = {"losses": hg[0]["losses"],
                               "one_card_losses": one[0]["losses"],
                               "loss_rel_diff": d,
                               "ms_per_step": hg[0]["ms_per_step"],
                               "one_card_ms_per_step":
                                   one[0]["ms_per_step"],
                               "peak_gb_by_rank": [r.get("peak_gb")
                                                   for r in hg],
                               "one_card_peak_gb": one[0].get("peak_gb")}
                if len(d) != TRAIN4_STEPS or max(d) > SLICE13_LOSS_RTOL:
                    failed[f"{hname} against one card"] = json.dumps(
                        row["held"])
            fam["grids"][str(s)] = row
        if one:
            steps_ok(f"{arch} one card, {held} layers", one[0], one)
        if len(trained) == 2:
            a, b = trained.values()
            d = rel(a, b)
            fam["grids_loss_rel_diff"] = d
            if len(d) != TRAIN4_STEPS or max(d) > SLICE13_LOSS_RTOL:
                failed[f"{arch} grids against each other"] = json.dumps(
                    {str(k): v for k, v in trained.items()})
        pname = f"{arch} private {TRAIN4_PRIVATE_GRID}, {held} layers"
        priv = units.get(pname, [])
        fam["private_launches_by_rank"] = [r.get("private_launches")
                                           for r in priv]
        if len(priv) != math.prod(TRAIN4_PRIVATE_GRID) or any(
                r.get("private_launches") != {k: 1 for k in SLICE13_KERNELS}
                or r.get("private_errs") for r in priv):
            failed.setdefault(pname, json.dumps(
                [{k: r.get(k) for k in ("private_launches", "private_errs")}
                 for r in priv]))
        if priv:
            fam["kernels"] = priv[0].get("kernels")
        if streamed:
            fam["streamed_forward_s"] = streamed[0].get("forward_s")
        out[arch] = fam
    return out


def grids_train_path(torch, args) -> int:
    """``--grids-train``: TRAIN4_FAMILIES trained across the four cards of
    one host. One world of TRAIN4_WORLD ranks (:func:`spawn_ranks`, each
    :func:`rank_main`: ``init_ranks``, NCCL) runs :func:`grids_rank` over
    :func:`train4_units` within TRAIN4_DEADLINE_S, each rank writing its
    results to ``build/grids/train4/rank<r>.json`` after each unit; then
    :func:`train4_check` holds them. Every failure is gathered and the run
    fails at its end; a host with fewer cards fails at once."""
    import shutil

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    card = smi("name,power.limit")
    log(f"grids-train: {cards} cards ({card}), a world of {TRAIN4_WORLD} "
        "ranks")
    log_grids_not_run(cards, "--grids-train")
    check(cards >= TRAIN4_WORLD, f"--grids-train needs {TRAIN4_WORLD} "
          f"cards; this host has {cards}")
    failed, units = {}, {}
    out_dir = os.path.join(ROOT, "build", "grids", "train4")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = TRAIN4_ALLOC_CONF  # the ranks'
    try:
        spawn_ranks(TRAIN4_WORLD, grids_rank, args.seed, out_dir,
                    train4_units, deadline_s=TRAIN4_DEADLINE_S)
    except Exception as e:                   # a rank's error: reported
        failed[f"world of {TRAIN4_WORLD}"] = repr(e)
    finally:
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    res = []
    for r in range(TRAIN4_WORLD):
        path = os.path.join(out_dir, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                res.append(json.load(f))
    for r in res:
        failed.update({f"rank {r['rank']} {k}": v
                       for k, v in r["failed"].items()})
        for name, v in r["units"].items():
            units.setdefault(name, []).append(v)
    world_s = time.perf_counter() - t0
    log(f"grids-train world of {TRAIN4_WORLD} ranks took {world_s:.1f} s; "
        f"every rank ran every unit: "
        f"{len(res) == TRAIN4_WORLD and all(r['done'] for r in res)}")
    families = train4_check(units, failed)
    log("grids-train summary " + json.dumps({
        "card": card, "cards": cards, "families": families,
        "failed": failed, "seconds": time.perf_counter() - t0},
        default=str))
    check(not failed, f"--grids-train: {len(failed)} checks failed: "
          + json.dumps(failed, default=str))
    return 0


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
    ap.add_argument("--mesh-only", action="store_true",
                    help="only build the kernels, run slice 10's t1, "
                         "slice 13 (the production-mesh path), slice 14 "
                         "(the MoE family on it) and slice 15 (serving on "
                         "it), and print their summaries")
    ap.add_argument("--grids", action="store_true",
                    help="only build the kernels and run the multi-card "
                         "phases: the production mesh's training, "
                         "checkpoints and serving on NCCL ranks over 2 and "
                         "4 cards, the collectives against the walker, and "
                         "MeshDispatcher over distinct cards (a host with 4 "
                         "or more cards runs them all)")
    ap.add_argument("--grids-train", action="store_true",
                    help="only build the kernels and train the families "
                         "whose training state no card holds (ChatGLM3-6B, "
                         "Moonlight, InternVL2-76B) across four cards of "
                         "this host on NCCL ranks, each held to one card "
                         "where one holds it")
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
    if args.grids or args.grids_train:
        (grids_train_path if args.grids_train else grids_path)(torch, args)
        print(smi("name,power.limit"), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.mesh_only:
        t1 = train_t1(torch, args, train_cfg(torch))
        _free(torch)
        launches = slice13_path(torch, args, errs, t1["losses"])
        _free(torch)
        launches14 = slice14_path(torch, args, errs)
        _free(torch)
        launches15 = slice15_path(torch, args, errs)
        print(json.dumps({"slice13_launches": launches,
                          "slice14_launches": launches14,
                          "slice15_launches": launches15, "errs": errs}))
        return 0
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
    gc.collect()
    torch.cuda.empty_cache()
    path23 = slice23_path(torch, args, errs)
    log("slice-23 path: Gemma3-1B, MiniCPM3-4B, Mamba2-2.7B, Hymba-1.5B "
        "and SeamlessM4T-medium train at full width and depth, each "
        "float32 step equal to the CPU's and each private step's kernels "
        "equal to their plain versions")
    log("slice-12 summary " + json.dumps({
        "seconds": sum(r["seconds"] for r in SLICE12),
        "measured_over_roofline": {r["step"]: r["measured_over_roofline"]
                                   for r in SLICE12},
        "predicted_over_measured_peak": {
            r["step"]: (r["predicted_peak_gb"] / r["measured_peak_gb"]
                        if r["measured_peak_gb"] else None)
            for r in SLICE12}}))
    check(len(SLICE12) == 3, f"slice 12 priced {len(SLICE12)} steps, not 3")
    gc.collect()
    torch.cuda.empty_cache()
    path13 = slice13_path(torch, args, errs, SLICE10_T1_LOSSES)
    log("slice-13 path: full-width steps on a (1, 1) NCCL mesh match "
        "slice 10's, the private lookup runs its kernels on each rank's "
        "blocks, checkpoints cross grids and the walker prices the mesh "
        "step as the unsharded one")
    gc.collect()
    torch.cuda.empty_cache()
    path14 = slice14_path(torch, args, errs)
    log("slice-14 path: full-width Granite-3.0-3B-A800M steps on a (1, 1) "
        "NCCL mesh match the unsharded ones with both MoE dispatches, and "
        "the private step runs its kernels on each rank's blocks")
    gc.collect()
    torch.cuda.empty_cache()
    path15 = slice15_path(torch, args, errs)
    log("slice-15 path: full ChatGLM3-6B and Gemma3-1B generate the same "
        "tokens privately and in plaintext, and ChatGLM3-6B the same on a "
        "(1, 1) NCCL mesh")
    log_grids_not_run(torch.cuda.device_count())
    for entry in kernels:
        name = entry["name"].split("[")[0]
        entry["launches"] += sum(p.get(name, 0) for p in (
            path7, path8, path9, path10, path13, path14, path15,
            path23))
        entry["max_abs_err"] = max(entry["max_abs_err"], errs[name])

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
