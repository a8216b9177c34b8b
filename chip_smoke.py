#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--tuples 131072] [--seed 0]

Phases, any failure exits non-zero:

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   (one process per source, in parallel).
2. Hold each kernel against its plain PyTorch version, bit for bit, on
   random shares with p−1 extremes and ragged shapes (M = 0, N = 0, a
   K split across blocks, broadcast columns with B-stride 0, row blocks).
3. Drive the main path through the public entry points at full size: the
   README's Employee schema (5 string attributes, word length 8, A = 69,
   degree 1, c = 20 clouds) over ``--tuples`` synthetic rows made from
   ``--seed`` — 28.9 GB of int32 shares at 131,072 tuples. ``outsource``,
   ``count``, ``select`` forced to one_tuple / one_round / tree and AUTO,
   and one ``run_batch`` of 8 mixed plans; every count, address list and
   row is checked against a plaintext evaluation of the rows, and both
   kernels' launch counters must have risen during this phase.
4. Hold every call form the path uses against its plain version again at
   the path's full shapes, through the same ``ops`` wrappers the path
   calls: the one-column count stack, the distinct-column count and a tree
   round's 16 row blocks (``aa_match_rows``), the fetch and the one_tuple
   contraction; time kernel and plain version there (CUDA events).

Prints the kernels JSON line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``. Needs no JAX and no network.
"""
from __future__ import annotations

import argparse
import json
import os
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
    ℓ = 0 (Nobody); EmployeeId is unique."""
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
    rows[:, 3] = [str(v) for v in rng.integers(1000, 99999, n)]
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


def main_path(torch, args, expect_strategy):
    """Phase 3: the full-size main path through the public entry points."""
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
                   codec=Codec(word_length=8), degree=1, seed=args.seed)
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
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"main path launches {launches}; host seconds "
        + json.dumps({k: round(v, 4) for k, v in timings.items()}))
    for name, k in launches.items():
        check(k > 0, f"kernel {name} was not launched on the main path")
    return db, launches


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
    tree_ms = time_ms(torch, lambda: ops.aa_match_rows(rel, **tree), 10)
    log(f"aa_match_rows tree round {len(bounds)} x {tree['height']}: "
        f"{tree_ms} ms")
    aa_ms = time_ms(torch, lambda: ops.aa_match_batch(col, pat), 20)
    aa_plain_ms = time_ms(torch, lambda: aa.aa_match_batch_plain(col, pat),
                          2)
    aa_bytes = 4 * (c * n * w * a + c * w * a + c * n)
    aa_ops = 2 * c * n * w * a + c * n * (w - 1)

    flat = rel.reshape(c, n, m * w * a)                # fetch: (c,R,n)@...
    onehot = rounds._share_one_hot(key, db, list(range(0, n, n // 3))[:3])
    fetch = onehot.values
    got, want = ops.ss_matmul(fetch, flat), ssm.ss_matmul_plain(fetch, flat)
    check(torch.equal(got, want), "ss_matmul full fetch shape differs")
    errs["ss_matmul"] = max(errs["ss_matmul"], max_err(torch, got, want))
    bits = rand_field(torch,                           # one_tuple: (c,1,n)
                      torch.Generator(device=rel.device).manual_seed(7),
                      (c, 1, n), rel.device)
    check(torch.equal(ops.ss_matmul(bits, flat),
                      ssm.ss_matmul_plain(bits, flat)),
          "ss_matmul one_tuple shape differs")
    ss_ms = time_ms(torch, lambda: ops.ss_matmul(fetch, flat), 10)
    ss_plain_ms = time_ms(torch, lambda: ssm.ss_matmul_plain(fetch, flat), 2,
                          warmup=0)
    r = fetch.shape[1]
    ss_bytes = 4 * (c * r * n + c * n * m * w * a + c * r * m * w * a)
    ss_ops = 2 * c * r * n * m * w * a

    def entry(name, source, replaces, ms, plain_ms, nbytes, nops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / INT32_OPS_PER_S * 1e3
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None}

    return [entry("aa_match_batch", "src/repro_torch/kernels/csrc/aa_match.cu",
                  "src/repro/kernels/aa_match.py:81", aa_ms, aa_plain_ms,
                  aa_bytes, aa_ops),
            entry("ss_matmul", "src/repro_torch/kernels/csrc/ss_matmul.cu",
                  "src/repro/kernels/ss_matmul.py:87", ss_ms, ss_plain_ms,
                  ss_bytes, ss_ops)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tuples", type=int, default=131072)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.api import planner
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"built kernels in {time.perf_counter() - t0:.1f} s")
    for name, info in _build.BUILD_INFO.items():
        log(f"[{name}] nvcc {info['seconds']:.1f} s\n{info['log'].strip()}")

    dev = torch.device("cuda")
    errs = {"aa_match_batch": 0, "ss_matmul": 0}
    compare_small(torch, dev, errs)
    log("kernels == plain versions on extremes and ragged shapes")

    def expect_strategy(client, ell):
        return planner.choose_select_strategy(client.stats(),
                                              ell=ell).strategy

    db, launches = main_path(torch, args, expect_strategy)
    log("main path: every answer equals the plaintext evaluation")
    kernels = full_shape_kernels(torch, db, errs, launches)
    log("kernels == plain versions at the main path's full shapes")

    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
