"""Private serving on the PyTorch/CUDA port: batched LM inference whose
embedding lookup runs as the paper's oblivious selection (§3.2.1) over
Shamir-shared tables, plus a multi-tenant oblivious ``QueryServer``
draining logical query plans over two secret-shared relations (user
profiles + orders) through one scheduler.

The same walk-through as ``examples/private_serving.py``, through
``repro_torch`` (no JAX). The serving clouds hold only shares of the
fixed-point embedding table; each request's token ids are one-hot-encoded,
secret-shared with fresh polynomials, and the lookup is a share-space
matmul (``share_onehot`` + ``ss_matmul`` kernels on a GPU): the clouds see
neither the token id nor the embedding row.

  PYTHONPATH=src python examples/private_serving_torch.py               # GPU
  PYTHONPATH=src python examples/private_serving_torch.py --device cpu
"""
import argparse
import dataclasses
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch import _device  # noqa: E402
from repro_torch.api import Count, Eq, Select  # noqa: E402
from repro_torch.core import Codec, outsource  # noqa: E402
from repro_torch.core.queries.embed import (  # noqa: E402
    dequantize_from_field, quantize_to_field)
from repro_torch.launch.serve import (BatchServer, QueryServer,  # noqa: E402
                                      Request)
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.private_embed import (  # noqa: E402
    private_lookup, setup_private_embed)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    dev = _device.resolve(ap.parse_args().device)
    cfg = configs.smoke("qwen1_5_4b")
    params = init_params(0, cfg, device=dev)

    # --- DB-owner side: share the embedding table once -----------------
    shares = setup_private_embed(1, params["embed"], n_shares=4, device=dev)
    params["embed_shares"] = shares.values
    print(f"embedding table ({cfg.vocab_size}x{cfg.d_model}) shared to "
          f"{shares.n_shares} clouds (degree {shares.degree}) on {dev}")

    # --- sanity: private lookup == plaintext lookup (to 2^-12) ---------
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(8,))
    priv = private_lookup(2, shares, toks).cpu().numpy()
    plain = params["embed"].float().cpu().numpy()[toks]
    err = np.abs(priv - plain).max()
    print(f"private lookup max err vs plaintext: {err:.2e} (<= 2^-13, "
          f"half a 2^-12 quantization step)")

    # --- serve a batch of requests with the private embedding on -------
    cfg_priv = dataclasses.replace(cfg, private_embed=True)
    server = BatchServer(params, cfg_priv, max_len=64, device=dev)
    rng = np.random.default_rng(1)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, size=16,
                                        dtype=np.int32), max_new=8)
            for _ in range(4)]
    done = server.serve(reqs)
    for i, r in enumerate(done):
        print(f"req{i}: prompt[:4]={r.prompt[:4]}... -> {r.out} "
              f"({r.latency_s:.2f}s batch)")

    # --- outputs must match the plaintext server over the table the -----
    # --- clouds hold (the dequantized quantized one) --------------------
    plain_params = {k: v for k, v in params.items() if k != "embed_shares"}
    plain_params["embed"] = dequantize_from_field(quantize_to_field(
        params["embed"], device=dev)).to(params["embed"].dtype)
    server_plain = BatchServer(plain_params, cfg, max_len=64, device=dev)
    done2 = server_plain.serve([Request(prompt=r.prompt.copy(), max_new=8)
                                for r in done])
    same = all(np.array_equal(a.out, b.out) for a, b in zip(done, done2))
    print(f"private == plaintext generations: {same}")
    assert same

    # --- the same clouds also serve oblivious DB queries ----------------
    # The owner shares a *database* — plural relations — once (§2); one
    # multi-tenant QueryServer then fronts all of them: each attach() gets
    # its own dataplane, batching policy and query-key stream, while every
    # relation's shard dispatches ride ONE bounded server pool.
    profiles = [["u01", "gold", "150"], ["u02", "free", "12"],
                ["u03", "gold", "87"], ["u04", "silver", "45"]]
    orders = [["o1", "u01", "open"], ["o2", "u03", "done"],
              ["o3", "u01", "open"], ["o4", "u02", "open"],
              ["o5", "u04", "done"], ["o6", "u01", "done"]]
    # word_length 6 -> match degree (1+1)·6 = 12, openable by 16 clouds
    codec = Codec(word_length=6)
    db_profiles = outsource(profiles, n_shares=16,
                            column_names=["UserId", "Tier", "Requests"],
                            codec=codec, seed=5, device=dev)
    db_orders = outsource(orders, n_shares=16,
                          column_names=["OrderId", "UserId", "Status"],
                          codec=codec, seed=6, device=dev)
    qserver = QueryServer(max_batch=8, max_wait_ms=10, pool_workers=4,
                          device=dev)
    qserver.attach("profiles", db_profiles, shards=2, key=11)
    qserver.attach("orders", db_orders, shards=3, key=12, max_batch=4)
    with qserver:
        queries = [
            qserver.submit(Count(Eq("Tier", "gold")), relation="profiles"),
            qserver.submit(Select(Eq("Tier", "gold")), relation="profiles"),
            qserver.submit(Count(Eq("Status", "open")), relation="orders"),
            qserver.submit(Select(Eq("UserId", "u01"),
                                  strategy="one_round"), relation="orders"),
        ]
        for q in queries:
            q.wait(timeout=120)
    for q in queries:
        print(f"[{q.relation}] {type(q.plan).__name__}: "
              f"strategy={q.result.strategy} count={q.result.count} "
              f"({q.latency_s:.2f}s, {q.result.ledger.rounds} rounds)")
    st = qserver.stats.snapshot()
    print(f"server: {st['served']} queries in {st['batches']} batch(es) "
          f"(closed by {st['closes']}), "
          f"mean batch {st['mean_batch_size']:.1f}, "
          f"p50 queue wait {st['p50_queue_wait_s'] * 1e3:.1f}ms, "
          f"p50 latency {st['p50_latency_s']:.2f}s")
    for name, rs in st["relations"].items():
        print(f"  [{name}] served={rs['served']} in {rs['batches']} "
              f"batch(es), families={rs['served_by_family']}")

    # --- self-tuning overload: unequal weights under a 10x storm ---------
    # The "hot" tenant floods at ~10x the protected neighbour's rate;
    # deadline steering dives its wait toward immediate closes while the
    # neighbour's stays at its configured cap, and the weighted quota keeps
    # the neighbour's shard dispatches from queueing behind the flood.
    storm = QueryServer(pool_workers=4, device=dev)
    storm.attach("hot", db_orders, shards=2, key=13,
                 max_batch=4, max_wait_ms=20, weight=1.0)
    storm.attach("steady", db_profiles, shards=2, key=14,
                 max_batch=4, max_wait_ms=20, weight=2.0)
    hot_plan = Count(Eq("Status", "open"))
    steady_plan = Count(Eq("Tier", "gold"))
    reqs_by_rel = {"hot": [], "steady": []}

    def pound(rel, plan, period_s, dur_s):
        t_end = time.time() + dur_s
        while time.time() < t_end:
            reqs_by_rel[rel].append(storm.submit(plan, relation=rel))
            time.sleep(period_s)

    with storm:
        threads = [
            threading.Thread(target=pound,
                             args=("hot", hot_plan, 0.004, 1.5)),
            threading.Thread(target=pound,
                             args=("steady", steady_plan, 0.04, 1.5)),
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        for rs in reqs_by_rel.values():
            for r in rs:
                r.wait(timeout=120)
    snap = storm.stats.snapshot()["relations"]
    for name in ("hot", "steady"):
        rs = snap[name]
        print(f"  storm[{name}]: served={rs['served']} "
              f"closes={rs['closes']} "
              f"steered_wait={rs['steered_wait_ms']:.2f}ms "
              f"(configured 20ms)")
    assert snap["hot"]["steered_wait_ms"] < snap["steady"]["steered_wait_ms"]
    print("  steering diverged: the flooding tenant dives to immediate "
          "closes, the weighted neighbour keeps a longer deadline")


if __name__ == "__main__":
    main()
