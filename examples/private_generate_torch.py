"""Private-embedding decode loop on the PyTorch/CUDA port.

The same walk-through as ``examples/private_generate.py``, through
``repro_torch`` (no JAX): a small decoder LM generates autoregressively
while every token-embedding lookup runs as the paper's §3.2.1 oblivious
selection through the query engine. The embedding table lives only as
Shamir shares (one slice per cloud), attached to a ``QueryClient`` as a
vocab-sharded relation under ``MeshDispatcher``, and each decode step
issues ONE ``EmbedLookup`` plan: one ``share_onehot`` launch and one
``ss_matmul`` launch per shard. The opened embeddings feed
``decode_step`` through the ``batch["embeds"]`` seam.

Reported per run: tokens/s of the batched private path, the per-call
baseline (one ``private_lookup`` per token), per-token communication bits
from the measured ledgers, and the dispatches per step.

  PYTHONPATH=src python examples/private_generate_torch.py            # GPU
  PYTHONPATH=src python examples/private_generate_torch.py --device cpu
  PYTHONPATH=src python examples/private_generate_torch.py --shards 4 \\
      --verify
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import _device  # noqa: E402
from repro_torch.api import (EmbedLookup, MeshDispatcher,  # noqa: E402
                             QueryClient)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import private_embed as pe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

CFG = ModelConfig(name="private-tiny", family="dense", n_layers=2,
                  d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
                  vocab_size=2048, dtype="float32")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--verify", action="store_true",
                    help="consistency check on every opened embedding")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()
    cfg = CFG
    dev = _device.resolve(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    params = lm.init_params((0, 1), cfg, device=dev)

    # -- the DB-owner step: quantize + share the table, attach as a relation
    table_sh = pe.setup_private_embed((0, 2), params["embed"], n_shares=4,
                                      device=dev)
    client = QueryClient(seed=7, device=dev)
    plane = client.attach(pe.as_embed_relation(table_sh), name="embeddings",
                          shards=args.shards,
                          dispatcher=MeshDispatcher([dev]))

    def lookup(tokens: np.ndarray):
        """One decode step's embeddings via ONE EmbedLookup plan."""
        res = client.run(EmbedLookup(tokens=tokens.reshape(-1),
                                     verify=args.verify),
                         relation="embeddings")
        emb = torch.from_numpy(res.embeddings).to(dev)
        return emb.reshape(*tokens.shape, cfg.d_model), res.ledger

    # -- prefill: the whole prompt is one batched lookup ---------------------
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size,
                          (args.batch, args.prompt_len)).astype(np.int64)
    embeds, _ = lookup(prompt)
    logits, cache = lm.prefill(params, cfg,
                               {"tokens": prompt, "embeds": embeds},
                               max_len=args.prompt_len + args.steps)
    tok = torch.argmax(logits[:, -1], dim=-1)

    # -- decode loop: one EmbedLookup == one ss_matmul dispatch per shard ---
    out_tokens = [tok.cpu().numpy()]
    ledgers, t0 = [], time.perf_counter()
    d0 = plane.stats.dispatches
    for step in range(args.steps):
        embeds, ledger = lookup(out_tokens[-1][:, None])
        ledgers.append(ledger)
        logits, cache = lm.decode_step(
            params, cfg, cache, args.prompt_len + step,
            {"tokens": tok[:, None], "embeds": embeds})
        tok = torch.argmax(logits[:, -1], dim=-1)
        out_tokens.append(tok.cpu().numpy())
    sync()
    dt = time.perf_counter() - t0
    n_tok = args.steps * args.batch
    per_step = (plane.stats.dispatches - d0) / max(args.steps, 1)
    bits = sum(led.communication_bits for led in ledgers)

    # -- per-call baseline: one private_lookup per token ---------------------
    base_toks = out_tokens[0]
    t0 = time.perf_counter()
    for i, t in enumerate(base_toks):
        pe.private_lookup((0, 100 + i), table_sh, [int(t)])
    sync()
    base_dt = (time.perf_counter() - t0) / len(base_toks)

    print(f"[private_generate_torch] {args.batch}x{args.steps} tokens "
          f"decoded on {dev}, S={args.shards}, verify={args.verify}")
    print(f"  batched private path : {n_tok / dt:8.1f} tok/s "
          f"(full decode step incl. transformer)")
    print(f"  per-call baseline    : {1.0 / base_dt:8.1f} tok/s "
          f"(embedding lookups alone)")
    print(f"  per-token comm       : {bits / n_tok:8.0f} bits")
    print(f"  dispatches per step  : {per_step:.1f} "
          f"(= shard count; ONE fused ss_matmul each)")
    sample = np.stack(out_tokens)[:, 0]
    print(f"  sample continuation  : {sample.tolist()}")


if __name__ == "__main__":
    main()
