"""Private generation: batches served back to back through the program's
``BatchServer``, and the check of the served tokens and of the private
lookup's rows against the configuration's plain reference.

Set-up draws the weights on the device from the seed (the configuration's
``make_weights``), shares the embedding table for the private lookup
(``repro_torch.models.private_embed.setup_private_embed``) and serves one
short batch at each prompt length of the mix. The window serves batches
back to back; it runs from the first batch's start to the end of the
last batch that started before ``seconds`` ran out, so it holds no
partial batch.

The check: the lookup rows of the batches drawn beforehand from the seed
(kept by a wrapper around ``private_lookup_inline``, which the model
calls for every lookup) must equal the reference's quantized rows
exactly, and must be all the rows those batches look up, or the number
reads None; and over a sample of the finished requests drawn from the
seed, with the longest among them, the reference's float32 forward over
each prompt with its served tokens gives the widest gap by which a
served token's logit lies below the best.
"""
from __future__ import annotations

import contextlib
import sys
from types import SimpleNamespace
from typing import List

import numpy as np

from . import traffic as tr
from .trace import Tracer

SAMPLE, CAPTURE = 31, 32         # streams of the seed


@contextlib.contextmanager
def captured_lookups(keep):
    """Keeps (tokens, rows) of every private lookup while ``keep()`` is
    true; the model looks ``private_lookup_inline`` up at each call."""
    from repro_torch.models import private_embed as pe
    original = pe.private_lookup_inline
    kept = []

    def lookup(params, cfg, tokens, **kw):
        out = original(params, cfg, tokens, **kw)
        if keep():
            kept.append((tokens, out))
        return out

    pe.private_lookup_inline = lookup
    try:
        yield kept
    finally:
        pe.private_lookup_inline = original


def program_setup(ref, sizes: dict, seed: int, device, max_len: int):
    """The benchmark's weights, and the program's server over them with the
    table shared for the private lookup."""
    from repro_torch.launch import BatchServer
    from repro_torch.models import private_embed as pe
    from repro_torch.models.config import ModelConfig
    weights = ref.make_weights(sizes, seed, device)
    cfg = ModelConfig(**ref.program_config(sizes), private_embed=True)
    lookup = sizes["private_embed"]
    table = pe.setup_private_embed((seed, 1), weights["embed"],
                                   n_shares=lookup["clouds"],
                                   degree=lookup["degree"], device=device)
    params = dict(weights, embed_shares=table.values, embed_key=(seed, 2))
    return weights, BatchServer(params, cfg, max_len=max_len, device=device)


def serve_batch(server, prompts: np.ndarray, news: List[int]) -> List:
    """Each request's served tokens, None for one that came back
    without its own number of new tokens."""
    from repro_torch.launch import Request
    reqs = [Request(prompt=p, max_new=n) for p, n in zip(prompts, news)]
    server.serve(reqs)
    return [r.out if r.out is not None and len(r.out) == n else None
            for r, n in zip(reqs, news)]


def lookup_rows(prompts: np.ndarray, news: List[int]) -> int:
    """The rows one batch looks up: its prompts', then the batch's for
    each decode step."""
    b, t = prompts.shape
    return b * t + b * (max(news) - 1)


def sample(done: list, k: int, seed: int) -> List[int]:
    """``k`` finished requests drawn from the seed, with the longest."""
    if not done:
        return []
    pick = np.random.default_rng([seed, SAMPLE])
    chosen = [int(i) for i in pick.choice(len(done), min(k, len(done)),
                                          replace=False)]
    longest = max(range(len(done)),
                  key=lambda i: len(done[i][0]) + len(done[i][1]))
    if longest not in chosen:
        chosen[-1] = longest
    return chosen


def reference_gaps(ref, weights, sizes, done, chosen, control=False):
    """The widest gap of a sampled request's served token below the
    float32 reference's best logit; with ``control``, also the widest gap
    of the token that the reference computed in float8 puts first."""
    import torch
    dev = weights["embed"].device
    widest, low = 0.0, (0.0 if control else None)
    for i in chosen:
        prompt, out = done[i]
        seq = torch.as_tensor(np.concatenate([prompt, out[:-1]])[None],
                              dtype=torch.int64, device=dev)
        logits = ref.logits_at(weights, sizes, seq, len(prompt) - 1)
        widest = max(widest, float(ref.gaps(
            logits, torch.as_tensor(out[None], device=dev)).max()))
        if control:
            first = ref.logits_at(weights, sizes, seq, len(prompt) - 1,
                                  precision="fp8").argmax(-1)
            low = max(low, float(ref.gaps(logits, first).max()))
    return widest, low


def run(cell, seed: int, seconds: float, trace: bool, device, smoke: bool,
        clock, control: bool = False):
    """One run; with ``control``, the reference computed in float8 takes
    the served tokens' place in the gap (the run's own gap stays beside
    it under ``program``)."""
    import torch

    ref = cell.reference
    sizes = cell.sizes(smoke)
    dims = ref.dims(sizes)
    mix = tr.GenerationMix(cell.mix(smoke), dims["v"], seed)
    weights, server = program_setup(ref, sizes, seed, device, mix.max_len)
    # every prompt length's prefill, and a decode step
    for i in range(len(mix.prompt_lens)):
        prompts, _ = mix.batch_at(i, warmup=True)
        serve_batch(server, prompts, [2] * len(prompts))
    rng = np.random.default_rng([seed, CAPTURE])
    capture = {0} | {1 + int(i) for i in rng.integers(
        0, 3, cell.mix(smoke)["capture_batches"] - 1)}
    served = []
    with captured_lookups(lambda: len(served) in capture) as kept, \
            Tracer(trace) as tracer:
        if device != "cpu":
            torch.cuda.synchronize()
        with tracer.span():
            t_start = clock()
            while not served or clock() - t_start < seconds:
                prompts, news = mix.batch_at(len(served))
                served.append((prompts, news,
                               serve_batch(server, prompts, news)))
            t_end = clock()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    del server
    if device != "cpu":
        torch.cuda.empty_cache()

    t_check = clock()
    wrong_rows = 0
    scale = sizes["private_embed"]["quant_scale"]
    dt = getattr(torch, dims["dtype"])
    for tokens, rows in kept:
        ids = torch.as_tensor(tokens).reshape(-1).to(weights["embed"].device)
        want = ref.quantized_rows(weights["embed"], ids, scale).to(dt)
        got = rows.reshape(want.shape)
        wrong_rows += int((got != want).any(-1).sum())
    seen = sum(int(torch.as_tensor(tokens).numel()) for tokens, _ in kept)
    due = sum(lookup_rows(p, n) for i, (p, n, _) in enumerate(served)
              if i in capture)
    if seen != due:                 # a lookup the wrapper did not see
        print(f"the lookup wrapper kept {seen} rows of {due}",
              file=sys.stderr)
        wrong_rows = None
    del kept
    done = [(p, out) for prompts, _, outs in served
            for p, out in zip(prompts, outs) if out is not None]
    n_req = sum(len(news) for _, news, _ in served)
    chosen = sample(done, cell.mix(smoke)["check_requests"], seed)
    gap = low = None                      # no request came back whole
    if chosen:
        gap, low = reference_gaps(ref, weights, sizes, done, chosen,
                                  control)
    window_s = t_end - t_start
    print(f"the check took {clock() - t_check:.2f} s", file=sys.stderr)
    record = SimpleNamespace(
        kind="generation", dims=dims, window_s=window_s,
        trace=tracer.summary,
        batches=[(p.shape[1], n) for p, n, _ in served])
    compared = {"missing_requests": n_req - len(done),
                "lookup_rows_wrong": wrong_rows, "gap_max": gap}
    out = dict(
        attempted=n_req, failed=n_req - len(done), first_request=t_start,
        memory_peak_bytes=peak,
        end_to_end={"gen_tokens_per_s":
                    sum(len(o) for _, o in done) / window_s},
        compared=compared, record=record)
    if control:
        out["control"] = dict(compared, gap_max=low)
    return out
