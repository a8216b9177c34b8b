"""Phase-4 kernel calls of ``chip_smoke.py`` and their ``PERF.md`` §6 bounds.

One call of each kernel entry point at the main paths' full shapes (the
Employee relation: c = 20 clouds, n = 131,072 tuples, m = 5 attributes,
W = 8, A = 69; the embedding table at Qwen1.5-4B width), each with the
"Bound ms" of its row in ``PERF.md`` §6. ``make(shape, dtype)`` builds
the operands on a device (meta on the CPU; zeros on a card).
"""
from __future__ import annotations

import torch

C, N, M, W, A = 20, 131072, 5, 8, 69
FIRST = 1                       # FirstName
VOCAB, ROWS, CLOUDS = 151936, 256, 4
BITS = 13                       # Salary in binary


def phase4_calls(make):
    """-> [(label, entry name in ``kernels.ops``, args, kwargs, kernel,
    bound ms)]."""
    rel = make((C, N, M, W, A), torch.int32)
    col = rel[:, :, FIRST][:, None]                      # (c, 1, n, W, A)
    pat = make((C, 1, W, A), torch.int32)
    pat8 = make((C, 8, W, A), torch.int32)
    flat = rel.reshape(C, N, M * W * A)
    height = N // 16
    tree = dict(columns=[FIRST] * 16, starts=[i * height for i in range(16)],
                lengths=[height] * 16, pat=pat.expand(C, 16, W, A),
                height=height)
    planes = make((C, 2, N, BITS), torch.int32)
    carry = make((C, 2, N), torch.int32)
    return [
        ("count stack", "aa_match_batch", (col, pat), {}, "aa_match_batch",
         1.731),
        ("one-column stack of 8", "aa_match_batch",
         (col.expand(C, 8, N, W, A), pat8), {}, "aa_match_batch", 1.753),
        ("tree round", "aa_match_rows", (rel,), tree, "aa_match_batch",
         1.731),
        ("suffix k=2", "aa_slide_batch",
         (col, make((C, 1, 2, A), torch.int32)), {}, "aa_slide_batch",
         1.750),
        ("ℓ=1000 fetch", "ss_matmul",
         (make((C, 1000, N), torch.int32), flat), {}, "ss_matmul", 116.99),
        ("R=3 fetch", "ss_matmul", (make((C, 3, N), torch.int32), flat), {},
         "ss_matmul_tall", 8.649),
        ("prefill one-hot", "share_onehot",
         (make((ROWS,), torch.int64), make((ROWS, VOCAB), torch.int32)),
         {"n_shares": CLOUDS}, "share_onehot", 0.2322),
        ("range first segment", "ripple_segment",
         (planes[..., 0:8], planes[..., 0:8]), {}, "ripple_segment", 0.1127),
        ("carried k=1 step", "ripple_segment",
         (planes[..., 1:2], planes[..., 1:2], carry), {}, "ripple_carry",
         0.0313),
    ]
