"""The yardstick: published H100 peaks and the work a traffic needs.

Every count here is reckoned from the shapes of the traffic and of the
configuration, never from what an implementation launches, so that a
later change that replaces a kernel is read against the same work.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full 700 W power limit (the result line states the card's limit beside
every share read against them).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12          # HBM3
#: dense int8 rate of the tensor cores. The share-space matmul makes each
#: exact mod-p multiply-accumulate of two 31-bit operands from 4 x 4 byte
#: limbs, so c·M·K·N of them count 32·c·M·K·N int8 operations.
INT8_TENSOR_OPS_PER_S = 1.979e15
HALF_FLOPS_PER_S = 989e12          # dense fp16 and bf16 tensor-core rate
INT32_BYTES = 4


def least_seconds(ops: float = 0.0, ops_per_s: float = INT8_TENSOR_OPS_PER_S,
                  nbytes: float = 0.0) -> float:
    """The least time one call can take: the larger of its operations at
    the peak rate and its bytes at the HBM rate."""
    return max(ops / ops_per_s if ops else 0.0, nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# the private embedding lookup (share_onehot, then one share-space matmul)
# ---------------------------------------------------------------------------

def lookup_least_seconds(m: int, k: int, n: int, c: int) -> float:
    """One lookup of ``m`` tokens over a (k, n) table shared ``c`` ways.

    Sharing the one-hots reads the (m, k) coefficients and writes the
    (c, m, k) shares; the contraction reads those shares and the (c, k,
    n) table once, writes the (c, m, n) products, and makes 32·c·m·k·n
    int8 operations. Each byte is counted once."""
    onehot = least_seconds(nbytes=(m * k + c * m * k) * INT32_BYTES)
    matmul = least_seconds(
        ops=32.0 * c * m * k * n,
        nbytes=(c * m * k + c * k * n + c * m * n) * INT32_BYTES)
    return onehot + matmul


def lookup_calls(prompt: int, news) -> list:
    """The lookups one generated batch needs: the prefill's tokens, then,
    at each decode step, one token for every request that still wants
    one (``news``: each request's new tokens; the first comes from the
    prefill)."""
    return [len(news) * prompt] + [
        sum(n - 1 > s for n in news) for s in range(max(news) - 1)]


# ---------------------------------------------------------------------------
# a decoder-only transformer's model FLOPs
# ---------------------------------------------------------------------------

def decoder_layer_params(dims: dict) -> int:
    """Matmul parameters of one GQA decoder layer with a gated MLP
    (``dims``: the configuration reference's ``dims``)."""
    d, q, kv = dims["d"], dims["h"] * dims["hd"], dims["g"] * dims["hd"]
    return d * q + 2 * d * kv + q * d + 3 * d * dims["f"]


def batch_model_flops(dims: dict, prompt: int, news) -> float:
    """Model FLOPs that one greedy batch's requests need, each request
    of ``prompt`` tokens and its own ``news`` new tokens: 2 x the layers'
    matmul parameters for every token processed (the prompt, then each
    generated token but the last), the head for every token whose logits
    are needed (the last prompt position and each later token), and
    attention's QKᵀ and PV over the positions each token attends to (4 ·
    heads · head size a layer, causal). Steps that the program runs for a
    request past its own last token are not counted. The embedding lookup
    is left out: it is a private share-space product with a roofline of
    its own."""
    width = dims["h"] * dims["hd"]
    per_token = 2.0 * dims["layers"] * decoder_layer_params(dims)
    head = 2.0 * dims["d"] * dims["v"]
    total = 0.0
    for n in news:
        attended = prompt * (prompt + 1) // 2 + sum(
            prompt + 1 + i for i in range(n - 1))
        total += (per_token * (prompt + n - 1) + head * n
                  + 4.0 * dims["layers"] * width * attended)
    return total


# ---------------------------------------------------------------------------
# the query kernels: each column share read once
# ---------------------------------------------------------------------------

def match_least_seconds(c: int, n: int, positions: int,
                        alphabet: int) -> float:
    """One read of ``positions`` letter positions of a (c, n, W, A) column
    share: the least a batch's matching over that column needs."""
    return least_seconds(nbytes=c * n * positions * alphabet * INT32_BYTES)


def ripple_least_seconds(c: int, n: int, bits: int, outputs: int) -> float:
    """One read of a numeric column's (c, n, bits) bit-plane shares and
    ``outputs`` (c, n) comparison results written."""
    return least_seconds(nbytes=c * n * (bits + outputs) * INT32_BYTES)
