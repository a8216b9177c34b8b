"""The private lookup's kernels' share of their roofline over the window,
in %.

The least time is reckoned from the traffic: every batch of the window
looks up its prompts' tokens, then at each decode step one token for
every request that still wants one; a lookup of M tokens over the (V, d)
table shared c ways needs the larger of 32·c·M·V·d int8 operations at
1,979 TOP/s and its bytes at 3.35 TB/s (``harness/bounds.py``). It is
divided by the device time of ``share_onehot``, ``ss_matmul`` and
``ss_matmul_tall`` in the trace."""
from harness import bounds


def _lookup_kernel(name: str) -> bool:
    return "onehot_" in name or "ss_matmul" in name


def read(run):
    if run.kind != "generation" or run.trace is None:
        return None
    busy = run.trace.device_seconds(_lookup_kernel)
    if busy <= 0:
        return None
    k = run.dims
    least = sum(bounds.lookup_least_seconds(m, k["v"], k["d"], k["c"])
                for t, news in run.batches
                for m in bounds.lookup_calls(t, news))
    return 100.0 * least / busy
