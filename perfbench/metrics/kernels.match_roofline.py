"""The matching kernels' share of their roofline over the window, in %.

The least time is reckoned from the served plans: in each closed batch,
each column that a count or a select matches is read once (its (c, n, W,
A) int32 shares at 3.35 TB/s), for the batches whose queries finished in
the window. It is divided by the device time of ``aa_match_batch`` and
``aa_slide_batch`` (``aa_tile_kernel``) in the trace."""
from harness import bounds

KERNEL = "aa_tile_kernel"


def read(run):
    if run.kind != "query" or run.trace is None:
        return None
    busy = run.trace.device_seconds(lambda name: KERNEL in name)
    if busy <= 0:
        return None
    s = run.config
    batches = {}
    for r in run.records:
        if r.in_window and r.query.plan in ("count", "select"):
            batches.setdefault(round(r.close_at, 6), []).append(r.query)
    columns = sum(len({q.column for q in queries})
                  for queries in batches.values())
    least = columns * bounds.match_least_seconds(
        s["clouds"], s["n"], s["word_length"], s["alphabet"])
    return 100.0 * least / busy
