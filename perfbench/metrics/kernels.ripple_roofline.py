"""The ripple comparator's share of its roofline over the window, in %.

The least time is reckoned from the served plans: in each closed batch,
each numeric column that a range or a MIN/MAX compares is read once (its
(c, n, bits) bit-plane shares) and each comparison's (c, n) results are
written once (two a range, one a MIN/MAX tournament), at 3.35 TB/s, for
the batches whose queries finished in the window. It is divided by the
device time of ``ripple_segment`` and ``ripple_carry`` in the trace."""
from harness import bounds

OUTPUTS = {"range_count": 2, "range_select": 2, "min": 1, "max": 1}


def read(run):
    if run.kind != "query" or run.trace is None:
        return None
    busy = run.trace.device_seconds(lambda name: "ripple_" in name)
    if busy <= 0:
        return None
    s = run.config
    batches = {}
    for r in run.records:
        key = r.query.op if r.query.plan == "aggregate" else r.query.plan
        if r.in_window and key in OUTPUTS:
            batch = batches.setdefault(round(r.close_at, 6), {})
            batch[r.query.column] = batch.get(r.query.column, 0) \
                + OUTPUTS[key]
    least = sum(bounds.ripple_least_seconds(
        s["clouds"], s["n"], s["numeric"][col], outs)
        for batch in batches.values() for col, outs in batch.items())
    return 100.0 * least / busy
