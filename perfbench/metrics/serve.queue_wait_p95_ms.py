"""The scheduler's 95th percentile queue wait over the window, in ms.

``ServeStats.queue_wait_quantile(0.95)`` of the program's ``QueryServer``,
whose stats were reset at the window's start. Its histogram keeps the last
``LATENCY_WINDOW`` (4,096) waits only, so the reading stands only while the
window served fewer queries than that; otherwise nothing is read."""

HISTOGRAM = 4096


def read(run):
    if run.kind != "query" or not run.records:
        return None
    if run.serve["served"] >= HISTOGRAM:
        return None
    return run.serve["queue_wait_p95_s"] * 1e3
