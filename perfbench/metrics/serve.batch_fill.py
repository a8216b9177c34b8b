"""Queries a closed batch held over the window: ``ServeStats``'
``mean_batch_size`` (served / batches) since the reset at the window's
start."""


def read(run):
    if run.kind != "query" or not run.serve["batches"]:
        return None
    return float(run.serve["mean_batch_size"])
