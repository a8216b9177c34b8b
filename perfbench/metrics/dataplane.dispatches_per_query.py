"""Shard dispatches a query: the relation's ``DispatchStats.dispatches``
over the window (``core/dataplane.py``), over the number of queries of the
window."""


def read(run):
    if run.kind != "query" or not run.records:
        return None
    return run.dispatches / len(run.records)
