"""Protocol rounds a query: ``CostLedger.rounds`` summed over the window's
opened results, over the number of queries of the window."""


def read(run):
    if run.kind != "query" or not run.records:
        return None
    return sum(r.rounds for r in run.records) / len(run.records)
