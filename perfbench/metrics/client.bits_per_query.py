"""The paper's bit flow a query: ``CostLedger`` user <-> cloud bits summed
over the window's opened results, over the number of queries of the
window."""


def read(run):
    if run.kind != "query" or not run.records:
        return None
    return sum(r.bits for r in run.records) / len(run.records)
