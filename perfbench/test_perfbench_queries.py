"""The query cells driven end to end on the CPU at the configuration's
small size, with the port's plain kernels: the result line, the traced
line, the traffic, the control, and runs with the timed path broken,
which must come out not correct. The look for a card is skipped; the
rest of a run is as on the card."""
import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))

from harness import cell as cells  # noqa: E402
from harness import query, runner, traffic  # noqa: E402

SEED = 2**31 + 12345            # larger than 32 signed bits hold
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device",
             "compared"}
QUERY = "employee_c20.select_mix"


@pytest.fixture(scope="module")
def bench():
    return cells.load_benchmark(ROOT)


def _run(bench, name, trace=False, seed=SEED, control=False):
    cell = cells.load_cell(bench, name, ROOT)
    # a query on the CPU's plain kernels takes about a second
    line = runner.run(cell, seed, 2.0, trace, device="cpu", smoke=True,
                      control=control)
    json.dumps(line)                       # the line is plain JSON
    return cell, line


@pytest.mark.parametrize("name", ["employee_c20.select_mix", "employee_c20.range_agg"])
def test_cell_is_correct_at_smoke_size(bench, name):
    cell, line = _run(bench, name)
    assert line["correct"], line["compared"]
    assert set(line) == LINE_KEYS and list(line)[-1] == "compared"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in line["metrics"].values():
        assert m["value"] > 0 and np.isfinite(m["value"])
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"}


def test_traced_line_carries_per_layer_metrics(bench):
    cell, line = _run(bench, QUERY, trace=True)
    assert line["correct"]
    assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert line["metrics"]              # the CPU run reads the counters
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0
    # no device ran here: no reader reports a device share
    for m in cell.per_layer:
        if m["source"] == "device_trace":
            assert m["name"] not in line["metrics"]


def test_same_seed_same_queries(bench):
    cell = cells.load_cell(bench, QUERY, ROOT)
    sizes = cell.sizes(True)
    data = cell.reference.Data(cell.reference.make_rows(sizes, SEED),
                               sizes["numeric"])
    first = [traffic.QueryMix(cell.traffic, data, SEED).stream(3)
             for _ in range(2)]
    assert [next(first[0]) for _ in range(40)] == \
        [next(first[1]) for _ in range(40)]
    mix = cell.mix(True)
    other = traffic.QueryMix(mix, data, SEED + 1).stream(3)
    assert [next(other) for _ in range(40)] != \
        [next(traffic.QueryMix(mix, data, SEED).stream(3))
         for _ in range(40)]


@pytest.mark.parametrize("name", ["employee_c20.select_mix",
                                  "employee_c20.range_agg"])
def test_query_control_is_not_correct(bench, name):
    """The control, judged by the cell's own limits, is not correct,
    where the program is."""
    _, line = _run(bench, name, control=True)
    assert line["correct"], line["compared"]
    assert line["control"]["correct"] is False, line["control"]
    got = line["control"]["compared"]["wrong_answers"]
    assert got["value"] > got["limit"]


def test_a_loop_the_harness_lacks_is_refused(bench):
    cell = cells.load_cell(bench, QUERY, ROOT)
    sizes = cell.sizes(True)
    data = cell.reference.Data(cell.reference.make_rows(sizes, SEED),
                               sizes["numeric"])
    with pytest.raises(ValueError, match="not implemented"):
        traffic.QueryMix(dict(cell.traffic, loop="open"), data, SEED)


def test_answer_altered_where_produced_is_not_correct(bench, monkeypatch):
    from repro_torch.api import QueryClient
    original = QueryClient.run_batch

    def altered(self, plans, *a, **kw):
        out = list(original(self, plans, *a, **kw))
        res = out[0]
        count = (res.count or 0) + 1
        out[0] = type(res)(**{**res.__dict__, "count": count})
        return out

    monkeypatch.setattr(QueryClient, "run_batch", altered)
    _, line = _run(bench, QUERY)
    assert not line["correct"]
    assert line["compared"]["wrong_answers"]["value"] > 0


def test_answer_that_never_comes_is_not_correct(bench, monkeypatch):
    """A batch that leaves its last request without a result: that
    request's client waits out the grace and the run is not correct."""
    from repro_torch.api import QueryClient
    original = QueryClient.run_batch

    def half(self, plans, *a, **kw):
        return list(original(self, plans, *a, **kw))[:max(1, len(plans) - 1)]

    monkeypatch.setattr(QueryClient, "run_batch", half)
    monkeypatch.setattr(query, "GRACE_S", 1.0)
    _, line = _run(bench, QUERY)
    assert not line["correct"]
    assert line["compared"]["missing_answers"]["value"] > 0
