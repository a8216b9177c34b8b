"""The aten-op cost walker (``launch.hlo_cost``) and the H100 roofline
(``launch.hlo_analysis``), on the CPU and on meta.

Twins of ``tests/test_hlo_analysis.py::test_roofline_terms_and_bottleneck``
at the H100's peaks and of ``tests/test_hlo_cost_field.py``'s field tests:
``field.mul``, ``field.sum_`` and the plain ripple segment are priced with
flops > 0 (the Mersenne fold's ``and`` and shifts as integer work) and no
op is left unpriced. Each kernel entry point of ``kernels.ops`` is priced
once, by its ``PERF.md`` §6 formula, whether the plain version ran on the
CPU or on meta, and at ``chip_smoke.py`` phase 4's full shapes (on meta)
the walker's bound equals the row's "Bound ms" within 1 %. A toy function
with a known peak holds the peak tracker.
"""
import math

import numpy as np
import pytest
import torch

from _torch_phase4 import phase4_calls
from repro_torch.core import automata, field
from repro_torch.core.shamir import Shares
from repro_torch.kernels import ops
from repro_torch.kernels import ripple as rip
from repro_torch.kernels import ss_matmul as ssm
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import hlo_cost

P = 2**31 - 1


def _field(shape, seed=0, device="cpu"):
    g = np.random.default_rng(seed)
    x = torch.from_numpy(g.integers(0, P, size=shape).astype(np.int32))
    return x.to(device)


def test_roofline_terms_and_bottleneck():
    r = H.Roofline(flops=989e12, bytes_accessed=3.35e12,
                   collective_bytes=450e9 * 2, n_chips=1,
                   collective_detail={})
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 1.0) < 1e-9
    assert abs(r.t_collective - 2.0) < 1e-9
    assert r.bottleneck == "collective" and r.t_bound == r.t_collective
    by_class = H.Roofline(flops=1.979e15 + 33.5e12, bytes_accessed=0.0,
                          collective_bytes=64e9, n_chips=1,
                          collective_detail={"pcie": 64e9, "nvlink": 0.0},
                          flops_by_class={"int8": 1.979e15, "int": 33.5e12})
    assert abs(by_class.t_compute - 2.0) < 1e-9
    assert abs(by_class.t_collective - 1.0) < 1e-9
    assert by_class.bottleneck == "compute"
    d = by_class.as_dict()
    for key in ("flops", "bytes_accessed", "collective_bytes", "n_chips",
                "t_compute", "t_memory", "t_collective", "bottleneck",
                "peak_memory_per_device", "collective_detail",
                "flops_by_class"):
        assert key in d


def test_peaks_by_class():
    assert H.PEAKS["dot_bf16"] == 989e12 and H.PEAKS["int8"] == 1.979e15
    assert H.PEAKS["dot_tf32"] == 495e12 and H.PEAKS["float"] == 67e12
    assert H.PEAKS["int"] == 33.5e12 and H.PEAKS["dot_f64"] == 67e12
    assert H.HBM_BW == 3.35e12 and H.LINK_BW == {"nvlink": 450e9,
                                                 "pcie": 64e9}
    assert H.link_of(torch.device("cuda", 0), torch.device("cuda", 1)) \
        == "nvlink"
    assert H.link_of(torch.device("cpu"), torch.device("cuda", 0)) == "pcie"
    assert H.link_of("meta", "cpu") is None
    copies = [dict(src=(0, 0), dst=(0, 1), why="operand", bytes=100),
              dict(src="client", dst=(0, 1), why="place", bytes=7),
              dict(src=(0, 0), dst="client", why="gather", bytes=5)]
    devs = {(0, 0): torch.device("cuda", 0), (0, 1): torch.device("cuda", 1),
            "client": torch.device("cuda", 0)}
    assert H.copies_detail(copies, devs.__getitem__) == {"nvlink": 107.0,
                                                         "pcie": 0.0}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_field_mul_fold_ops_counted(device):
    a = _field((2, 3, 4), 1, device)
    cost = hlo_cost.analyze(field.mul, a, a)
    # the Mersenne fold is and + shifts: priced as integer work
    assert cost.op_counts["bitwise_and"] == 2
    assert cost.op_counts["__rshift__"] == 2
    assert cost.flops > 0 and cost.flops_by_class.get("int", 0) > 0
    assert not cost.unpriced


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_field_sum_counted(device):
    a = _field((2, 5, 12), 2, device)
    cost = hlo_cost.analyze(lambda x: field.sum_(x, dim=1), a)
    assert "sum" in cost.op_counts
    assert cost.flops >= a.numel()
    assert not cost.unpriced


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_ripple_segment_plain_ops_counted(device):
    a, b = _field((2, 2, 3, 3), 3, device), _field((2, 2, 3, 3), 4, device)
    cost = hlo_cost.analyze(rip.ripple_segment_plain, a, b, None)
    assert cost.flops > 0 and not cost.unpriced
    assert not cost.kernels             # the plain version is aten ops


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_no_op_of_the_field_matmul_falls_through_unpriced(device):
    a, b = _field((2, 4, 6), 5, device), _field((2, 6, 3), 6, device)
    cost = hlo_cost.analyze(field.matmul, a, b)
    assert not cost.unpriced
    dot = "dot_int" if device == "cpu" else "dot_f64"
    # four limb dots, 2·|out|·K each
    assert cost.flops_by_class[dot] == 4 * 2 * (2 * 4 * 3) * 6
    mm = hlo_cost.analyze(automata.match_matrix, Shares(_field(
        (2, 5, 3, 4), 7, device)), Shares(_field((2, 6, 3, 4), 8, device)),
        method="aggregate")
    assert not mm.unpriced and mm.flops > 0


def _calls(device):
    """Each entry point once, on small operands."""
    c, n, w, a = 2, 9, 4, 5
    rel = _field((c, n, 3, w, a), 10, device)
    col = rel[:, :, 1][:, None]
    pat = _field((c, 1, w, a), 11, device)
    planes = _field((c, 2, n, 5), 12, device)
    carry = _field((c, 2, n), 13, device)
    rows = dict(columns=[0, 2], starts=[0, 3], lengths=[9, 4],
                pat=_field((c, 2, w, a), 14, device), height=9)
    slide_rows = dict(rows, pat=_field((c, 2, 2, a), 15, device))
    return [
        ("aa_match_batch", (col, pat), {}, "aa_match_batch",
         4 * (c * n * w * a + c * w * a + c * n),
         2 * c * n * w * a + c * n * (w - 1)),
        ("aa_match_rows", (rel,), rows, "aa_match_batch",
         4 * (c * 13 * w * a + c * 2 * w * a + c * 2 * 9),
         2 * c * 13 * w * a + c * 13 * (w - 1)),
        ("aa_slide_batch", (col, pat[:, :, :2]), {}, "aa_slide_batch",
         4 * (c * n * w * a + c * 2 * a + c * n * 3),
         2 * c * n * 3 * 2 * a + c * n * 3),
        ("aa_slide_rows", (rel,), slide_rows, "aa_slide_batch",
         4 * (c * 13 * w * a + c * 2 * 2 * a + c * 2 * 9 * 3),
         2 * c * 13 * 3 * 2 * a + c * 13 * 3),
        ("ss_matmul", (_field((c, 3, 7), 16, device),
                       _field((c, 7, 4), 17, device)), {}, "ss_matmul",
         4 * (c * 21 + c * 28 + c * 12), 32 * c * 3 * 7 * 4),
        ("ss_matmul", (_field((c, 2, 2048), 18, device),
                       _field((c, 2048, 3), 19, device)), {},
         "ss_matmul_tall", 4 * c * (2 * 2048 + 2048 * 3 + 6),
         32 * c * 2 * 2048 * 3),
        ("ripple_segment", (planes, planes), {}, "ripple_segment",
         4 * c * 2 * n * (2 * 5 + 2), c * 2 * n * (7 + 4 * 12)),
        ("ripple_segment", (planes[..., 2:3], planes[..., 2:3], carry), {},
         "ripple_carry", 4 * c * 2 * n * 5, c * 2 * n * 12),
        ("ripple_carry", (planes[..., 0], planes[..., 1], carry), {},
         "ripple_carry", 4 * c * 2 * n * 5, c * 2 * n * 12),
        ("share_onehot", (torch.tensor([0, 3, 9], device=device),
                          _field((3, 11), 20, device)), {"n_shares": 4},
         "share_onehot", 4 * 3 * 11 + 8 * 3 + 4 * 4 * 3 * 11, 5 * 3 * 11),
    ]


@pytest.mark.parametrize("i", range(10))
def test_each_kernel_priced_once_by_its_formula(i):
    """CPU and meta give one kernel, its formula's bytes and operations,
    and no aten op of the plain version; the CPU result is the plain
    version's."""
    prices = []
    for device in ("cpu", "meta"):
        entry, args, kw, kernel, nbytes, nops = _calls(device)[i]
        fn = getattr(ops, entry)
        with hlo_cost.CostMode() as mode:
            got = fn(*args, **kw)
        cost = mode.cost
        assert ops.walker is None
        assert cost.kernels == {kernel: 1}
        assert cost.ops == 0 and not cost.unpriced
        assert cost.hbm_bytes == nbytes and cost.flops == nops
        cls = "int8" if kernel.startswith("ss_matmul") else "int"
        assert cost.flops_by_class == {cls: nops}
        prices.append((cost.hbm_bytes, cost.flops))
        if device == "cpu":
            want = fn(*args, **kw)
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert torch.equal(g, w)
        else:
            leaves = got if isinstance(got, tuple) else (got,)
            assert all(t.device.type == "meta" for t in leaves)
    assert prices[0] == prices[1]


def test_match_matrix_batch_prices_its_launches_and_chain():
    """A join group: W ss_matmul kernels priced by formula, the chain's
    modular products as aten ops."""
    c, b, nx, ny, w, a = 2, 1, 5, 4, 3, 6
    x, y = _field((c, b, nx, w, a), 21), _field((c, b, ny, w, a), 22)
    cost = hlo_cost.analyze(ops.match_matrix_batch, x, y)
    assert cost.kernels == {"ss_matmul": w}
    assert cost.flops_by_class["int8"] == w * 32 * c * b * ny * a * nx
    assert cost.flops_by_class["int"] > 0 and not cost.unpriced


@pytest.mark.parametrize("label", [c[0] for c in phase4_calls(
    lambda s, d: torch.empty(s, dtype=d, device="meta"))])
def test_phase4_bounds_equal_perf_md(label):
    """At phase 4's shapes (on meta) the walker's bound is the PERF.md §6
    row's "Bound ms" within 1 %."""
    calls = {c[0]: c for c in phase4_calls(
        lambda s, d: torch.empty(s, dtype=d, device="meta"))}
    _, entry, args, kw, kernel, bound_ms = calls[label]
    with hlo_cost.CostMode() as mode:
        getattr(ops, entry)(*args, **kw)
    assert mode.cost.kernels == {kernel: 1}
    t = mode.cost.roofline().t_bound * 1e3
    assert math.isclose(t, bound_ms, rel_tol=0.01), (label, t, bound_ms)


def test_peak_tracker_on_a_toy_function():
    """x (4,000 B) is an argument; a, b, c are made and freed as Python
    drops them; a view keeps its storage alive. The peak is c and b's
    storage (8,000 + 4,000 B) with the three 4-byte sums of the last
    line."""
    x = torch.ones(1000)

    def toy(x):
        a = x * 2                     # 4,000 live
        b = a + 1                     # 8,000
        del a                         # 4,000
        c = torch.cat([b, b])         # 12,000: the peak
        v = b[:10]
        del b                         # b's storage lives on in v: 12,000
        return c.sum() + v.sum()      # 12,012

    cost = hlo_cost.analyze(toy, x)
    assert cost.arg_bytes == 4000
    assert cost.peak_bytes == 12012
    with hlo_cost.CostMode() as mode:
        keep = torch.empty(500, device="meta") + 1        # 2 x 2,000
        del keep
        y = torch.zeros(250, device="meta")               # 1,000
    assert mode.cost.peak_bytes == 4000 and y.shape == (250,)


def test_autograd_saved_tensors_stay_live_until_backward():
    """A tensor saved for the backward lives on after Python drops it."""
    w = torch.ones(1000, requires_grad=True)

    def step():
        h = w.exp()                   # saved for exp's backward: 4,000
        out = (h * 3).sum()           # h * 3: 4,000 more
        del h
        out.backward()

    cost = hlo_cost.analyze(step)
    assert cost.peak_bytes >= 8000
    assert "exp" in cost.op_counts and "mul" in cost.op_counts
    assert not cost.unpriced


def test_walker_leaves_a_cpu_run_unchanged():
    a, b = _field((2, 5, 300), 23), _field((2, 300, 4), 24)
    with hlo_cost.CostMode():
        got = ops.ss_matmul(a, b)
    assert torch.equal(got, ssm.ss_matmul_plain(a, b))
    assert ops.walker is None


def test_host_ops_are_left_to_the_host():
    """``device="cuda"`` leaves CPU-only ops unpriced and counted apart."""
    with hlo_cost.CostMode(device="cuda") as mode:
        torch.ones(10) + 1
    assert mode.cost.ops == 0 and mode.cost.host_ops == 2
    assert mode.cost.hbm_bytes == 0


def test_scaled_and_added_costs():
    a = _field((2, 3, 4), 25)
    one = hlo_cost.analyze(field.mul, a, a)
    three = one.scaled(3)
    assert three.flops == 3 * one.flops and three.ops == 3 * one.ops
    assert three.peak_bytes == one.peak_bytes
    total = hlo_cost.Cost()
    total += one
    total += one
    assert total.flops == 2 * one.flops
    assert total.op_counts == {k: 2 * v for k, v in one.op_counts.items()}
