"""``chip_smoke.py --grids-train``'s table of families and its checks, on
the CPU: no rank is spawned and nothing is priced.

* every row trains its family's full published configuration
  (``configs.full``) in every field but ``n_layers``, at both its trained
  and its held depth, the held depth no less than the float32 check's;
* ``grid_phases()`` lists every phase of the new entry, under
  ``--grids-train``, and ``train4_units`` runs each of them;
* ``train4_check`` passes units that agree and records a failure for
  each kind of disagreement the four-card run is held to.
"""
import copy
import dataclasses
import math

import pytest

import chip_smoke as cs
from repro_torch import configs

ARCHS = [row[0] for row in cs.TRAIN4_FAMILIES]


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out.pop("n_layers")
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_rows_train_the_published_configuration(arch):
    _, depth, grids, held, seq, frontend = cs.train4_row(arch)
    full = configs.full(arch)
    trained, t_seq, t_front = cs.train4_cfg(arch)
    cut, _, _ = cs.train4_cfg(arch, held)
    assert _fields(trained) == _fields(full) == _fields(cut)
    assert trained.n_layers == (depth or full.n_layers)
    assert cut.n_layers == held
    assert cs.F32_TRAIN_LAYERS <= held < trained.n_layers <= full.n_layers
    assert trained.dtype == "bfloat16" and trained.remat
    assert (t_seq, t_front) == (seq, frontend)
    assert all(math.prod(s) == cs.TRAIN4_WORLD for s in grids)
    assert all((arch, s) in cs.TRAIN4_PEAK_GB for s in grids)
    # the positions a sequence are t1's: a frontend's prefix takes its part
    assert seq + (frontend[1] if frontend else 0) == cs.TRAIN_SEQ
    if frontend:
        assert frontend == ("patches", full.n_prefix)


def test_grid_phases_list_every_new_phase():
    phases = {(p, str(g)): (need, entry)
              for p, g, need, entry in cs.grid_phases()}
    want = []
    for arch, _, grids, held, _, frontend in cs.TRAIN4_FAMILIES:
        n = cs.train4_cfg(arch)[0].n_layers
        with_ = f", {frontend[1]} {frontend[0]}" if frontend else ""
        for s in grids:
            want += [(f"{arch} training, {n} layers{with_}", str(s)),
                     (f"{arch} float32 gradients, "
                      f"{cs.F32_TRAIN_LAYERS} layers", str(s)),
                     (f"{arch} training, {held} layers against one card",
                      str(s))]
        want.append((f"{arch} private step, {held} layers",
                     str(cs.TRAIN4_PRIVATE_GRID)))
    for key in want:
        assert phases[key] == (4, "--grids-train"), key
    assert sum(e == "--grids-train" for _, e in phases.values()) \
        == len(want)
    # --grids keeps its own phases
    assert any(e == "--grids" for _, e in phases.values())


def test_units_run_every_phase_trained_runs_last():
    units = cs.train4_units(cs.TRAIN4_WORLD)
    names = [u[0] for u in units]
    assert len(names) == len(set(names))
    assert all(s is None or math.prod(s) == cs.TRAIN4_WORLD
               for _, s, _ in units)
    trained = [f"{a} {s}, {cs.train4_cfg(a)[0].n_layers} layers"
               for a, _, grids, *_ in cs.TRAIN4_FAMILIES for s in grids]
    assert names[-len(trained):] == trained
    for arch, _, grids, held, _, _ in cs.TRAIN4_FAMILIES:
        n = cs.train4_cfg(arch)[0].n_layers
        assert names.index(f"{arch} float32 one card") < min(
            names.index(f"{arch} float32 {s}") for s in grids)
        assert names.index(f"{arch} one card, {held} layers") < min(
            names.index(f"{arch} {s}, {held} layers") for s in grids)
        assert names.index(f"{arch} streamed step 0, {n} layers") < min(
            names.index(f"{arch} {s}, {n} layers") for s in grids)
    assert cs.train4_units(2) == []


def _steps(losses, **kw):
    out = {"losses": list(losses), "grad_norms": [1.0] * 3,
           "lrs": [1.5e-4, 3e-4, 3e-5], "want_lrs": [1.5e-4, 3e-4, 3e-5],
           "layer0_moved": True, "ms_per_step": 1000.0,
           "tokens_a_step": 2048, "positions_a_step": 2048,
           "idle_share": 0.5, "device_ms_by_kind": {"matmul": 100.0},
           "nccl_ms_by_kind": {"all-reduce": 10.0},
           "profiled_step_ms": 1000.0, "first_step_and_init_s": 10.0,
           "peak_gb": 20.0}
    out.update(kw)
    return out


def _agreeing_units():
    units = {}
    world = cs.TRAIN4_WORLD
    for arch, _, grids, held, _, _ in cs.TRAIN4_FAMILIES:
        n = cs.train4_cfg(arch)[0].n_layers
        units[f"{arch} streamed step 0, {n} layers"] = [{"loss": 10.0}]
        units[f"{arch} float32 one card"] = [{"loss": 10.0}]
        units[f"{arch} one card, {held} layers"] = [_steps([9.0, 8.0, 7.0])]
        for s in grids:
            units[f"{arch} {s}, {n} layers"] = [
                _steps([10.001, 9.5, 9.0]) for _ in range(world)]
            units[f"{arch} {s}, {held} layers"] = [
                _steps([9.001, 8.001, 7.001]) for _ in range(world)]
            units[f"{arch} float32 {s}"] = [
                {"loss": 10.0, "one_card_loss": 10.0, "loss_rel_diff": 1e-7,
                 "worst_grad": "blocks/attn/wk", "worst_grad_rel_err": 1e-6,
                 "leaves": 15}] + [{"loss": 10.0}] * (world - 1)
        units[f"{arch} private {cs.TRAIN4_PRIVATE_GRID}, {held} layers"] = [
            {"private_launches": {"share_onehot": 1, "ss_matmul": 1},
             "private_errs": {}} for _ in range(world)]
    return units


def test_check_passes_agreeing_units():
    failed = {}
    out = cs.train4_check(_agreeing_units(), failed)
    assert failed == {}
    assert set(out) == set(ARCHS)
    glm = out["chatglm3_6b"]
    assert len(glm["grids"]) == 2 and max(glm["grids_loss_rel_diff"]) == 0
    row = glm["grids"]["(1, 4)"]
    assert row["tokens_per_s"] == 2048.0
    assert row["predicted_peak_gb"] == cs.TRAIN4_PEAK_GB[("chatglm3_6b",
                                                          (1, 4))]


A, GRID = "chatglm3_6b", (1, 4)
N = configs.full(A).n_layers
HELD = cs.train4_row(A)[3]


def _lr(u):
    u[f"{A} {GRID}, {N} layers"][0]["lrs"] = [1.5e-4, 3e-4, 3e-4]


def _nan(u):
    u[f"{A} {GRID}, {N} layers"][0]["losses"] = [10.0, math.nan, 9.0]


def _still(u):
    u[f"{A} {GRID}, {N} layers"][2]["layer0_moved"] = False


def _step0(u):
    u[f"{A} streamed step 0, {N} layers"][0]["loss"] = 10.1


def _f32_leaf(u):
    u[f"{A} float32 {GRID}"][0]["worst_grad_rel_err"] = 2e-4


def _f32_loss(u):
    u[f"{A} float32 {GRID}"][0]["loss_rel_diff"] = 2e-5


def _held(u):
    u[f"{A} {GRID}, {HELD} layers"][0]["losses"][2] = 7.1


def _grids(u):
    u[f"{A} (2, 2), {N} layers"][0]["losses"][1] = 9.6


def _private(u):
    u[f"{A} private {cs.TRAIN4_PRIVATE_GRID}, {HELD} layers"][3][
        "private_launches"] = {"share_onehot": 1, "ss_matmul": 0}


def _missing(u):
    del u[f"{A} {GRID}, {HELD} layers"]


@pytest.mark.parametrize("spoil", [_lr, _nan, _still, _step0, _f32_leaf,
                                   _f32_loss, _held, _grids, _private,
                                   _missing])
def test_check_records_each_disagreement(spoil):
    units = copy.deepcopy(_agreeing_units())
    spoil(units)
    failed = {}
    cs.train4_check(units, failed)
    assert failed and all(k.startswith(A) for k in failed), failed
