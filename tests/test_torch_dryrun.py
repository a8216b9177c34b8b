"""The port's dry-run on the CPU: meta-device inputs (``launch.specs``) and
records of ``launch.dryrun``.

The meta inputs hold the reference's ``ShapeDtypeStruct`` stand-ins shape
for shape and dtype for dtype (int32 shares for uint32 ones); the paper's
query mix gives the reference's shares bit for bit at a small size;
``grad_accum_for`` and ``model_flops`` equal the reference's for every
arch and shape (read from its source: importing the reference's dry-run
module would force 512 host devices on this process). Three smoke cells
(a train, a prefill and a decode step at the real shapes, the smoke
configurations) and the query mix at ``configs.paper_db.smoke()`` price
with status ok, finite roofline terms and no unpriced op, and a train
cell priced one microbatch times the accumulation matches the walk of the
whole accumulated step.
"""
import ast
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import specs as jspecs
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro_torch import _tree
from repro_torch import configs
from repro_torch.launch import dryrun, hlo_cost, specs
from repro_torch.models.config import ALL_SHAPES, ShapeConfig
from repro_torch.train import AdamWConfig, make_train_step

ROOT = Path(__file__).resolve().parents[1]
P = 2**31 - 1


@pytest.fixture(scope="module")
def mesh11():
    return jax.make_mesh((1, 1), ("data", "model"))


def _ref_fns():
    """``grad_accum_for`` and ``model_flops`` of the reference's dry-run,
    compiled from its source alone."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    tree = ast.parse(src)
    keep = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("grad_accum_for", "model_flops")]
    ns = {}
    exec(compile(ast.Module(keep, []), "dryrun_ref", "exec"), ns)
    return ns["grad_accum_for"], ns["model_flops"]


def test_grad_accum_and_model_flops_match_reference():
    ref_ga, ref_mf = _ref_fns()
    for arch in configs.ARCH_IDS:
        cfg, jcfg = configs.full(arch), jconfigs.full(arch)
        assert dryrun.grad_accum_for(cfg) == ref_ga(jcfg)
        for shape in ALL_SHAPES:
            assert dryrun.model_flops(cfg, shape) == ref_mf(jcfg, shape)
    assert dryrun.cell_key("a", "b", "c") == "a|b|c"
    assert dryrun.LONG_OK == {"mamba2_2_7b", "hymba_1_5b", "gemma3_1b"}


def _dt(x):
    return str(x.dtype).replace("torch.", "").replace("uint32", "int32")


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_meta_inputs_match_reference_shapes(arch, mesh11):
    cfg, jcfg = configs.smoke(arch), jconfigs.smoke(arch)
    p = specs.params_meta(cfg)
    jp = jax.eval_shape(lambda k: jinit_params(k, jcfg),
                        jax.random.PRNGKey(0))
    assert [(tuple(t.shape), _dt(t)) for t in _tree.leaves(p)] == [
        (tuple(t.shape), _dt(t)) for t in jax.tree.leaves(jp)]
    assert all(t.device.type == "meta" for t in _tree.leaves(p))
    cfg, jcfg = configs.full(arch), jconfigs.full(arch)
    for shape in ALL_SHAPES:
        for ga in (1, 8):
            want = jspecs.batch_sds(jcfg, mesh11, shape, grad_accum=ga)
            got = specs.batch_meta(cfg, shape, grad_accum=ga)
            assert sorted(got) == sorted(want)
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape), k
                assert _dt(got[k]) == _dt(want[k]), k
        if shape.kind == "decode":
            enc = specs.ENC_LEN if cfg.n_enc_layers else 0
            want = jax.eval_shape(lambda: jinit_cache(
                jcfg, shape.global_batch, shape.seq_len, enc_len=enc))
            got = specs.cache_meta(cfg, shape)
            assert [(tuple(t.shape), _dt(t)) for t in _tree.leaves(got)] \
                == [(tuple(t.shape), _dt(t)) for t in jax.tree.leaves(want)]


def test_input_specs_by_kind():
    cfg = configs.smoke("qwen1_5_4b")
    train, prefill, decode = (ShapeConfig("t", 32, 8, "train"),
                              ShapeConfig("p", 32, 2, "prefill"),
                              ShapeConfig("d", 32, 2, "decode"))
    p, opt, batch = specs.input_specs(cfg, train, grad_accum=4)
    assert tuple(batch["tokens"].shape) == (4, 2, 32)
    assert opt.step.device.type == "meta"
    assert len(specs.input_specs(cfg, prefill)) == 2
    p, cache, cache_len, batch = specs.input_specs(cfg, decode)
    assert cache_len == 31 and tuple(batch["tokens"].shape) == (2, 1)
    assert cache["kv"][0].shape[2] == 32


def test_paper_db_specs_match_reference(mesh11):
    for db_cfg in (configs.get("paper_db").smoke(),
                   configs.get("paper_db").full()):
        want = jspecs.paper_db_specs(db_cfg, mesh11)
        got = specs.paper_db_specs(db_cfg)
        assert [tuple(t.shape) for t in got] == [tuple(t.shape)
                                                 for t in want]
        assert all(t.dtype == torch.int32 and t.device.type == "meta"
                   for t in got)


def test_paper_db_step_matches_reference():
    """The query mix on the CPU gives the reference's shares bit for bit
    (join columns of 40 and 24 tuples)."""
    rng = np.random.default_rng(0)
    c, n, m, w, a = 4, 30, 3, 6, 16

    def el(*shape):
        return rng.integers(0, P, size=shape).astype(np.uint32)

    args = (el(c, n, m, w, a), el(c, w, a), el(c, 4, n), el(c, 40, w, a),
            el(c, 24, w, a))
    want = jspecs.paper_db_step(*[jax.numpy.asarray(x) for x in args])
    got = specs.paper_db_step(*[torch.from_numpy(x.astype(np.int32))
                                for x in args])
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(w_))


def _finite(rec):
    assert rec["status"] == "ok", rec.get("traceback")
    assert not rec["unpriced"]
    for key in ("t_compute", "t_memory", "t_collective", "t_bound",
                "flops", "bytes_accessed"):
        assert math.isfinite(rec[key]) and rec[key] >= 0, key
    assert rec["t_bound"] > 0 and rec["memory"]["peak_gb"] > 0
    assert rec["peak_memory_per_device"] == pytest.approx(
        rec["memory"]["peak_gb"] * 1e9)


@pytest.mark.parametrize("arch, shape", [
    ("qwen1_5_4b", ALL_SHAPES[0]), ("gemma3_1b", ALL_SHAPES[1]),
    ("hymba_1_5b", ALL_SHAPES[2])], ids=["train", "prefill", "decode"])
def test_smoke_cells_price_ok(arch, shape):
    rec = dryrun.price_cell(arch, shape, smoke=True)
    _finite(rec)
    assert rec["arch"] == arch and rec["shape"] == shape.name
    assert rec["grid"] == dryrun.GRID and rec["useful_ratio"] > 0
    if shape.kind == "train":
        assert rec["accum_scaled"] and rec["grad_accum"] == 4
        assert 0.0 < rec["useful_ratio"] < 1.0


def test_paper_db_smoke_prices_ok():
    rec = dryrun.price_paper_db(configs.get("paper_db").smoke())
    _finite(rec)
    assert rec["model_flops"] is None
    assert rec["flops_by_class"]["dot_f64"] > 0       # field.matmul's limbs
    assert rec["flops_by_class"]["int"] > 0


def test_accum_scaled_train_matches_the_whole_step():
    """One microbatch times the accumulation count plus one update prices
    what the walk of the whole accumulated step prices, to within the
    accumulator's set-up."""
    cfg = configs.smoke("qwen1_5_4b")
    shape = ShapeConfig("t", 32, 4, "train")
    scaled, _, _, flag = dryrun._price_train(cfg, shape, 2)
    assert flag
    params, opt, batch = specs.input_specs(cfg, shape, grad_accum=2)
    whole = hlo_cost.analyze(make_train_step(cfg, AdamWConfig(),
                                             grad_accum=2),
                             params, opt, batch)
    assert not whole.unpriced and not scaled.unpriced
    assert scaled.flops == pytest.approx(whole.flops, rel=0.01)
    assert scaled.hbm_bytes == pytest.approx(whole.hbm_bytes, rel=0.05)


def test_cli_writes_and_skips(tmp_path, capsys):
    out = tmp_path / "dry.json"
    argv = ["--arch", "paper_db", "--out", str(out)]
    results = dryrun.main(argv)
    assert list(results) == ["paper_db|query_mix|" + dryrun.GRID]
    assert json.loads(out.read_text()) == json.loads(json.dumps(
        results, default=str))
    assert "[dryrun] paper_db" in capsys.readouterr().out
    dryrun.main(argv)                          # done: skipped, no line
    assert capsys.readouterr().out == ""
    rec = dryrun.main(["--arch", "qwen1.5-4b", "--shape", "long_500k",
                       "--out", str(out)])
    assert rec["qwen1_5_4b|long_500k|" + dryrun.GRID]["status"].startswith(
        "skipped")
    assert Path(dryrun.RESULTS).resolve().parent == ROOT / "build"
