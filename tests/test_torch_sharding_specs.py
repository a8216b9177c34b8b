"""The port's model placement rules against the reference's, spec for spec.

Twins of ``tests/test_sharding_specs.py``: ``param_specs``,
``param_shardings``, ``batch_spec``, ``cache_spec`` and ``logits_spec`` of
``repro_torch.sharding`` must give, for every arch and every shape of
``ALL_SHAPES``, the axis tuples that ``tuple(PartitionSpec)`` gives for the
reference's leaf, leaf for leaf in ``_tree``'s order, on a 1 x 1 grid, on
a 16 x 16 stand-in (a production single-pod mesh, as the reference's
``FakeMesh``) and on a 2 x 16 x 16 ``pod`` stand-in.

The parameter trees are the smoke configurations' (the port's drawn on the
CPU, the reference's from ``jax.eval_shape``): the rules read only a
leaf's path and rank, which the full configurations share, and the full
configuration's divisibility is held on the same trees.
"""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as jconfigs
from repro import sharding as jshd
from repro.models import init_params as jinit_params
from repro_torch import _tree
from repro_torch import configs
from repro_torch import sharding as shd
from repro_torch.core.grid import make_host_mesh
from repro_torch.models import init_params
from repro_torch.models.config import ALL_SHAPES


class FakeGrid:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakePodGrid:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


GRIDS = {"1x1": None, "16x16": FakeGrid(), "pod": FakePodGrid()}


def _grids(name):
    """-> (reference mesh, port grid)."""
    if name == "1x1":
        return jax.make_mesh((1, 1), ("data", "model")), make_host_mesh("cpu")
    return GRIDS[name], GRIDS[name]


def _spec_leaves(tree) -> list:
    """The port's specs in ``_tree``'s leaf order: a tuple whose entries
    are each ``None``, an axis name or a tuple of axis names is one spec,
    not a node."""
    def is_spec(x) -> bool:
        return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
            e is None or isinstance(e, str) or (
                isinstance(e, tuple) and all(isinstance(a, str) for a in e))
            for e in x)

    if is_spec(tree):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [s for c in tree for s in _spec_leaves(c)]
    return []


def _ref_leaves(specs):
    return [tuple(s) for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, P))]


@pytest.fixture(scope="module")
def trees():
    out = {}
    for arch in configs.ARCH_IDS:
        cfg = configs.smoke(arch)
        jshapes = jax.eval_shape(lambda k: jinit_params(k, jconfigs.smoke(
            arch)), jax.random.PRNGKey(0))
        out[arch] = (jshapes, init_params(0, cfg, device="cpu"))
    return out


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_match_reference(arch, size, grid, trees):
    mesh, tgrid = _grids(grid)
    jshapes, params = trees[arch]
    jcfg = getattr(jconfigs, size)(arch)
    cfg = getattr(configs, size)(arch)
    want = _ref_leaves(jshd.param_specs(jcfg, mesh, jshapes))
    specs = shd.param_specs(cfg, tgrid, params)
    got = _spec_leaves(specs)
    paths = [p for p, _ in _tree.leaves_with_paths(params)]
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "name", k)))
                       for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jshapes)[0]]
    assert paths == jpaths
    assert got == want
    assert _spec_leaves(shd.param_shardings(cfg, tgrid, params)) == want
    for (path, leaf), spec in zip(_tree.leaves_with_paths(params), got):
        assert len(spec) <= leaf.ndim, (path, spec, leaf.shape)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_batch_cache_logits_specs_match_reference(arch, grid):
    mesh, tgrid = _grids(grid)
    jcfg, cfg = jconfigs.full(arch), configs.full(arch)
    for shape in ALL_SHAPES:
        jb, tb = jshd.batch_spec(jcfg, mesh, shape), shd.batch_spec(
            cfg, tgrid, shape)
        assert sorted(jb) == sorted(tb)
        assert {k: tuple(v) for k, v in jb.items()} == tb, shape.name
        jc = jshd.cache_spec(jcfg, mesh, shape)
        tc = shd.cache_spec(cfg, tgrid, shape)
        assert sorted(jc) == sorted(tc)
        assert _spec_leaves(tc) == _ref_leaves(jc), shape.name
        if cfg.family == "ssm":
            assert "ssm" in tc and "kv" not in tc
        else:
            assert "kv" in tc
        assert shd.logits_spec(cfg, tgrid, shape) == tuple(
            jshd.logits_spec(jcfg, mesh, shape))


@pytest.mark.parametrize("grid", list(GRIDS))
def test_axes_and_divisibility_match_reference(grid):
    mesh, tgrid = _grids(grid)
    assert shd.dp_axes(tgrid) == jshd.dp_axes(mesh)
    assert shd.dp_size(tgrid) == jshd.dp_size(mesh)
    assert shd.model_size(tgrid) == jshd.model_size(mesh)
    for arch in configs.ARCH_IDS:
        j = vars(jshd.Divisibility(jconfigs.full(arch), mesh))
        t = vars(shd.Divisibility(configs.full(arch), tgrid))
        assert t == j, arch


def test_divisibility_fallbacks_full_grid():
    """On a 16-way model axis the documented fallbacks trigger."""
    fg = FakeGrid()
    div_qwen = shd.Divisibility(configs.full("qwen1_5_4b"), fg)
    assert not div_qwen.q and div_qwen.vocab and div_qwen.ff
    div_moon = shd.Divisibility(configs.full("moonshot_v1_16b_a3b"), fg)
    assert div_moon.q and div_moon.kv and div_moon.experts
    div_mamba = shd.Divisibility(configs.full("mamba2_2_7b"), fg)
    assert div_mamba.ssm_h and not div_mamba.vocab
    div_granite = shd.Divisibility(configs.full("granite_moe_3b_a800m"), fg)
    assert not div_granite.experts and div_granite.ff


def test_specs_of_meta_params_match_drawn_ones():
    """A meta tree (``launch.specs.params_meta``) gives the same specs as
    drawn parameters: the rules read paths and ranks only."""
    from repro_torch.launch import specs
    cfg = configs.smoke("granite_moe_3b_a800m")
    meta = specs.params_meta(cfg)
    assert all(t.device.type == "meta" for t in _tree.leaves(meta))
    drawn = init_params(0, cfg, device="cpu")
    assert [(p, tuple(t.shape), t.dtype)
            for p, t in _tree.leaves_with_paths(meta)] == [
        (p, tuple(t.shape), t.dtype)
        for p, t in _tree.leaves_with_paths(drawn)]
    fg = FakeGrid()
    assert _spec_leaves(shd.param_specs(cfg, fg, meta)) == \
        _spec_leaves(shd.param_specs(cfg, fg, drawn))
    assert torch.device("meta") == _tree.leaves(meta)[0].device
