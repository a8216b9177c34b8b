"""The port's training path (``repro_torch.models.lm.train_loss`` with
remat, ``repro_torch.train``) against the reference's.

The reference's parameters are carried across with ``params_from_arrays``
and both packages take the same numpy batches (tokens, labels with a
masked position, frontend inputs) at float32 smoke configs:

* ``train_loss`` within 1e-5 and every parameter's gradient within a
  relative 1e-4 (``‖Δg‖ / ‖g‖``) for every architecture, MoE on both
  dispatches, and the private embedding on every family one card trains
  in ``chip_smoke.py`` (the lookup is detached in both: an untied
  ``embed`` gets no gradient in the port and zeros in the reference, a
  tied one the head's alone);
* ``chip_smoke.train_batch``, the batches the card trains a family with a
  frontend on, has the keys, shapes and dtypes of the reference's
  smoke-test batch;
* remat changes no loss or gradient; fully masked labels give loss 0;
* ``schedule`` and ``apply_updates`` on identical gradients within 1e-6,
  a zero gradient (``None`` in the port) included, and the update in
  slices equal to the update whole;
* ``make_train_step`` at ``grad_accum`` 1 and 2 with ``compress`` off and
  on: ``loss``, ``lr`` and ``grad_norm`` within 1e-5; parameters after a
  step within ``lr`` of the reference's. AdamW's first step moves an
  element by about ``sign(g)·lr``, so where ``|g|`` is within float32
  rounding of zero (or an int8 block rounds it to 0 or ±1) the two
  packages may move that element by up to ``lr`` apart; elsewhere they
  agree within 1e-6;
* ``make_serve_steps`` runs the port's ``prefill`` and ``decode_step``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import lm as jlm
from repro.train import optim as jopt
from repro.train import step as jstep
from repro_torch import _tree
from repro_torch.models import lm as tlm
from repro_torch.train import optim as topt
from repro_torch.train import step as tstep

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
OPT_TOL = 1e-6
B, T, N_FRAMES = 2, 12, 8

#: (case id, arch, config overrides)
CASES = [(a, a, {}) for a in jconfigs.ARCH_IDS] + [
    ("granite_moe_3b_a800m-sort", "granite_moe_3b_a800m",
     {"moe_dispatch": "sort"}),
    ("moonshot_v1_16b_a3b-sort", "moonshot_v1_16b_a3b",
     {"moe_dispatch": "sort"}),
    ("qwen1_5_4b-private", "qwen1_5_4b", {"private_embed": True}),
] + [(f"{a}-private", a, {"private_embed": True}) for a in (
    "gemma3_1b", "minicpm3_4b", "mamba2_2_7b", "hymba_1_5b",
    "seamless_m4t_medium")]


def _cfgs(arch, **over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(jconfigs.smoke(arch), **over),
            dataclasses.replace(tconfigs.smoke(arch), **over))


def _batch(cfg, b=B, t=T, seed=1):
    """numpy tokens, labels (one masked position) and frontend inputs."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(
        np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, t)).astype(
        np.int32)}
    out["labels"][0, 3] = -1
    if cfg.n_enc_layers:
        out["frames"] = rng.standard_normal(
            (b, N_FRAMES, cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "vit":
        out["patches"] = rng.standard_normal(
            (b, cfg.n_prefix, cfg.frontend_dim)).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


_PAIRS = {}


def _pair(case):
    """(jcfg, tcfg, reference params, port params, numpy batch), one per
    case for the module."""
    if case not in _PAIRS:
        _, arch, over = next(c for c in CASES if c[0] == case)
        jcfg, tcfg = _cfgs(arch, **over)
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        tp = tlm.params_from_arrays(jax.tree.map(np.asarray, jp),
                                    device="cpu")
        _PAIRS[case] = (jcfg, tcfg, jp, tp, _batch(jcfg))
    return _PAIRS[case]


def _port_grads(tcfg, tp, batch):
    leaves = tstep._trainable(tp)
    loss, grads = tstep._grads(tcfg, tp, leaves, _t(batch))
    return loss, grads


def _rel(got, want) -> float:
    den = float(np.linalg.norm(want))
    return float(np.linalg.norm(got - want)) / (den if den else 1.0)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_train_loss_and_grads_match_reference(case):
    jcfg, tcfg, jp, tp, batch = _pair(case)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.train_loss(p, jcfg, _j(batch)), has_aux=True))(jp)
    tl, tm = tlm.train_loss(tp, tcfg, _t(batch))
    assert abs(float(tl) - float(jl)) <= LOSS_ATOL
    assert float(tm["tokens"]) == float(jm["tokens"]) == B * T - 1
    loss, grads = _port_grads(tcfg, tp, batch)
    assert abs(float(loss) - float(jl)) <= LOSS_ATOL
    names = [n for n, _ in _tree.leaves_with_paths(tp)]
    want = [np.asarray(g) for g in jax.tree.leaves(jg)]
    assert len(grads) == len(want) == len(names)
    for name, g, w in zip(names, grads, want):
        if g is None:                # the loss does not reach the leaf
            assert not np.any(w), name
            continue
        assert _rel(g.numpy(), w) <= GRAD_RTOL, (name, _rel(g.numpy(), w))
    if tcfg.private_embed and not tcfg.tie_embeddings:
        assert grads[names.index("embed")] is None


@pytest.mark.parametrize("case", ["qwen1_5_4b", "hymba_1_5b",
                                  "seamless_m4t_medium"])
def test_remat_changes_nothing(case, monkeypatch):
    """With ``cfg.remat`` a training forward under autograd checkpoints
    each decoder block (not the encoder's, as the reference), and the
    recomputed activations give the loss and gradients of the forward
    that keeps them; without autograd nothing is checkpointed."""
    _, tcfg, _, tp, batch = _pair(case)
    assert tcfg.remat
    calls = []

    def counting(fn, *a, **kw):
        calls.append(kw.get("use_reentrant"))
        return torch.utils.checkpoint.checkpoint(fn, *a, **kw)

    monkeypatch.setattr(tlm, "checkpoint", counting)
    la, ga = _port_grads(tcfg, tp, batch)
    assert calls == [False] * tcfg.n_layers
    lb, gb = _port_grads(dataclasses.replace(tcfg, remat=False), tp, batch)
    with torch.no_grad():
        tlm.train_loss(tp, tcfg, _t(batch))
    assert len(calls) == tcfg.n_layers
    assert torch.equal(la, lb)
    for a, b in zip(ga, gb):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)


def test_fully_masked_labels_give_zero_loss():
    jcfg, tcfg, jp, tp, batch = _pair("internvl2_76b")
    batch = dict(batch, labels=np.full_like(batch["labels"], -1))
    jl, jm = jlm.train_loss(jp, jcfg, _j(batch))
    tl, tm = tlm.train_loss(tp, tcfg, _t(batch))
    assert float(tl) == float(jl) == 0.0
    assert float(tm["tokens"]) == float(jm["tokens"]) == 0.0


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-2, warmup_steps=3, total_steps=12)


def test_schedule_matches_reference():
    cfg_j, cfg_t = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    for s in range(0, 16):
        want = float(jopt.schedule(cfg_j, jnp.asarray(s, jnp.int32)))
        got = float(topt.schedule(cfg_t, torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= OPT_TOL * max(abs(want), 1e-3), s


def _opt_trees(seed=0):
    """A parameter tree with a stacked (L, d) norm (decayed: 2-D), a 1-D
    norm, a 0-d gate and matrices, and gradients for it; ``frozen`` gets
    none (``None`` in the port, zeros in the reference)."""
    rng = np.random.default_rng(seed)
    shapes = {"blocks": {"ln1": (3, 8), "w": (3, 8, 5)}, "final_norm": (8,),
              "mix": (), "frozen": (6, 8)}

    def draw(node, scale):
        if isinstance(node, dict):
            return {k: draw(v, scale) for k, v in node.items()}
        return np.asarray(rng.standard_normal(node) * scale, np.float32)

    params, grads = draw(shapes, 1.0), draw(shapes, 3.0)
    grads["frozen"] = None
    return params, grads


@pytest.mark.parametrize("chunk", [None, 8])
def test_apply_updates_matches_reference(chunk, monkeypatch):
    if chunk:                        # slices of one layer (8 elements)
        monkeypatch.setattr(topt, "CHUNK", chunk)
    params, grads = _opt_trees()
    jcfg, tcfg = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    jp = jax.tree.map(jnp.asarray, params)
    tp = _tree.map_leaves(lambda a: torch.from_numpy(a.copy()), params)
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    for _ in range(4):
        jg = _tree.map_leaves(lambda p, g: jnp.zeros(p.shape) if g is None
                              else jnp.asarray(g), params, grads)
        tg = _tree.map_leaves(lambda g: None if g is None
                              else torch.from_numpy(g), grads)
        jp, js, jm = jopt.apply_updates(jcfg, jp, jg, js)
        tp2, ts2, tm = topt.apply_updates(tcfg, tp, tg, ts)
        assert tp2 is tp and ts2 is ts         # in place
        for k in ("lr", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= OPT_TOL * abs(
                float(jm[k]))
    assert int(ts.step) == int(js.step) == 4
    for tree_t, tree_j in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for (name, a), b in zip(_tree.leaves_with_paths(tree_t),
                                jax.tree.leaves(tree_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=OPT_TOL, atol=OPT_TOL,
                                       err_msg=name)
    # the reference's rule: the stacked norm (3, 8) and the gradient-less
    # matrix decay; the 1-D norm and the 0-d gate do not
    assert not np.allclose(tp["frozen"].numpy(), params["frozen"])


def test_global_norm_skips_none():
    g = {"a": torch.tensor([3.0, 4.0]), "b": None}
    assert float(topt.global_norm(g)) == 5.0
    assert float(topt.global_norm({"b": None})) == 0.0


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum,compress", [(1, False), (2, False),
                                            (1, True), (2, True)])
def test_make_train_step_matches_reference(accum, compress):
    jcfg, tcfg, jp, _, _ = _pair("qwen1_5_4b")
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _batch(jcfg, b=4)
    if accum > 1:                    # microbatch-major
        batch = {k: v.reshape((accum, -1) + v.shape[1:])
                 for k, v in batch.items()}
    tp = tlm.params_from_arrays(jax.tree.map(np.asarray, jp), device="cpu")
    jfn = jstep.make_train_step(jcfg, jopt.AdamWConfig(**opt),
                                grad_accum=accum, compress=compress)
    tfn = tstep.make_train_step(tcfg, topt.AdamWConfig(**opt),
                                grad_accum=accum, compress=compress)
    jp2, js2, jm = jax.jit(jfn)(jp, jopt.init_state(jp), _j(batch))
    ts = topt.init_state(tp)
    tp2, ts2, tm = tfn(tp, ts, _t(batch))
    assert tp2 is tp and ts2 is ts
    for k in ("loss", "lr", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * max(
            1.0, abs(float(jm[k]))), k
    lr = float(jm["lr"])
    for (name, a), b in zip(_tree.leaves_with_paths(tp2),
                            jax.tree.leaves(jp2)):
        d = np.abs(a.numpy() - np.asarray(b))
        assert d.max() <= lr * 1.001, (name, d.max())
        assert np.mean(d > OPT_TOL) <= 0.01, (name, np.mean(d > OPT_TOL))
    assert not any(t.requires_grad for t in _tree.leaves(tp2))


def test_train_step_private_embed_decays_untied_embed():
    """With the private lookup the untied ``embed`` gets no gradient, but
    AdamW still decays it (the reference's zeros): p·(1 − lr·wd)."""
    jcfg, tcfg, jp, _, batch = _pair("qwen1_5_4b-private")
    tp = tlm.params_from_arrays(jax.tree.map(np.asarray, jp), device="cpu")
    before = tp["embed"].clone()
    opt = topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    fn = tstep.make_train_step(tcfg, opt)
    _, _, m = fn(tp, topt.init_state(tp), _t(batch))
    lr = float(m["lr"])
    np.testing.assert_allclose(tp["embed"].numpy(),
                               before.numpy() * (1 - lr * 0.1), rtol=1e-6)


def test_make_serve_steps_runs_prefill_and_decode():
    _, tcfg, _, tp, batch = _pair("qwen1_5_4b")
    prefill_fn, decode_fn = tstep.make_serve_steps(tcfg)
    toks = torch.as_tensor(batch["tokens"])
    logits, cache = prefill_fn(tp, {"tokens": toks})
    want, _ = tlm.prefill(tp, tcfg, {"tokens": toks})
    assert torch.equal(logits, want)
    cache_big = tlm.prefill(tp, tcfg, {"tokens": toks}, max_len=T + 1)[1]
    nxt = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
    out, _ = decode_fn(tp, cache_big, T, {"tokens": nxt})
    full = tlm.forward(tp, tcfg, {"tokens": torch.cat([toks, nxt], 1)})
    torch.testing.assert_close(out[:, 0], full[:, T], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["seamless_m4t_medium", "internvl2_76b",
                                  "qwen1_5_4b"])
def test_chip_smoke_train_batch_matches_reference_make_batch(arch):
    """``chip_smoke.train_batch`` (the batches the card trains
    SeamlessM4T-medium on, its frames beside the launcher's tokens) has
    the keys, shapes and dtypes of the reference's smoke-test batch
    (``tests/test_arch_smoke.py`` ``make_batch``: tokens and labels (2,
    16), 8 frames or ``n_prefix`` patches) at the smoke configuration,
    and the port trains on it."""
    import importlib
    import pathlib
    import sys

    from test_arch_smoke import B as MB, T as MT, make_batch

    from repro_torch.data import TokenStream
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    chip_smoke = importlib.import_module("chip_smoke")
    jcfg, tcfg = jconfigs.smoke(arch), tconfigs.smoke(arch)
    want = make_batch(jcfg, jax.random.PRNGKey(0))
    frontend = {"audio": ("frames", 8),
                "vit": ("patches", tcfg.n_prefix)}.get(tcfg.frontend)
    got = chip_smoke.train_batch(
        tcfg, TokenStream(tcfg.vocab_size, MB, MT, seed=3), 5, frontend,
        seed=3)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == tuple(w.shape), k
        assert got[k].dtype == np.dtype(w.dtype), k
    loss, _ = tlm.train_loss(tlm.init_params(0, tcfg, device="cpu"), tcfg,
                             _t(got))
    assert np.isfinite(float(loss))
