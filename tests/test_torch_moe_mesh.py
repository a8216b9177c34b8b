"""The MoE families on the production mesh, on 4 gloo ranks of the CPU.

One module fixture spawns 4 ranks (``tests/_torch_moe_ranks.py``; a
``file://`` store in ``tmp_path``) that run every scenario on a
("data", "model") ``DeviceMesh`` of the CPU, while this process runs the
port's unsharded path and the JAX reference on the same inputs; the tests
read what rank 0 saved. Smoke configurations in float32:

* every family of ``configs.ARCH_IDS``: two train steps at (2, 2) from
  the port's weights, the loss, grad norm and every parameter within
  1e-5 of the port's unsharded steps;
* Granite and Moonlight with 4 experts (split over ``model``: 2 a rank)
  and with 3 (they do not divide, so the expert FFN width splits), each
  with the einsum dispatch and the sort dispatch at capacity 1.25 and
  0.5, two steps at (2, 2) from the reference's weights: within 1e-5 of
  the port's unsharded steps and of the reference's, the router's
  gradient within 1e-5 of the unsharded one (not the model size times
  it); at 0.5 the unsharded layer drops pairs, so a rank that kept the
  pairs a local capacity keeps would differ;
* Moonlight at (1, 4), one expert a rank, and with an expert d_ff that
  4 does not divide, so the shared expert stays whole beside them;
* a MoE prefill and two greedy decode steps at (2, 2): logits within
  1e-5 of one device's, the greedy tokens equal;
* Granite's private-embedding step at (2, 2): the opened rows equal the
  unsharded lookup's bit for bit;
* two steps at (1, 4) of ChatGLM3 (4 query heads split, its 2 KV heads
  whole) and of InternVL2 at 8 query heads over 4 KV heads (both split)
  with its patches, from the reference's weights: within 1e-5 of the
  port's unsharded steps and of the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_moe_ranks as ranks
import repro.configs as jconfigs
from repro.models import lm as jlm
from repro.train import optim as jopt
from repro.train import step as jstep
from repro_torch import _tree, configs
from repro_torch.models import decode_step, prefill
from repro_torch.models import layers as L
from repro_torch.models import private_embed as pe
from repro_torch.models.lm import init_params, params_from_arrays, train_loss
from repro_torch.train import AdamWConfig, init_state, make_train_step
from repro_torch.train import step as tstep

WORLD = 4
TOL = 1e-5
SEED = 0
B, T = 4, 16


def _batches(vocab, seed, n=2, b=B, t=T, cfg=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        one = {k: rng.integers(0, vocab, (b, t)).astype(np.int32)
               for k in ("tokens", "labels")}
        if cfg is not None and cfg.n_enc_layers:
            one["frames"] = rng.standard_normal(
                (b, 8, cfg.frontend_dim)).astype(np.float32)
        if cfg is not None and cfg.frontend == "vit":
            one["patches"] = rng.standard_normal(
                (b, cfg.n_prefix, cfg.frontend_dim)).astype(np.float32)
        out.append(one)
    return out


def _layout_jcfg(arch, heads, kv):
    return dataclasses.replace(jconfigs.smoke(arch), dtype="float32",
                               n_heads=heads, n_kv_heads=kv)


def _jcfg(arch, e, dispatch, cf):
    return dataclasses.replace(jconfigs.smoke(arch), dtype="float32",
                               n_experts=e, moe_dispatch=dispatch,
                               capacity_factor=cf)


def _port_steps(cfg, params, batches, router=False):
    """The port's unsharded steps -> the rank side's record."""
    opt = init_state(params)
    step = make_train_step(cfg, AdamWConfig(**ranks.OPT))
    out = {}
    if router:
        leaves = tstep._trainable(params)
        _, grads = tstep._grads(cfg, params, leaves, {
            k: torch.as_tensor(v) for k, v in batches[0].items()})
        r = params["blocks"]["moe"]["router"]
        out["router_grad"] = next(g for t, g in zip(leaves, grads)
                                  if t is r)
    metrics = []
    for b in batches:
        params, opt, m = step(params, opt, {k: torch.as_tensor(v)
                                            for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    out["metrics"] = metrics
    out["params"] = params
    return out


def _reference_steps(jcfg, jp, batches):
    """The reference's unsharded steps -> (metrics, parameters as
    numpy in flatten order)."""
    step = jax.jit(jstep.make_train_step(jcfg,
                                         jopt.AdamWConfig(**ranks.OPT)))
    state, metrics = jopt.init_state(jp), []
    for b in batches:
        jp, state, m = step(jp, state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "params": jax.tree.leaves(jax.tree.map(np.asarray, jp))}


def _dropped(cfg, params, batch):
    """Pairs the unsharded sort dispatch drops in the first forward."""
    seen = []
    inner = L._moe_sort_dispatch

    def spy(p, c, x2, weights, idx, *a, **kw):
        cap = int(np.ceil(x2.shape[0] * c.top_k / c.n_experts
                          * c.capacity_factor))
        counts = torch.bincount(idx.reshape(-1), minlength=c.n_experts)
        seen.append(int((counts - cap).clamp(min=0).sum()))
        return inner(p, c, x2, weights, idx, *a, **kw)

    L._moe_sort_dispatch = spy
    try:
        with torch.no_grad():
            train_loss(params, cfg, {k: torch.as_tensor(v)
                                     for k, v in batch.items()})
    finally:
        L._moe_sort_dispatch = inner
    return sum(seen)


def _serve_unsharded(cfg, params, toks):
    logits, cache = prefill(params, cfg, {"tokens": toks},
                            max_len=ranks.SERVE_PROMPT + ranks.SERVE_STEPS)
    got = [logits]
    for i in range(ranks.SERVE_STEPS):
        nxt = got[-1][:, -1].argmax(-1)[:, None].to(toks.dtype)
        logits, cache = decode_step(params, cfg, cache,
                                    ranks.SERVE_PROMPT + i, {"tokens": nxt})
        got.append(logits)
    return got


def _unsharded(inp):
    """Everything the ranks' results are held against, run here while
    the ranks run."""
    want = {}
    for arch in inp["archs"]:
        cfg = ranks.cfg_of(arch)
        want[f"family/{arch}"] = _port_steps(
            cfg, init_params(SEED, cfg, device="cpu"),
            inp["family_batches"][arch])
    for arch in ranks.MOE:
        for tag, e, d, cf in ranks.VARIANTS:
            cfg = ranks.variant_cfg(arch, e, d, cf)
            arrays = inp["variant_params"][(arch, e)]
            key = f"variant/{arch}/{tag}"
            want[key] = _port_steps(
                cfg, params_from_arrays(arrays, device="cpu"),
                inp["moe_batches"], router=True)
            want[key]["reference"] = _reference_steps(
                _jcfg(arch, e, d, cf),
                jax.tree.map(jnp.asarray, arrays), inp["moe_batches"])
            if d == "sort":
                want[key]["dropped"] = _dropped(
                    cfg, params_from_arrays(arrays, device="cpu"),
                    inp["moe_batches"][0])
    cfg = ranks.cfg_of("moonshot_v1_16b_a3b", d_ff=ranks.SHARED_WHOLE_FF)
    want["1x4/shared-whole"] = _port_steps(
        cfg, init_params(SEED, cfg, device="cpu"), inp["moe_batches"])
    for tag, arch, d in ranks.SERVE:
        cfg = ranks.cfg_of(arch, moe_dispatch=d)
        want[f"serve/{tag}"] = _serve_unsharded(
            cfg, init_params(SEED, cfg, device="cpu"), inp["serve_tokens"])
    for tag, arch, heads, kv in ranks.LAYOUTS_1X4:
        arrays = inp["layout_params"][tag]
        key = f"1x4-train/{tag}"
        want[key] = _port_steps(ranks.layout_cfg(arch, heads, kv),
                                params_from_arrays(arrays, device="cpu"),
                                inp["layout_batches"][tag])
        want[key]["reference"] = _reference_steps(
            _layout_jcfg(arch, heads, kv), jax.tree.map(jnp.asarray, arrays),
            inp["layout_batches"][tag])
    cfg = ranks.cfg_of("granite_moe_3b_a800m", private_embed=True)
    want["private"] = pe.private_lookup_inline(
        init_params(SEED, cfg, device="cpu"), cfg,
        torch.as_tensor(inp["moe_batches"][0]["tokens"]))
    return want


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the ranks, run the unsharded paths meanwhile -> (rank 0's
    results, the unsharded results)."""
    root = tmp_path_factory.mktemp("moe_mesh")
    inp = {"seed": SEED, "archs": list(configs.ARCH_IDS),
           "family_batches": {
               a: _batches(256, 7, cfg=configs.smoke(a), t=8)
               for a in configs.ARCH_IDS},
           "moe_batches": _batches(256, 3),
           "serve_tokens": torch.from_numpy(np.random.default_rng(5)
                                            .integers(0, 256, (B, 6))),
           "variant_params": {}, "layout_params": {},
           "layout_batches": {}}
    for tag, arch, heads, kv in ranks.LAYOUTS_1X4:
        jcfg = _layout_jcfg(arch, heads, kv)
        jp = jlm.init_params(jax.random.PRNGKey(1), jcfg)
        inp["layout_params"][tag] = jax.tree.map(np.asarray, jp)
        inp["layout_batches"][tag] = _batches(256, 11, cfg=jcfg)
    for arch in ranks.MOE:
        for e in (4, 3):
            jp = jlm.init_params(jax.random.PRNGKey(0),
                                 _jcfg(arch, e, "einsum", 1.25))
            inp["variant_params"][(arch, e)] = jax.tree.map(np.asarray, jp)
    torch.save(inp, root / "inputs.pt")
    ctx = mp.spawn(ranks.run, args=(WORLD, str(root)), nprocs=WORLD,
                   join=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # the ranks hold a core each meanwhile
    try:
        want = _unsharded(inp)
    finally:
        torch.set_num_threads(threads)
    while not ctx.join():
        pass
    out = torch.load(root / "result.pt", weights_only=False)
    assert "error" not in out, out.get("error")
    return out, want


def _close(got, want, what):
    for k in ("loss", "grad_norm"):
        for g, w in zip(got["metrics"], want["metrics"]):
            assert abs(g[k] - w[k]) <= TOL, (what, k, g[k], w[k])


def _params_close(got, want, what):
    gl = _tree.leaves(got)
    wl = [torch.as_tensor(np.array(w)) for w in (
        want if isinstance(want, list) else _tree.leaves(want))]
    assert len(gl) == len(wl)
    worst = max(float((g - w).abs().max()) for g, w in zip(gl, wl))
    assert worst <= TOL, (what, worst)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_every_family_steps_on_the_mesh(run, arch):
    out, want = run
    got, w = out[f"family/{arch}"], want[f"family/{arch}"]
    assert len(got["metrics"]) == 2
    _close(got, w, arch)
    _params_close(got["params"], w["params"], arch)


VARIANT_IDS = [f"{a}/{t}" for a in ranks.MOE for t, *_ in ranks.VARIANTS]


@pytest.mark.parametrize("key", VARIANT_IDS)
def test_moe_variant_matches_port_and_reference(run, key):
    out, want = run
    got, w = out[f"variant/{key}"], want[f"variant/{key}"]
    _close(got, w, key)
    _close(got, w["reference"], key)
    _params_close(got["params"], w["params"], key)
    _params_close(got["params"], w["reference"]["params"], key)


@pytest.mark.parametrize("key", VARIANT_IDS)
def test_router_gradient_is_the_unsharded_one(run, key):
    out, want = run
    got = out[f"variant/{key}"]["router_grad"]
    w = want[f"variant/{key}"]["router_grad"]
    assert float(w.abs().max()) > 100 * TOL
    assert float((got - w).abs().max()) <= TOL, key


@pytest.mark.parametrize("key", [k for k in VARIANT_IDS if "sort" in k])
def test_sort_capacity_drops_where_the_reference_does(run, key):
    """At capacity 0.5 the unsharded layer drops pairs (and the mesh
    still matches it, above); at 1.25 the drops, if any, are fewer."""
    _, want = run
    dropped = want[f"variant/{key}"]["dropped"]
    if key.endswith("-0.5"):
        assert dropped > 0
        assert dropped > want[f"variant/{key[:-4]}-1.25"]["dropped"]


@pytest.mark.parametrize("key", ["E4-einsum", "E3-einsum"])
@pytest.mark.parametrize("arch", ranks.MOE)
def test_experts_split_or_their_ffn_width(run, arch, key):
    """4 experts split over 2 model ranks (dim 1 of the stacked (L, E, D,
    F) weights); 3 do not, so the FFN width splits (dim 3, and dim 2 of
    ``w_down``); the router stays whole."""
    pls = run[0][f"variant/{arch}/{key}"]["placements"]
    if key == "E4-einsum":
        want_up, want_down = "Shard(dim=1)", "Shard(dim=1)"
    else:
        want_up, want_down = "Shard(dim=3)", "Shard(dim=2)"
    assert pls["blocks/moe/w_up"] == ["Replicate()", want_up]
    assert pls["blocks/moe/w_down"] == ["Replicate()", want_down]
    assert pls["blocks/moe/router"] == ["Replicate()", "Replicate()"]


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_one_expert_a_rank(run, dispatch):
    out, want = run
    got = out[f"1x4/{dispatch}"]
    tag = "E4-einsum" if dispatch == "einsum" else "E4-sort-0.5"
    w = want[f"variant/moonshot_v1_16b_a3b/{tag}"]
    assert got["placements"]["blocks/moe/w_gate"] == ["Replicate()",
                                                       "Shard(dim=1)"]
    _close(got, w, dispatch)
    _params_close(got["params"], w["params"], dispatch)
    assert float((got["router_grad"] - w["router_grad"]).abs().max()) \
        <= TOL


def test_shared_expert_whole_beside_split_experts(run):
    """Moonlight at (1, 4) with an expert d_ff of 30: the experts split
    (one a rank), the shared expert's FFN does not divide 4 and stays
    whole, and its output is added on one model rank of the four."""
    out, want = run
    got, w = out["1x4/shared-whole"], want["1x4/shared-whole"]
    assert got["placements"]["blocks/moe/w_up"] == ["Replicate()",
                                                     "Shard(dim=1)"]
    assert got["placements"]["blocks/moe/shared/w_up"] == ["Replicate()",
                                                            "Replicate()"]
    _close(got, w, "shared-whole")
    _params_close(got["params"], w["params"], "shared-whole")


@pytest.mark.parametrize("tag", [t for t, *_ in ranks.SERVE])
def test_moe_prefill_and_decode_on_the_mesh(run, tag):
    out, want = run
    got, w = out[f"serve/{tag}"], want[f"serve/{tag}"]
    assert len(got) == len(w) == 1 + ranks.SERVE_STEPS
    for g, x in zip(got, w):
        assert g.shape == x.shape
        assert float((g - x).abs().max()) <= TOL, tag
        assert torch.equal(g[:, -1].argmax(-1), x[:, -1].argmax(-1))


def test_private_step_rows_equal_the_unsharded_lookup(run):
    out, want = run
    got = out["private"]
    assert torch.equal(got["rows"], want["private"])
    assert got["placements"] == ["Shard(dim=0)", "Replicate()"]
    assert np.isfinite(got["metrics"][0]["loss"])


@pytest.mark.parametrize("tag", [t for t, *_ in ranks.LAYOUTS_1X4])
def test_one_by_four_training_matches_port_and_reference(run, tag):
    """ChatGLM3's ``wq``/``bq``/``wo`` split over the 4 model ranks and its
    ``wk``/``wv``/``bk``/``bv`` whole (their gradients partial, reduced);
    InternVL2's query and KV projections both split, its patches' rows on
    the data axis."""
    out, want = run
    key = f"1x4-train/{tag}"
    got, w = out[key], want[key]
    pls = got["placements"]
    attn = {p.rsplit("/", 1)[1]: v for p, v in pls.items()
            if p.startswith("blocks/attn/")}
    assert attn["wq"] == ["Replicate()", "Shard(dim=2)"]
    assert attn["wo"] == ["Replicate()", "Shard(dim=1)"]
    kv = "Replicate()" if tag == "chatglm3" else "Shard(dim=2)"
    assert attn["wk"] == attn["wv"] == ["Replicate()", kv]
    if tag == "chatglm3":
        assert attn["bk"] == attn["bv"] == ["Replicate()", "Replicate()"]
        assert attn["bq"] == ["Replicate()", "Shard(dim=1)"]
    assert len(got["metrics"]) == 2
    _close(got, w, key)
    _close(got, w["reference"], key)
    _params_close(got["params"], w["params"], key)
    _params_close(got["params"], w["reference"]["params"], key)
