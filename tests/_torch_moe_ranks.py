"""The rank side of ``tests/test_torch_moe_mesh.py``.

Each of the test's gloo ranks runs :func:`run`: it starts the process
group from a ``file://`` store under the test's ``tmp_path``, runs every
scenario on ``DTensor``s over CPU meshes, and rank 0 saves what the test
compares (whole tensors, gathered) to ``result.pt``. This module imports
torch and the port only: the ranks never load JAX.
"""
import dataclasses
import datetime
import os
import traceback

import torch
import torch.distributed as dist

from repro_torch import _tree, configs, sharding
from repro_torch.data.pipeline import to_device
from repro_torch.launch import mesh as lmesh
from repro_torch.models import decode_step, prefill
from repro_torch.models import private_embed as pe
from repro_torch.models.config import ShapeConfig
from repro_torch.models.lm import init_params, params_from_arrays
from repro_torch.train import AdamWConfig, init_state, make_train_step
from repro_torch.train import step as tstep

AXES = ("data", "model")
#: AdamW moves an element by lr·g/(|g| + eps): by about lr wherever |g|
#: is well above eps. A gradient that is 0 but for float32 rounding (a
#: key bias's, whose softmax is shift-invariant, is 1e-10..1e-8 against
#: a typical 1e-3..1e-2) has its sign set by the reduction order, and at
#: the default eps of 1e-8 it moves its element by up to lr either way
#: (up to 5.6e-5 apart between the sharded and unsharded runs at lr
#: 3e-4). At eps 1e-5 such a gradient moves its element by under lr/100
#: and every other element still by about lr.
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10, eps=1e-5)
MOE = ("granite_moe_3b_a800m", "moonshot_v1_16b_a3b")
#: (tag, n_experts, dispatch, capacity factor) of the MoE variants
VARIANTS = [(f"E{e}-{d}{'' if d == 'einsum' else f'-{cf}'}", e, d, cf)
            for e in (4, 3)
            for d, cf in (("einsum", 1.25), ("sort", 1.25), ("sort", 0.5))]
#: (tag, arch, dispatch) of the prefill and decode cases
SERVE = [("granite-einsum", "granite_moe_3b_a800m", "einsum"),
         ("granite-sort", "granite_moe_3b_a800m", "sort"),
         ("moonshot-einsum", "moonshot_v1_16b_a3b", "einsum")]
SERVE_PROMPT, SERVE_STEPS = 6, 2
#: an expert d_ff that 4 model ranks do not divide
SHARED_WHOLE_FF = 30
#: (tag, arch, heads, KV heads) of the dense training layouts at (1, 4)
#: that the four-card runs take at full width: ChatGLM3's query heads
#: split while its 2 KV heads (and their biases) stay whole on every
#: rank, and InternVL2's query and KV heads both split (G = 2), with its
#: patches on the data axis
LAYOUTS_1X4 = [("chatglm3", "chatglm3_6b", 4, 2),
               ("internvl2", "internvl2_76b", 8, 4)]


def cfg_of(arch, **over):
    return dataclasses.replace(configs.smoke(arch), dtype="float32", **over)


def variant_cfg(arch, e, dispatch, cf):
    return cfg_of(arch, n_experts=e, moe_dispatch=dispatch,
                  capacity_factor=cf)


def _whole(tree):
    """A copy of every leaf, gathered whole (a collective: every rank
    calls it)."""
    return _tree.map_leaves(
        lambda t: t.full_tensor().clone() if hasattr(t, "full_tensor")
        else t.clone(), tree)


def _batch_on(cfg, mesh, batch):
    b, t = batch["tokens"].shape
    specs = sharding.batch_spec(cfg, mesh, ShapeConfig("b", t, b, "train"))
    return to_device(batch, "cpu", mesh=mesh, specs=specs)


def _router_grad(cfg, params, batch):
    """The first layer's router gradient, reduced and gathered whole."""
    leaves = tstep._trainable(params)
    _, grads = tstep._grads(cfg, params, leaves, batch)
    router = params["blocks"]["moe"]["router"]
    g = next(g for t, g in zip(leaves, grads) if t is router)
    return g.full_tensor().clone()


def _steps(cfg, mesh, params, batches, router=False):
    """-> (metrics of each step, the parameters after the steps, whole[,
    the router gradient at the first batch]) on ``mesh``."""
    params = sharding.distribute(
        params, mesh, sharding.param_shardings(cfg, mesh, params))
    opt = init_state(params)
    step = make_train_step(cfg, AdamWConfig(**OPT))
    out = {}
    if router:
        out["router_grad"] = _router_grad(cfg, params,
                                          _batch_on(cfg, mesh, batches[0]))
    metrics = []
    for b in batches:
        params, opt, m = step(params, opt, _batch_on(cfg, mesh, b))
        metrics.append({k: float(v) for k, v in m.items()})
    out["metrics"] = metrics
    out["params"] = _whole(params)
    out["placements"] = {p: [repr(x) for x in t.placements]
                         for p, t in _tree.leaves_with_paths(params)
                         if "moe" in p or "attn" in p}
    return out


def _families(inp, mesh, out):
    """(1) every family's two steps at (2, 2) from the port's weights."""
    for arch in inp["archs"]:
        cfg = cfg_of(arch)
        params = init_params(inp["seed"], cfg, device="cpu")
        out[f"family/{arch}"] = _steps(cfg, mesh, params,
                                       inp["family_batches"][arch])


def _variants(inp, mesh, out):
    """(2) the MoE variants at (2, 2) from the reference's weights, with
    the router gradient."""
    for arch in MOE:
        for tag, e, d, cf in VARIANTS:
            cfg = variant_cfg(arch, e, d, cf)
            params = params_from_arrays(inp["variant_params"][(arch, e)],
                                        device="cpu")
            out[f"variant/{arch}/{tag}"] = _steps(
                cfg, mesh, params, inp["moe_batches"], router=True)


def _one_expert_a_rank(inp, mesh, out):
    """(3) Moonlight at (1, 4): one expert a rank; and with an expert
    d_ff of 30, which 4 does not divide, the shared expert whole on every
    model rank beside the split experts."""
    arch = "moonshot_v1_16b_a3b"
    for d, cf in (("einsum", 1.25), ("sort", 0.5)):
        cfg = variant_cfg(arch, 4, d, cf)
        params = params_from_arrays(inp["variant_params"][(arch, 4)],
                                    device="cpu")
        out[f"1x4/{d}"] = _steps(cfg, mesh, params, inp["moe_batches"],
                                 router=True)
    cfg = cfg_of(arch, d_ff=SHARED_WHOLE_FF)
    out["1x4/shared-whole"] = _steps(
        cfg, mesh, init_params(inp["seed"], cfg, device="cpu"),
        inp["moe_batches"])


def layout_cfg(arch, heads, kv):
    return cfg_of(arch, n_heads=heads, n_kv_heads=kv)


def _layouts_1x4(inp, mesh, out):
    """(6) two steps of each dense layout of LAYOUTS_1X4 at (1, 4) from
    the reference's weights."""
    for tag, arch, heads, kv in LAYOUTS_1X4:
        cfg = layout_cfg(arch, heads, kv)
        params = params_from_arrays(inp["layout_params"][tag], device="cpu")
        out[f"1x4-train/{tag}"] = _steps(cfg, mesh, params,
                                         inp["layout_batches"][tag])


def _serve(inp, mesh, out):
    """(4) a prefill and greedy decode steps at (2, 2)."""
    spec = {"tokens": (sharding.dp_entry(mesh), None)}
    for tag, arch, d in SERVE:
        cfg = cfg_of(arch, moe_dispatch=d)
        params = init_params(inp["seed"], cfg, device="cpu")
        params = sharding.distribute(
            params, mesh, sharding.param_shardings(cfg, mesh, params))
        toks = inp["serve_tokens"]
        logits, cache = prefill(params, cfg, to_device(
            {"tokens": toks}, "cpu", mesh=mesh, specs=spec),
            max_len=SERVE_PROMPT + SERVE_STEPS)
        got = [logits.full_tensor()]
        for i in range(SERVE_STEPS):
            nxt = got[-1][:, -1].argmax(-1)[:, None].to(toks.dtype)
            logits, cache = decode_step(params, cfg, cache, SERVE_PROMPT + i,
                                        to_device({"tokens": nxt}, "cpu",
                                                  mesh=mesh, specs=spec))
            got.append(logits.full_tensor())
        out[f"serve/{tag}"] = got


def _private(inp, mesh, out):
    """(5) Granite's private-embedding step at (2, 2): the opened rows."""
    cfg = cfg_of("granite_moe_3b_a800m", private_embed=True)
    params = init_params(inp["seed"], cfg, device="cpu")
    seen = {}
    inner = pe.private_lookup_inline

    def lookup(p, c, tokens, **kw):
        rows = inner(p, c, tokens, **kw)
        seen["rows"] = rows.full_tensor().clone()
        seen["placements"] = [repr(x) for x in rows.placements]
        return rows

    pe.private_lookup_inline = lookup
    try:
        res = _steps(cfg, mesh, params, inp["moe_batches"][:1])
    finally:
        pe.private_lookup_inline = inner
    out["private"] = {"rows": seen["rows"], "placements": seen["placements"],
                      "metrics": res["metrics"]}


def run(rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/init",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
        mesh = lmesh.make_mesh((2, 2), AXES, device_type="cpu")
        _variants(inp, mesh, out)
        row = lmesh.make_mesh((1, 4), AXES, device_type="cpu")
        _one_expert_a_rank(inp, row, out)
        _layouts_1x4(inp, row, out)
        _serve(inp, mesh, out)
        _private(inp, mesh, out)
        _families(inp, mesh, out)
    except Exception:           # the test reads the traceback
        out["error"] = traceback.format_exc()
        with open(os.path.join(root, f"error{rank}.txt"), "w") as f:
            f.write(out["error"])
        raise
    finally:
        if rank == 0:
            torch.save(out, os.path.join(root, "result.pt"))
        dist.destroy_process_group()
