"""The rank side of ``tests/test_torch_production_mesh.py``.

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
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.data.pipeline import to_device
from repro_torch.kernels import ops
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import train as ltrain
from repro_torch.models import private_embed as pe
from repro_torch.models.lm import params_from_arrays
from repro_torch.train import AdamWConfig, init_state, make_train_step

AXES = ("data", "model")


def _whole(tree):
    """A copy of every leaf, gathered whole (a collective: every rank
    calls it; a replicated leaf's ``full_tensor`` is the leaf itself)."""
    return _tree.map_leaves(
        lambda t: t.full_tensor().clone() if hasattr(t, "full_tensor")
        else t, tree)


def _placements(tree):
    return [(p, [repr(x) for x in t.placements])
            for p, t in _tree.leaves_with_paths(tree)
            if hasattr(t, "placements")]


def _train(inp, mesh, out):
    """Two sharded steps, then an accumulation-2 step with int8
    compression, from the reference's parameters."""
    cfg = dataclasses.replace(configs.smoke("qwen1_5_4b"), dtype="float32")
    params = params_from_arrays(inp["params"], device="cpu")
    shardings = sharding.param_shardings(cfg, mesh, params)
    params = sharding.distribute(params, mesh, shardings)
    opt = init_state(params)
    ocfg = AdamWConfig(**inp["opt"])
    plain = make_train_step(cfg, ocfg)
    accum = make_train_step(cfg, ocfg, grad_accum=2, compress=True)
    dp = sharding.dp_entry(mesh)
    metrics = []
    for i, batch in enumerate(inp["batches"]):
        row = (dp, None) if i < 2 else (None, dp, None)
        tb = to_device(batch, "cpu", mesh=mesh,
                       specs={"tokens": row, "labels": row})
        fn = plain if i < 2 else accum
        params, opt, m = fn(params, opt, tb)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 1:
            out["params_after_2"] = _whole(params)
    out["train_metrics"] = metrics
    out["train_params"] = _whole(params)
    out["train_opt_m"] = _whole(opt.m)
    out["train_placements"] = _placements(params)
    out["grad_placements_ok"] = all(
        tuple(a.placements) == tuple(b.placements)
        for a, b in zip(_tree.leaves(params), _tree.leaves(opt.m))
        if hasattr(a, "placements"))
    return params, opt, shardings


def _lookup(inp, mesh, out, tag):
    """The private lookup with the vocabulary split over ``model``."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = dataclasses.replace(configs.smoke("qwen1_5_4b"), dtype="float32")
    embed = inp["embed"]
    tokens = inp["lookup_tokens"]
    if mesh.get_coordinate() is None:     # a rank outside a sub-mesh
        return
    model = mesh.mesh_dim_names.index("model")
    data = mesh.mesh_dim_names.index("data")
    tpl = [Replicate()] * mesh.ndim
    tpl[data] = Shard(0)
    dtok = sharding.place(tokens, mesh, tpl)
    rows = {}
    for name, table, vdim in (
            ("embed", embed, 0),
            ("embed_shares", inp["embed_shares"], 1)):
        pl = [Replicate()] * mesh.ndim
        pl[model] = Shard(vdim)
        params = {name: sharding.place(table, mesh, pl)}
        ops.reset_launch_counts()
        got = pe.private_lookup_inline(params, cfg, dtok, key=(7,))
        rows[name] = (got.full_tensor(), [repr(p) for p in got.placements],
                      tuple(got.to_local().shape))
    if dist.get_rank() == 0:
        out[f"lookup_{tag}"] = rows


def _checkpoint(inp, mesh, out, params, opt, shardings):
    """Save at the training mesh; restore at (4, 1) and (1, 4)."""
    root = inp["root"]
    ck = os.path.join(root, "ckpt")
    save_checkpoint(ck, 3, (params, opt))
    dist.barrier()
    cfg = dataclasses.replace(configs.smoke("qwen1_5_4b"), dtype="float32")
    for shape in ((4, 1), (1, 4)):
        m2 = lmesh.make_mesh(shape, AXES, device_type="cpu")
        p_sh = sharding.param_shardings(cfg, m2, out["train_params"])
        o_sh = type(opt)(step=sharding.NamedSharding(m2, sharding.REP),
                         m=p_sh, v=p_sh)
        step, (p2, o2) = restore_checkpoint(ck, (params, opt),
                                            shardings=(p_sh, o_sh))
        out[f"restored_{shape[0]}x{shape[1]}"] = (
            step, _whole(p2), _whole(o2.m), _placements(p2))


def _roundtrip(inp, mesh, out):
    """The int8 roundtrip of a (3, 6, 50) leaf split on dim 2 over
    ``model``, and on dim 1 over ``data`` and dim 2 over ``model``."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.train.compress import roundtrip_
    for tag, pls in (("model", [Replicate(), Shard(2)]),
                     ("data_model", [Shard(1), Shard(2)])):
        g = sharding.place(inp["grad"], mesh, pls)
        out[f"roundtrip_{tag}"] = roundtrip_(g).full_tensor()


#: the serving cases on real ranks: (tag, grid, arch, config fields
#: replaced, decode steps' token counts, batch). At (2, 2) Qwen's heads
#: split over ``model``; at (1, 4) with 2 heads its attention runs whole
#: on every model rank. ChatGLM3's and InternVL2's 4 query heads split over
#: a model axis of 4 and their 2 KV heads do not: the cache splits on its
#: sequence (the reference's replicated-KV, context-parallel case).
#: MiniCPM3 at 6 heads keeps its MLA weights whole, its latent cache split
#: on its sequence. A two-token step writes into a filled cache. At (1, 4)
#: and batches of one and two: Mamba-2 and Hymba with their 8 SSM heads
#: split (2 a rank), SeamlessM4T with its frames projection split on
#: d_model and its 4 cross-attention heads split, and Gemma3 with 4 query
#: heads over one KV head and its sliding window of 8 crossed.
SERVE_CASES = (
    ("2x2", (2, 2), "qwen1_5_4b", {}, (1, 1), 4),
    ("1x4", (1, 4), "qwen1_5_4b", {"n_heads": 2, "n_kv_heads": 2}, (1, 1),
     4),
    ("1x4_chatglm3", (1, 4), "chatglm3_6b", {}, (1, 1, 2), 4),
    ("1x4_internvl2", (1, 4), "internvl2_76b", {}, (1, 1), 4),
    ("1x4_minicpm3", (1, 4), "minicpm3_4b", {"n_heads": 6, "n_kv_heads": 6},
     (1, 1, 2), 4),
) + tuple(
    (f"1x4_{name}_b{b}", (1, 4), arch, {}, (1, 1, 2), b)
    for name, arch in (("mamba2", "mamba2_2_7b"), ("hymba", "hymba_1_5b"),
                       ("seamless", "seamless_m4t_medium"),
                       ("gemma3", "gemma3_1b"))
    for b in (1, 2))


def serve_batches(inp, cfg, steps, batch=4):
    """-> (the 6-token prompt's batch, the decode steps' batches) of the
    first ``batch`` rows: the prompt is the first 6 of
    ``inp["serve_tokens"]``, each one-token step the next token, a
    two-token step the prompt's first two again; a ViT prefix's patches and
    an encoder's frames go with the prompt."""
    toks = inp["serve_tokens"][:batch]
    first = {"tokens": toks[:, :6]}
    if cfg.frontend == "vit":
        first["patches"] = inp["serve_patches"][:batch]
    if cfg.n_enc_layers:
        first["frames"] = inp["serve_frames"][:batch]
    later, pos = [], 6
    for n in steps:
        later.append({"tokens": toks[:, pos:pos + 1] if n == 1
                      else toks[:, :n]})
        pos += n
    return first, later


def _serve(inp, out, cases=SERVE_CASES):
    """A prefill and the decode steps of every case of ``cases`` on its
    grid: the logits, the cache gathered whole, and the placements of the
    cache and of the attention (or SSM) weights."""
    from repro_torch.models import decode_step, init_params, prefill
    for tag, shape, arch, over, steps, batch in cases:
        m = lmesh.make_mesh(shape, AXES, device_type="cpu")
        cfg = dataclasses.replace(configs.smoke(arch), dtype="float32",
                                  **over)
        params = init_params(11, cfg, device="cpu")
        params = sharding.distribute(
            params, m, sharding.param_shardings(cfg, m, params))
        dp = sharding.dp_entry(m)
        specs = {"tokens": (dp, None), "patches": (dp, None, None),
                 "frames": (dp, None, None)}
        first, later = serve_batches(inp, cfg, steps, batch)
        prefix = cfg.n_prefix if cfg.frontend == "vit" else 0
        pos = prefix + 6
        logits, cache = prefill(params, cfg, to_device(
            first, "cpu", mesh=m, specs=specs), max_len=pos + sum(steps))
        got = [logits.full_tensor()]
        for b in later:
            logits, cache = decode_step(params, cfg, cache, pos, to_device(
                b, "cpu", mesh=m, specs=specs))
            got.append(logits.full_tensor())
            pos += b["tokens"].shape[1]
        mixer = params["blocks"]["ssm" if cfg.family == "ssm" else "attn"]
        out[f"serve_{tag}"] = (got, _placements(cache), _whole(cache),
                               _placements(mixer))


def _errors(mesh, out):
    """No fallback: a world that is not the mesh's and a DTensor at a
    kernel each raise."""
    raised = {}
    try:
        lmesh.make_mesh((2, 1), AXES, device_type="cpu")
    except ValueError as e:
        raised["world"] = str(e)
    from torch.distributed.tensor import Replicate
    a = sharding.place(torch.zeros((2, 8, 8), dtype=torch.int32), mesh,
                       [Replicate()] * mesh.ndim)
    try:
        ops.ss_matmul(a, a)
    except TypeError as e:
        raised["kernel"] = str(e)
    out["raised"] = raised


#: float32 elements of each priced collective's output (4 KiB)
PRICED_OUT = 1024


def _price_collectives(out):
    """The walker over an all-reduce, an all-gather and a reduce-scatter,
    each with ``PRICED_OUT`` float32 elements of output, over the model
    axis of (2, 2) (2 ranks) and of (1, 4) (4 ranks) -> (the walk's
    output bytes by kind, group size and link, its ``t_collective``)."""
    from torch.distributed import _functional_collectives as funcol
    from repro_torch.launch import hlo_cost
    n_out = PRICED_OUT
    for shape in ((2, 2), (1, 4)):
        m = lmesh.make_mesh(shape, AXES, device_type="cpu")
        n = shape[1]
        calls = {
            "all-reduce": lambda: funcol.all_reduce(
                torch.ones(n_out), "sum", (m, 1)),
            "all-gather": lambda: funcol.all_gather_tensor(
                torch.ones(n_out // n), 0, (m, 1)),
            "reduce-scatter": lambda: funcol.reduce_scatter_tensor(
                torch.ones(n_out * n), "sum", 0, (m, 1))}
        for kind, call in calls.items():
            cost = hlo_cost.analyze(lambda: funcol.wait_tensor(call()))
            out[f"priced/{kind}/{n}"] = (
                dict(cost.collective_groups),
                cost.roofline(n_chips=dist.get_world_size()).t_collective)


def _launcher(inp, mesh, out):
    """``launch.train.main(mesh=)`` at the smoke config."""
    ck = os.path.join(inp["root"], "launch_ckpt")
    out["launch_loss"] = ltrain.main(inp["launch_argv"] + ["--ckpt-dir", ck],
                                     mesh=mesh)


def run(rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/init",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
        inp["root"] = root
        mesh = lmesh.make_mesh((2, 2), AXES, device_type="cpu")
        params, opt, shardings = _train(inp, mesh, out)
        _checkpoint(inp, mesh, out, params, opt, shardings)
        _lookup(inp, mesh, out, "2x2")
        from torch.distributed.device_mesh import DeviceMesh
        sub = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                         mesh_dim_names=AXES)
        _lookup(inp, sub, out, "1x2")
        _roundtrip(inp, mesh, out)
        _serve(inp, out)
        _errors(mesh, out)
        _price_collectives(out)
        _launcher(inp, mesh, out)
    except Exception:           # the test reads the traceback
        out["error"] = traceback.format_exc()
        with open(os.path.join(root, f"error{rank}.txt"), "w") as f:
            f.write(out["error"])
        raise
    finally:
        if rank == 0:
            torch.save(out, os.path.join(root, "result.pt"))
        dist.destroy_process_group()
