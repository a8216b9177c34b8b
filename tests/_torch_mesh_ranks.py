"""The rank side of ``tests/test_torch_production_mesh.py`` and
``tests/test_torch_placed_init.py``.

Each of the first test's gloo ranks runs :func:`run`: it starts the
process group from a ``file://`` store under the test's ``tmp_path``,
runs every scenario on ``DTensor``s over CPU meshes, and rank 0 saves
what the test compares (whole tensors, gathered) to ``result.pt``. Each
of the second's runs :func:`placed_init` and saves its own comparisons
of the placed init to ``placed<rank>.pt``. This module imports torch and
the port only: the ranks never load JAX.
"""
import dataclasses
import datetime
import os
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

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


#: the placed init's cases (``tests/test_torch_placed_init.py``): every
#: architecture's smoke configuration on each grid, in each dtype
PLACED_GRIDS = ((1, 4), (2, 2))
PLACED_DTYPES = ("bfloat16", "float32")
PLACED_SEED = 7
#: the allocation cases' fields: a vocabulary small enough and a stack
#: deep enough that a whole stack of any leaf of one layer holds more
#: elements than the bound (at the smoke configurations the table's
#: 256 x 64 is as large as a stack of two layers' widest leaf)
PLACED_ALLOC_FIELDS = dict(vocab_size=64, n_layers=4)


def _bits(t):
    """``t``'s elements as integers of its width (floats bit for bit)."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _placed_differences(placed, want):
    """-> the paths at which ``placed`` differs from ``want`` (trees of
    DTensors): the paths, or a leaf's local block bit for bit, its global
    shape, strides, dtype or placements, or its block's shape or
    strides."""
    got, ref = (_tree.leaves_with_paths(t) for t in (placed, want))
    got, ref = list(got), list(ref)
    if [p for p, _ in got] != [p for p, _ in ref]:
        return ["paths"]
    bad = []
    for (path, a), (_, b) in zip(got, ref):
        la, lb = a.to_local(), b.to_local()
        if not (type(a) is type(b) and a.shape == b.shape
                and a.stride() == b.stride() and a.dtype == b.dtype
                and list(a.placements) == list(b.placements)
                and la.shape == lb.shape and la.stride() == lb.stride()
                and la.device == lb.device
                and torch.equal(_bits(la), _bits(lb))):
            bad.append(path)
    return bad


class _Allocations(TorchDispatchMode):
    """Every tensor an op makes in new storage: (op, shape, elements of
    the storage)."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_leaves
        out = func(*args, **(kwargs or {}))

        def plain(xs):
            return [x for x in tree_leaves(xs) if type(x) is torch.Tensor]

        old = {x.untyped_storage().data_ptr()
               for x in plain((args, kwargs or {}))}
        for x in plain(out):
            if x.untyped_storage().data_ptr() not in old:
                self.made.append((str(func), tuple(x.shape),
                                  x.untyped_storage().nbytes()
                                  // x.element_size()))
        return out


def _allocation_bound(whole, n_of):
    """-> (the most elements of one layer's leaf or of one leaf outside
    the stacks of the whole tree ``whole``, the stacked paths)."""
    most, stacked = 0, set()
    for path, t in _tree.leaves_with_paths(whole):
        n = n_of(path)
        if n:
            stacked.add(path)
            most = max(most, t.numel() // n)
        else:
            most = max(most, t.numel())
    return most, stacked


def _placed_allocations(cfg, mesh, whole):
    """The placed init under :class:`_Allocations` -> (the bound, the
    allocations over it that are not this rank's zero block of a stack
    (the shape of its block of ``whole`` distributed), the largest
    allocation that is not such a block)."""
    from repro_torch.models.lm import init_params

    def n_of(path):
        top = path.split("/")[0]
        return {"blocks": cfg.n_layers,
                "enc_blocks": cfg.n_enc_layers}.get(top, 0)

    bound, stacked = _allocation_bound(whole, n_of)
    placed = sharding.distribute(whole, mesh,
                                 sharding.param_shardings(cfg, mesh, whole))
    rows = {tuple(t.to_local().shape)
            for path, t in _tree.leaves_with_paths(placed) if path in stacked}
    with _Allocations() as rec:
        init_params(PLACED_SEED, cfg, device="cpu", mesh=mesh)
    own = [m for m in rec.made if m[1] in rows
           and any(k in m[0] for k in ("zeros", "empty"))]
    rest = [m for m in rec.made if m not in own]
    return (bound, [m for m in rest if m[2] > bound],
            max((m[2] for m in rest), default=0))


def placed_init(rank: int, world: int, root: str) -> None:
    """Every case of PLACED_GRIDS x PLACED_DTYPES x the architectures:
    ``init_params(mesh=)`` against ``distribute(init_params(...))``; and
    on each grid the allocations of the bfloat16 placed init with
    PLACED_ALLOC_FIELDS. Each rank saves its own ``placed<rank>.pt``."""
    from repro_torch.models.lm import init_params
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/init",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    out = {"equal": {}, "alloc": {}}
    try:
        meshes = {s: lmesh.make_mesh(s, AXES, device_type="cpu")
                  for s in PLACED_GRIDS}
        for arch in configs.ARCH_IDS:
            for dtype in PLACED_DTYPES:
                cfg = dataclasses.replace(configs.smoke(arch), dtype=dtype)
                whole = init_params(PLACED_SEED, cfg, device="cpu")
                for shape, mesh in meshes.items():
                    case = f"{arch}-{shape[0]}x{shape[1]}-{dtype}"
                    want = sharding.distribute(
                        whole, mesh,
                        sharding.param_shardings(cfg, mesh, whole))
                    got = init_params(PLACED_SEED, cfg, device="cpu",
                                      mesh=mesh)
                    out["equal"][case] = _placed_differences(got, want)
            cfg = dataclasses.replace(
                configs.smoke(arch), dtype="bfloat16",
                **PLACED_ALLOC_FIELDS,
                n_enc_layers=configs.smoke(arch).n_enc_layers and 4)
            whole = init_params(PLACED_SEED, cfg, device="cpu")
            for shape, mesh in meshes.items():
                out["alloc"][f"{arch}-{shape[0]}x{shape[1]}-bfloat16"] = \
                    _placed_allocations(cfg, mesh, whole)
    except Exception:           # the test reads the traceback
        out["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(out, os.path.join(root, f"placed{rank}.pt"))
        dist.destroy_process_group()


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
