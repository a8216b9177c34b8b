"""The port's production-mesh path on 4 gloo ranks of the CPU.

One module fixture spawns 4 ranks (``tests/_torch_mesh_ranks.py``; a
``file://`` store in ``tmp_path``, no port) that run every scenario on a
("data", "model") ``DeviceMesh`` of the CPU; the tests read what rank 0
saved and hold it here against the port's unsharded path and the JAX
reference, on the Qwen smoke configuration in float32 (4 heads, d_ff 128,
vocabulary 256: every rule splits over a model axis of 2):

* at (2, 2), two sharded steps, then an accumulation-2 step with int8
  compression, from the reference's parameters: the loss, lr and grad
  norm of every step within 1e-5 of the port's unsharded steps and of the
  reference's, and so is every parameter (after the int8 step, all but
  an element in 10,000: see the test); the moments keep their
  parameters' placements; the int8 roundtrip of a leaf split on later
  dims is the whole leaf's, bit for bit;
* the private lookup with the vocabulary split over ``model`` at (1, 2)
  and (2, 2), from the plaintext table and from a pre-shared one: opened
  rows bit-identical to the unsharded lookup's;
* a checkpoint saved at (2, 2) restores at (4, 1), at (1, 4), unsharded,
  and through the reference's ``restore_checkpoint``, bit for bit;
* ``launch.train.main(mesh=)`` at (2, 2) gives the one-device run's loss;
* a prefill and decode steps of Qwen at (2, 2) and (1, 4), and of
  ChatGLM3 (query heads split, KV heads whole), InternVL2 (the same,
  through its ViT prefix) and MiniCPM3 (MLA heads whole) at (1, 4) over
  a cache split on its sequence, and at (1, 4) with batches of one and
  two of Mamba-2 and Hymba (SSM heads split), SeamlessM4T (frames and
  cross-attention) and Gemma3: the unsharded port's logits and cache,
  the cache placed as ``sharding.cache_spec`` says;
* the walker prices an all-reduce, an all-gather and a reduce-scatter
  over 2 and 4 ranks at NCCL's bus bytes for the kind and group size;
* no fallback: a world that is not the mesh's, a DTensor at a kernel, a
  missing process group and a backend PyTorch lacks each raise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import _torch_mesh_ranks as ranks
import repro.configs as jconfigs
from repro.checkpoint import restore_checkpoint as jrestore
from repro.models import lm as jlm
from repro.train import optim as jopt
from repro.train import step as jstep
from repro_torch import _tree, configs
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import train as ltrain
from repro_torch.models import private_embed as pe
from repro_torch.models.lm import params_from_arrays
from repro_torch.train import AdamWConfig, init_state, make_train_step

WORLD = 4
TOL = 1e-5
#: AdamWConfig's default lr. AdamW moves an element by about lr·g/|g|, so
#: where a float32 rounding of the reduction order (or of an int8 block's
#: code) changes a small gradient, the parameters move apart by a share
#: of lr: at lr 1e-3 the unsharded port and the reference already differ
#: by 9.6e-6 after these three steps, and one int8 code flips between the
#: sharded and unsharded runs (1.8e-5).
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10)
LAUNCH = ["--arch", "qwen1.5-4b", "--smoke", "--steps", "2", "--batch", "4",
          "--seq", "16", "--device", "cpu", "--log-every", "1"]


def _cfgs():
    return (dataclasses.replace(jconfigs.smoke("qwen1_5_4b"),
                                dtype="float32"),
            dataclasses.replace(configs.smoke("qwen1_5_4b"),
                                dtype="float32"))


def _batches(vocab):
    rng = np.random.default_rng(3)

    def one(shape):
        return {k: rng.integers(0, vocab, shape).astype(np.int32)
                for k in ("tokens", "labels")}

    return [one((4, 16)), one((4, 16)), one((2, 2, 16))]


def _reference_steps(jcfg, jp, batches):
    """-> (metrics a step, the parameters after each step as numpy)."""
    cfg = jopt.AdamWConfig(**OPT)
    plain = jax.jit(jstep.make_train_step(jcfg, cfg))
    accum = jax.jit(jstep.make_train_step(jcfg, cfg, grad_accum=2,
                                          compress=True))
    state, metrics, after = jopt.init_state(jp), [], []
    for i, b in enumerate(batches):
        jp, state, m = (plain if i < 2 else accum)(
            jp, state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        after.append(jax.tree.leaves(jax.tree.map(np.asarray, jp)))
    return metrics, after


def _port_steps(tcfg, params_np, batches):
    """-> (metrics a step, the parameters after each step, copied)."""
    params = params_from_arrays(params_np, device="cpu")
    opt = init_state(params)
    ocfg = AdamWConfig(**OPT)
    plain = make_train_step(tcfg, ocfg)
    accum = make_train_step(tcfg, ocfg, grad_accum=2, compress=True)
    metrics, after = [], []
    for i, b in enumerate(batches):
        params, opt, m = (plain if i < 2 else accum)(
            params, opt, {k: torch.as_tensor(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        after.append([t.clone() for t in _tree.leaves(params)])
    return metrics, after


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the ranks once -> (rank 0's results, the inputs, the root)."""
    root = tmp_path_factory.mktemp("mesh")
    jcfg, _ = _cfgs()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(5)
    embed = torch.from_numpy(
        (rng.standard_normal((256, 64)) / 8).astype(np.float32))
    inp = {"params": jax.tree.map(np.asarray, jp),
           "batches": _batches(jcfg.vocab_size), "opt": OPT,
           "embed": embed,
           "embed_shares": pe.setup_private_embed(
               (3,), embed, device="cpu").values,
           "lookup_tokens": torch.from_numpy(
               rng.integers(0, 256, (4, 8)).astype(np.int64)),
           "launch_argv": LAUNCH,
           "grad": torch.from_numpy(
               rng.standard_normal((3, 6, 50)).astype(np.float32)),
           "serve_tokens": rng.integers(0, 256, (4, 8)).astype(np.int32)}
    inp["serve_patches"] = rng.standard_normal((4, 4, 32)).astype(
        np.float32)
    inp["serve_frames"] = rng.standard_normal((4, 8, 32)).astype(
        np.float32)
    torch.save(inp, root / "inputs.pt")
    mp.spawn(ranks.run, args=(WORLD, str(root)), nprocs=WORLD, join=True)
    out = torch.load(root / "result.pt", weights_only=False)
    assert "error" not in out, out.get("error")
    return out, inp, root, jp


@pytest.fixture(scope="module")
def unsharded(run):
    """The port's and the reference's unsharded runs of the same steps."""
    _, inp, _, jp = run
    jcfg, tcfg = _cfgs()
    return (_port_steps(tcfg, inp["params"], inp["batches"]),
            _reference_steps(jcfg, jp, inp["batches"]))


def _far(got, port, ref):
    """-> (the elements over TOL from either, the largest gap), leaf by
    leaf over the two unsharded runs' leaves."""
    far, worst = 0, 0.0
    for g, p, r in zip(_tree.leaves(got), port, ref):
        for d in (np.abs(g.numpy() - p.numpy()), np.abs(g.numpy() - r)):
            far += int((d > TOL).sum())
            worst = max(worst, float(d.max()))
    return far, worst


@pytest.mark.parametrize("n_steps", [2, 3])
def test_sharded_steps_match_unsharded_port_and_reference(run, unsharded,
                                                          n_steps):
    """Losses, lr and grad norms within 1e-5 at every step; after the two
    plain steps every parameter within 1e-5 of both unsharded runs. The
    third step rounds its gradients to int8 codes, and a gradient within
    float32 rounding (of the reduction order) of a code's edge takes the
    next code in one run of the three: the parameters then stay within
    1e-5 but at most one element in 10,000, which stays within lr. (The
    unsharded port and the reference differ in the same way.)"""
    out = run[0]
    (want_port, port_after), (want_ref, ref_after) = unsharded
    for got, port, ref in zip(out["train_metrics"][:n_steps], want_port,
                              want_ref):
        for k in ("loss", "lr", "grad_norm"):
            assert abs(got[k] - port[k]) <= TOL, (k, got[k], port[k])
            assert abs(got[k] - ref[k]) <= TOL, (k, got[k], ref[k])
    got = out["params_after_2" if n_steps == 2 else "train_params"]
    far, worst = _far(got, port_after[n_steps - 1],
                      ref_after[n_steps - 1])
    n = sum(t.numel() for t in _tree.leaves(got))
    if n_steps == 2:
        assert far == 0, worst
    else:
        assert far <= n // 10_000 and worst <= OPT["lr"], (far, worst)


def test_split_leaf_compression_is_the_whole_leafs(run):
    """The int8 roundtrip of a leaf split on later dims (blocks of 256
    cut by the split) equals the whole leaf's, bit for bit."""
    from repro_torch.train.compress import roundtrip_
    out, inp = run[0], run[1]
    want = roundtrip_(inp["grad"].clone())
    for tag in ("model", "data_model"):
        assert torch.equal(out[f"roundtrip_{tag}"], want), tag


def test_parameters_and_moments_keep_their_placements(run):
    out = run[0]
    pls = dict(out["train_placements"])
    assert pls["blocks/mlp/w_up"] == ["Replicate()", "Shard(dim=2)"]
    assert pls["blocks/attn/wo"] == ["Replicate()", "Shard(dim=1)"]
    assert pls["embed"] == ["Replicate()", "Shard(dim=0)"]
    assert pls["lm_head"] == ["Replicate()", "Shard(dim=1)"]
    assert pls["final_norm"] == ["Replicate()", "Replicate()"]
    assert out["grad_placements_ok"]


@pytest.mark.parametrize("grid", ["1x2", "2x2"])
@pytest.mark.parametrize("table", ["embed", "embed_shares"])
def test_vocab_split_lookup_is_bit_identical(run, grid, table):
    out, inp = run[0], run[1]
    _, tcfg = _cfgs()
    want = pe.private_lookup_inline({table: inp[table]}, tcfg,
                                    inp["lookup_tokens"], key=(7,))
    got, placements, local_shape = out[f"lookup_{grid}"][table]
    assert torch.equal(got, want)
    data_rows = 4 // int(grid[0])
    assert local_shape == (data_rows, 8, 64)
    assert placements[1] == "Replicate()"


def test_checkpoint_crosses_grids_and_packages(run):
    out, inp, root, jp = run
    saved_p = out["train_params"]
    for grid in ("4x1", "1x4"):
        step, p2, m2, pls = out[f"restored_{grid}"]
        assert step == 3
        for a, b in zip(_tree.leaves(p2), _tree.leaves(saved_p)):
            assert torch.equal(a, b)
        for a, b in zip(_tree.leaves(m2), _tree.leaves(out["train_opt_m"])):
            assert torch.equal(a, b)
        assert dict(pls)["blocks/mlp/w_up"] == ["Replicate()",
                                                 "Shard(dim=2)"]
    template = (params_from_arrays(inp["params"], device="cpu"), None)
    template = (template[0], init_state(template[0]))
    step, (p, o) = restore_checkpoint(str(root / "ckpt"), template)
    assert step == 3
    for a, b in zip(_tree.leaves(p), _tree.leaves(saved_p)):
        assert torch.equal(a, b)
    jtemplate = (jp, jopt.init_state(jp))
    step, (jp2, _) = jrestore(str(root / "ckpt"), jtemplate)
    assert step == 3
    for a, b in zip(jax.tree.leaves(jp2), _tree.leaves(saved_p)):
        assert np.array_equal(np.asarray(a), b.numpy())


#: the cache's sequence split (dim 2 of the (L, B, S, ...) cache) or head
#: split (dim 3), and the query projection's placement on the model axis,
#: by serving case (for Mamba-2: the SSM state's head split, dim 2 of the
#: (L, B, H, P, N) state, and ``w_x``'s, dim 2 of the (L, D, H, P) weight)
SERVE_PLACED = {"2x2": ("Shard(dim=3)", "Shard(dim=2)"),
                "1x4": ("Shard(dim=2)", "Replicate()"),
                "1x4_chatglm3": ("Shard(dim=2)", "Shard(dim=2)"),
                "1x4_internvl2": ("Shard(dim=2)", "Shard(dim=2)"),
                "1x4_minicpm3": ("Shard(dim=2)", "Replicate()")}
for _b in (1, 2):
    SERVE_PLACED.update({f"1x4_mamba2_b{_b}": ("Shard(dim=2)",
                                               "Shard(dim=2)"),
                         f"1x4_hymba_b{_b}": ("Shard(dim=2)",
                                              "Shard(dim=2)"),
                         f"1x4_seamless_b{_b}": ("Shard(dim=3)",
                                                 "Shard(dim=2)"),
                         f"1x4_gemma3_b{_b}": ("Shard(dim=2)",
                                               "Shard(dim=2)")})

#: cache leaves whose layer 0 is not a projection of the embedding alone:
#: the SSM state (through dt's projection onto a rank's 2 heads, which the
#: CPU's GEMM rounds apart from its 8 columns, and the scan) and the cross
#: cache (from the encoder's output); held within 1e-5 as later layers are
NOT_FROM_EMBEDDING = ("ssm/state", "cross/0", "cross/1")


class _Grid:
    """A stand-in for a mesh of ``shape``: the rules read its axis names
    and sizes only."""
    axis_names = ("data", "model")

    def __init__(self, shape):
        self.shape = dict(zip(self.axis_names, shape))


@pytest.mark.parametrize("grid", list(SERVE_PLACED))
def test_prefill_and_decode_on_a_mesh(run, grid):
    """The dry-run's serving cells on real ranks: a 6-token prefill and
    the decode steps (``ranks.SERVE_CASES``) within 1e-4 (float32; 1e-5
    for the cases of batch 1 and 2) of one device's logits, the cache
    gathered whole equal to one device's (see below) and placed as
    ``sharding.cache_spec`` says, with the cache split on heads (2 x 2)
    or on its sequence (1 x 4): Qwen with 2 heads whole on every model
    rank, ChatGLM3 and InternVL2 (through its ViT prefix) with their
    query heads split and KV heads whole, MiniCPM3 at 6 heads with its MLA
    weights whole and its latent cache split; ChatGLM3 and MiniCPM3 end
    with a two-token step into the filled context-parallel cache. At
    (1, 4) with batches of one and two, each ending with a two-token
    step: Mamba-2 and Hymba with their SSM heads split (the mixer on local
    blocks, its conv buffers and state on each rank's heads),
    SeamlessM4T with its frames projection and cross-attention on local
    blocks (the cross cache split on heads), and Gemma3 (one KV head, a
    context-parallel cache, its window crossed)."""
    from repro_torch import sharding
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.config import ShapeConfig
    out, inp = run[0], run[1]
    _, shape, arch, over, steps, batch = next(
        c for c in ranks.SERVE_CASES if c[0] == grid)
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32", **over)
    params = init_params(11, cfg, device="cpu")
    first, later = ranks.serve_batches(inp, cfg, steps, batch)
    pos = (cfg.n_prefix if cfg.frontend == "vit" else 0) + 6
    logits, cache = prefill(params, cfg, {k: torch.as_tensor(v)
                                          for k, v in first.items()},
                            max_len=pos + sum(steps))
    want = [logits]
    for b in later:
        logits, cache = decode_step(params, cfg, cache, pos, {
            "tokens": torch.as_tensor(b["tokens"])})
        want.append(logits)
        pos += b["tokens"].shape[1]
    got, placements, got_cache, mixer = out[f"serve_{grid}"]
    assert len(got) == len(want) == 1 + len(steps)
    tol = 1e-4 if batch == 4 else 1e-5
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= tol
    # layer 0's keys and values (and the SSM's conv buffers) come from the
    # embedding: bit for bit; a later layer's from the previous layer's
    # output, summed over the model ranks in another order (2.2e-6 at
    # most in these cases)
    for (path, g), w in zip(_tree.leaves_with_paths(got_cache),
                            _tree.leaves(cache)):
        assert g.shape == w.shape
        if path not in NOT_FROM_EMBEDDING:
            assert torch.equal(g[0], w[0]), path
        assert float((g - w).abs().max()) <= 1e-5, path
    placements = dict(placements)
    spec = sharding.cache_spec(cfg, _Grid(shape), ShapeConfig(
        "cache", 0, batch, "decode"))
    want_pls = _tree.map_leaves(
        lambda t, s: " ".join(map(repr, sharding.placements(s, _Grid(
            shape)))), got_cache, spec)
    assert {k: " ".join(v) for k, v in placements.items()} == dict(
        _tree.leaves_with_paths(want_pls))
    split, w_split = SERVE_PLACED[grid]
    state = "ssm/state" if cfg.family == "ssm" else "kv/0"
    assert placements[state][1] == split
    w = ("w_x" if cfg.family == "ssm" else
         "wuq" if cfg.attn_type == "mla" else "wq")
    assert dict(mixer)[w][1] == w_split


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter"])
def test_walker_prices_collectives_by_bus_bytes(run, kind, n):
    """Each collective alone, 4 KiB of output over n ranks of one host:
    recorded by kind, group size and link, and priced at NCCL's bus bytes
    (2(n-1)/n of the output for an all-reduce, (n-1)/n for an all-gather,
    n-1 for a reduce-scatter) over the NVLink bus rate measured for the
    kind at n ranks."""
    from repro_torch.launch import hlo_analysis as H
    groups, t = run[0][f"priced/{kind}/{n}"]
    nb = 4 * ranks.PRICED_OUT
    assert groups == {f"{kind}|{n}|nvlink": nb}
    bus = {"all-reduce": 2 * (n - 1) / n, "all-gather": (n - 1) / n,
           "reduce-scatter": n - 1}[kind]
    assert t == pytest.approx(bus * nb / H.NVLINK_BUS_BW[kind][n],
                              rel=1e-12)


def test_launcher_on_a_mesh_matches_one_device(run, capsys):
    out = run[0]
    want = ltrain.main(LAUNCH)
    assert abs(out["launch_loss"] - want) <= 2e-2 * abs(want)


def test_no_fallback(run):
    raised = run[0]["raised"]
    assert "needs 2 ranks, the world has 4" in raised["world"]
    assert "DTensor reached a kernel" in raised["kernel"]
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        lmesh.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    with pytest.raises(RuntimeError, match="no mpi backend"):
        lmesh.init_ranks(backend="mpi", device="cpu")
