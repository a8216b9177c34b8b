"""Parameters drawn block by block on the production mesh, on 4 gloo ranks
of the CPU, and the layer-streamed unsharded run.

One module fixture spawns 4 ranks (``tests/_torch_mesh_ranks.py``
``placed_init``; a ``file://`` store in ``tmp_path``) that place every
architecture's smoke configuration at (1, 4) and (2, 2), in bfloat16 and
in float32, with ``init_params(mesh=)``, and hold it on each rank against
``sharding.distribute(init_params(...), mesh, param_shardings(...))``:

* every local block bit for bit, and every leaf's global shape, strides,
  dtype and placements, and its block's shape and strides;
* no tensor that the placed init allocates (in bfloat16, under a
  ``TorchDispatchMode`` that records every new storage) holds more
  elements than the largest leaf of one layer or the largest leaf
  outside the stacks, but this rank's zero blocks of the stacks: no
  whole stack is ever drawn.

In this process: ``block_params(key, cfg, i)`` is row ``i`` of every
stacked leaf of ``init_params(key, cfg)``, and a prefill and decode step
whose layers are drawn one at a time as they are reached (a sequence of
``block_params`` for ``blocks``) give the stacked run's logits and cache
bit for bit, for every architecture.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_mesh_ranks as ranks
from repro_torch import _tree, configs
from repro_torch.models import lm

WORLD = 4
CASES = [f"{arch}-{s[0]}x{s[1]}-{dtype}" for arch in configs.ARCH_IDS
         for s in ranks.PLACED_GRIDS for dtype in ranks.PLACED_DTYPES]


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    """Spawn the ranks once -> each rank's comparisons."""
    root = tmp_path_factory.mktemp("placed")
    mp.spawn(ranks.placed_init, args=(WORLD, str(root)), nprocs=WORLD,
             join=True)
    out = [torch.load(root / f"placed{r}.pt", weights_only=False)
           for r in range(WORLD)]
    for r in out:
        assert "error" not in r, r["error"]
    return out


@pytest.mark.parametrize("case", CASES)
def test_placed_init_is_the_distributed_whole_init(placed, case):
    """Every rank's blocks, shapes, strides, dtypes and placements are
    those of the whole tree distributed."""
    for rank, r in enumerate(placed):
        assert r["equal"][case] == [], (rank, r["equal"][case])


@pytest.mark.parametrize("case", [c for c in CASES if "bfloat16" in c])
def test_placed_init_never_draws_a_whole_stack(placed, case):
    """No allocation but a rank's own zero blocks exceeds one layer's leaf
    or one leaf outside the stacks."""
    for rank, r in enumerate(placed):
        bound, over, largest = r["alloc"][case]
        assert over == [] and 0 < largest <= bound, (rank, bound, over)


def _batch(cfg, rng, b=2, t=6):
    out = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (b, t)), dtype=torch.int64)}
    if cfg.frontend == "vit":
        out["patches"] = torch.as_tensor(rng.standard_normal(
            (b, cfg.n_prefix, cfg.frontend_dim)).astype(np.float32))
    if cfg.n_enc_layers:
        out["frames"] = torch.as_tensor(rng.standard_normal(
            (b, 8, cfg.frontend_dim)).astype(np.float32))
    return out


class _Drawn:
    """Layer ``i`` of ``cfg`` drawn when it is indexed; the indices read."""

    def __init__(self, key, cfg):
        self.key, self.cfg, self.read = key, cfg, []

    def __getitem__(self, i):
        self.read.append(i)
        return lm.block_params(self.key, self.cfg, i, device="cpu")


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_layer_streamed_run_is_the_stacked_run(arch):
    """``block_params`` gives each stacked row; a prefill and a decode step
    over layers drawn as they are reached equal the stacked run's logits
    and cache bit for bit, each layer drawn once a call, in order."""
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    params = lm.init_params(3, cfg, device="cpu")
    for i in range(cfg.n_layers):
        got = lm.block_params(3, cfg, i, device="cpu")
        want = _tree.map_leaves(lambda t: t[i], params["blocks"])
        assert all(torch.equal(a, b) for a, b in zip(
            _tree.leaves(got), _tree.leaves(want))), i
    batch = _batch(cfg, np.random.default_rng(1))
    t = batch["tokens"].shape[1] + (cfg.n_prefix if "patches" in batch
                                    else 0)
    drawn = _Drawn(3, cfg)
    streamed = {k: v for k, v in params.items() if k != "blocks"}
    streamed["blocks"] = drawn
    with torch.no_grad():
        want, wcache = lm.prefill(params, cfg, batch, max_len=t + 1)
        got, gcache = lm.prefill(streamed, cfg, batch, max_len=t + 1)
        step = {"tokens": torch.argmax(want[:, -1], -1, keepdim=True)}
        want2, _ = lm.decode_step(params, cfg, wcache, t, step)
        got2, _ = lm.decode_step(streamed, cfg, gcache, t, step)
    assert torch.equal(got, want) and torch.equal(got2, want2)
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(gcache),
                                                 _tree.leaves(wcache)))
    assert drawn.read == list(range(cfg.n_layers)) * 2
