"""The port's rank entry, ``launch.mesh.init_ranks``, as ``torchrun``
starts it: two spawned gloo ranks get ``torchrun``'s environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), start through ``init_ranks(device="cpu")``, build the
(1, 2) and (2, 1) meshes with ``make_mesh`` and train one smoke step on
each through ``launch.train.main(mesh=)`` on the smoke configuration in
float32. The step's loss and grad norm must be the one device's within
1e-5, as ``test_torch_production_mesh.py`` holds the sharded steps. Then,
the group torn down, ``launch.train.main(["--production-mesh", ...])``
starts the ranks itself (its production mesh stood in for by a (1, 2)
one) and must end the group it started. ``chip_smoke.py`` starts its NCCL ranks on the cards the same
way. No JAX: the ranks import the port only.
"""
import dataclasses
import json
import os
import socket

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import train as ltrain

WORLD = 2
AXES = ("data", "model")
GRIDS = ((1, 2), (2, 1))
LAUNCH = ["--arch", "qwen1.5-4b", "--smoke", "--steps", "1", "--batch", "4",
          "--seq", "16", "--device", "cpu", "--log-every", "1"]
TOL = 1e-5
_SMOKE = configs.smoke


def _float32_smoke(arch):
    return dataclasses.replace(_SMOKE(arch), dtype="float32")


def _step(mesh=None, more=()):
    """One launcher step of the float32 smoke configuration (argv LAUNCH
    and ``more``) -> its loss and grad norm."""
    got = {}
    configs.smoke = _float32_smoke
    try:
        ltrain.main(LAUNCH + list(more), mesh=mesh, on_step=lambda s, p, o, m: got.update(
            loss=float(m["loss"]), grad_norm=float(m["grad_norm"])))
    finally:
        configs.smoke = _SMOKE
    return got


def _stand_in_mesh(*, multi_pod=False, device_type="cuda"):
    return lmesh.make_mesh((1, WORLD), AXES, device_type=device_type)


def _rank(rank: int, world: int, port: int, root: str) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    out = {}
    try:
        dev = lmesh.init_ranks(device="cpu")
        out.update(device=str(dev), backend=dist.get_backend(),
                   rank=dist.get_rank(), world=dist.get_world_size())
        for shape in GRIDS:
            mesh = lmesh.make_mesh(shape, AXES, device_type="cpu")
            out[f"{shape[0]}x{shape[1]}"] = {
                "shape": list(mesh.shape),
                "names": list(mesh.mesh_dim_names),
                "coordinate": list(mesh.get_coordinate()),
                "step": _step(mesh)}
        dist.destroy_process_group()
        os.environ["MASTER_PORT"] = str(port + 1)
        lmesh.make_production_mesh = _stand_in_mesh
        out["production_mesh"] = _step(more=["--production-mesh"])
        out["production_mesh"]["group_left"] = dist.is_initialized()
    finally:
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_pair() -> int:
    """A port p with p + 1 free too (one store for each start)."""
    while True:
        with socket.socket() as a, socket.socket() as b:
            a.bind(("localhost", 0))
            port = a.getsockname()[1]
            try:
                b.bind(("localhost", port + 1))
            except OSError:
                continue
            return port


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("init_ranks")
    port = _free_pair()
    mp.spawn(_rank, args=(WORLD, port, str(root)), nprocs=WORLD, join=True)
    out = []
    for r in range(WORLD):
        with open(root / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


def test_ranks_start_from_torchruns_environment(ranks):
    for r, out in enumerate(ranks):
        assert out["device"] == "cpu"
        assert out["backend"] == "gloo"
        assert (out["rank"], out["world"]) == (r, WORLD)


@pytest.mark.parametrize("shape", GRIDS)
def test_make_mesh_over_the_started_ranks(ranks, shape):
    tag = f"{shape[0]}x{shape[1]}"
    coords = []
    for out in ranks:
        assert out[tag]["shape"] == list(shape)
        assert out[tag]["names"] == list(AXES)
        coords.append(out[tag]["coordinate"])
    # row-major: rank r sits at (r // n_model, r % n_model)
    assert coords == [[r // shape[1], r % shape[1]] for r in range(WORLD)]


@pytest.mark.parametrize("shape", GRIDS)
def test_launcher_step_on_the_mesh_is_one_devices(ranks, shape):
    want = _step()
    for out in ranks:
        got = out[f"{shape[0]}x{shape[1]}"]["step"]
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])


def test_production_mesh_launcher_ends_the_ranks_it_started(ranks):
    """``--production-mesh`` starts the ranks through ``init_ranks`` and
    tears the group down after its last step: its loss is the (1, 2)
    mesh's, and no process group is left."""
    for out in ranks:
        got, want = out["production_mesh"], out["1x2"]["step"]
        assert got["group_left"] is False
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])
