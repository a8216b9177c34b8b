"""Fault-tolerant checkpoints of tensor trees, in the reference's layout.

Guarantees, as the reference's:
  * **atomicity**: leaves are written to ``step_N.tmp/`` then renamed, so
    a crash mid-write never leaves a "latest" that fails to restore;
  * **integrity**: every leaf carries a SHA-256 (16 hex digits) in the
    manifest; restore verifies it and falls back to the newest *valid*
    step (a torn or corrupt checkpoint is skipped);
  * **placement on restore**: ``shardings=`` (a tree of
    ``sharding.NamedSharding``s, as ``sharding.param_shardings`` gives on
    a ``DeviceMesh``) makes each leaf a ``DTensor`` of its placements,
    each rank uploading only its own block, so a checkpoint written at
    one grid restores at any other; ``device=`` puts plain leaves there;
    without either they stay on the host;
  * **on a mesh**: ``save`` gathers each ``DTensor`` leaf whole (every
    rank takes part) and rank 0 alone writes the checkpoint, so it holds
    each whole leaf once, as an unsharded run's does;
  * **async**: ``save(..., blocking=False)`` copies every leaf to the host
    before it returns, then a writer thread persists while training goes
    on. The copy is a clone even of a CPU tensor, whose ``.cpu()`` would
    share the storage the optimizer then overwrites in place.

Storage layout: ``<dir>/step_<N>/<leaf-idx>.npy`` + ``manifest.json``
(``{"step", "leaves": [{"name", "file", "shape", "dtype", "sha"}]}``).
Leaves are numbered in ``jax.tree_util``'s flatten order and named by
its paths (``_tree``), so a checkpoint written by either package restores
in the other, bit for bit. numpy has no bfloat16 or float8: those leaves
are stored as their same-width unsigned integer view and restored from
the manifest's dtype record.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .. import _device, _tree
from .. import sharding as shd

#: torch dtypes numpy lacks -> (manifest name, the same-width signed torch
#: view they cross through, the unsigned numpy view they are stored as)
_EXOTIC = {
    torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.int8, np.uint8),
    torch.float8_e5m2: ("float8_e5m2", torch.int8, np.uint8),
}
_EXOTIC_BY_NAME = {name: dt for dt, (name, _, _) in _EXOTIC.items()}


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf -> (a host array numpy can save, its dtype name). A tensor
    is copied, never shared."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.array(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype in _EXOTIC:
        name, signed, stored = _EXOTIC[t.dtype]
        return t.view(signed).numpy().view(stored), name
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _from_saved(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _EXOTIC_BY_NAME:
        signed = arr.view(f"i{arr.itemsize}")       # torch has no uint16
        return torch.from_numpy(signed).view(_EXOTIC_BY_NAME[dtype_name])
    return torch.from_numpy(arr)


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *,
                    blocking: bool = True) -> Optional[threading.Thread]:
    """Persist a tree. Non-blocking mode copies it to the host, then
    returns the writer thread. In a process group every rank calls it
    (a ``DTensor`` leaf is gathered whole with every rank's block); rank
    0 writes, the others return ``None``."""
    writer = shd.rank() == 0
    host: List[Tuple[str, np.ndarray, str]] = []
    for name, leaf in _tree.leaves_with_paths(tree):
        if _device.is_dtensor(leaf):
            leaf = leaf.full_tensor()
        if writer:
            host.append((name, *_to_host(leaf)))
        del leaf
    if not writer:
        return None

    def _write():
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (name, arr, dtype_name) in enumerate(host):
            fn = f"{i}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append({
                "name": name, "file": fn, "shape": list(arr.shape),
                "dtype": dtype_name, "sha": _sha(arr)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)           # atomic commit

    if blocking:
        _write()
        return None
    th = threading.Thread(target=_write, daemon=True)
    th.start()
    return th


def _steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    s = _steps(ckpt_dir)
    return s[-1] if s else None


def _load_step(ckpt_dir: str, step: int, template: Any, *,
               verify: bool = True) -> List[torch.Tensor]:
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat_t = _tree.leaves(template)
    if len(manifest["leaves"]) != len(flat_t):
        raise ValueError("manifest/template leaf-count mismatch")
    leaves = []
    for meta, t in zip(manifest["leaves"], flat_t):
        arr = np.load(os.path.join(d, meta["file"]))
        if verify and _sha(arr) != meta["sha"]:
            raise ValueError(f"checksum mismatch in {meta['name']}")
        if list(arr.shape) != list(np.shape(t)):
            raise ValueError(f"shape mismatch in {meta['name']}: "
                             f"{arr.shape} vs {tuple(np.shape(t))}")
        leaves.append(_from_saved(arr, meta["dtype"]))
    return leaves


def restore_checkpoint(ckpt_dir: str, template: Any, *,
                       step: Optional[int] = None, shardings=None,
                       device=None, verify: bool = True) -> tuple:
    """Restore the newest valid checkpoint (or ``step``) into a tree of
    ``template``'s structure -> (step, tree). Leaves are tensors on the
    host, or on ``device`` when it is given; with ``shardings`` (a tree
    of ``template``'s structure holding a ``sharding.NamedSharding``, or
    ``None`` for a plain leaf, at each leaf) each leaf becomes a
    ``DTensor`` of its placements holding this rank's block (on
    ``device``, by default the mesh's). Raises FileNotFoundError if
    nothing valid exists."""
    candidates = [step] if step is not None else list(reversed(_steps(
        ckpt_dir)))
    last_err: Optional[Exception] = None
    for s in candidates:
        try:
            leaves = _load_step(ckpt_dir, s, template, verify=verify)
        except (OSError, ValueError, KeyError) as e:  # torn/corrupt
            last_err = e
            continue
        tree = _tree.unflatten(template, leaves)
        if shardings is not None:
            return s, _tree.map_leaves(
                lambda t, sh: (t.to(device) if device is not None else t)
                if sh is None else shd.place(t, sh.mesh, sh.placements,
                                             device=device),
                tree, shardings)
        if device is not None:
            tree = _tree.map_leaves(lambda t: t.to(device), tree)
        return s, tree
    raise FileNotFoundError(
        f"no valid checkpoint under {ckpt_dir}: {last_err}")


class CheckpointManager:
    """keep_last_n retention + async writer + restore-or-init."""

    def __init__(self, ckpt_dir: str, *, keep_last_n: int = 3,
                 async_save: bool = True):
        self.dir = ckpt_dir
        self.keep = keep_last_n
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        self._pending = save_checkpoint(self.dir, step, tree,
                                        blocking=not self.async_save)
        if not self.async_save:
            self._gc()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
            self._gc()

    def _gc(self) -> None:
        if shd.rank() != 0:
            return
        steps = _steps(self.dir)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def restore_or_init(self, template: Any, init_fn, *,
                        device=None) -> tuple:
        try:
            return restore_checkpoint(self.dir, template, device=device)
        except FileNotFoundError:
            return 0, init_fn()
