"""The port's training substrate against the reference's
(``tests/test_substrate.py``): checkpoints, gradient compression and the
data pipeline.

* checkpoints: the reference's tests as twins (round trip with bf16,
  corruption fallback, a torn write, retention with the async writer,
  placement on restore: ``device=`` for ``shardings=``); the async save
  copies a CPU tensor before it returns; a checkpoint written by
  ``repro.checkpoint`` restores in the port bit for bit and the reverse,
  with identical manifests, for a ``(params, AdamWState)`` pair;
* compression: ``q`` and ``scale`` bit-equal to the reference's for the
  same float32 gradients (round half to even at exact ties included),
  the dequantized gradients equal, the reference's error bound and
  error-feedback tests as twins, and the in-place ``roundtrip_`` equal to
  ``decompress(compress(.))`` across its runs;
* data: ``TokenStream`` batches and ``synthetic_relation`` rows equal the
  reference's row for row; the ``Prefetcher`` yields in order and uploads
  to ``device=``; the launcher's resume equals an uninterrupted run.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro import checkpoint as jckpt
from repro.data import TokenStream as JTokenStream
from repro.data import synthetic_relation as j_relation
from repro.models import lm as jlm
from repro.train import compress as jcomp
from repro.train import optim as jopt
from repro_torch import _tree
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.data import (Prefetcher, TokenStream, make_lm_batches,
                              synthetic_relation)
from repro_torch.launch import train as train_launcher
from repro_torch.models import lm as tlm
from repro_torch.train import compress as tcomp
from repro_torch.train import optim as topt


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def _ttree():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": torch.ones((5,), dtype=torch.bfloat16),
            "nested": {"u": torch.zeros((2, 2), dtype=torch.int32)}}


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    tree = _ttree()
    save_checkpoint(str(tmp_path), 7, tree)
    step, restored = restore_checkpoint(str(tmp_path), tree)
    assert step == 7
    for a, b in zip(_tree.leaves(tree), _tree.leaves(restored)):
        assert _same(a, b)          # bf16 survives the npy round trip


def test_checkpoint_corruption_falls_back(tmp_path):
    tree = _ttree()
    save_checkpoint(str(tmp_path), 1, tree)
    save_checkpoint(str(tmp_path), 2, tree)
    p = os.path.join(str(tmp_path), "step_2", "0.npy")
    with open(p, "r+b") as f:
        f.seek(80)
        f.write(b"\xff" * 16)
    step, _ = restore_checkpoint(str(tmp_path), tree)
    assert step == 1                # the newest VALID checkpoint


def test_checkpoint_torn_write_invisible(tmp_path):
    tree = _ttree()
    save_checkpoint(str(tmp_path), 1, tree)
    os.makedirs(os.path.join(str(tmp_path), "step_9.tmp"))
    assert latest_step(str(tmp_path)) == 1
    assert restore_checkpoint(str(tmp_path), tree)[0] == 1


def test_checkpoint_manager_retention_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2, async_save=True)
    tree = _ttree()
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    mgr.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(str(tmp_path))
                   if d.startswith("step_") and not d.endswith(".tmp"))
    assert steps == [3, 4]


def test_async_save_copies_before_returning(tmp_path):
    """The optimizer overwrites parameters in place right after a save:
    the async writer must hold a copy, also of a CPU tensor."""
    tree = {"w": torch.zeros((64, 64))}
    th = save_checkpoint(str(tmp_path), 1, tree, blocking=False)
    tree["w"].add_(1.0)
    th.join(timeout=60)
    assert not th.is_alive()
    _, restored = restore_checkpoint(str(tmp_path), {"w": torch.empty(64,
                                                                      64)})
    assert torch.equal(restored["w"], torch.zeros((64, 64)))


def test_checkpoint_restore_places_on_device(tmp_path):
    """The reference's elastic restore takes ``shardings=``; the port's
    takes ``device=`` (the leaves land there; the host without it)."""
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    save_checkpoint(str(tmp_path), 5, tree)
    step, restored = restore_checkpoint(str(tmp_path), tree,
                                        device=torch.device("cpu"))
    assert step == 5 and restored["w"].device == torch.device("cpu")
    assert torch.equal(restored["w"], tree["w"])
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), tree)


def _fill(order, values):
    """``values`` re-nested in the key order of ``order``."""
    if isinstance(order, dict):
        return {k: _fill(v, values[k]) for k, v in order.items()}
    return values


def _ref_pair(seed=0):
    cfg = jconfigs.smoke("qwen1_5_4b")           # bf16 weights
    jp = jlm.init_params(jax.random.PRNGKey(seed), cfg)
    js = jopt.init_state(jp)
    rng = np.random.default_rng(seed)
    js = jopt.AdamWState(
        jnp.asarray(3, jnp.int32),
        jax.tree.map(lambda m: jnp.asarray(
            rng.standard_normal(m.shape), jnp.float32), js.m),
        jax.tree.map(lambda v: jnp.asarray(
            rng.random(v.shape), jnp.float32), js.v))
    # the port's own tree (its dicts in init order, not sorted) holding
    # the reference's values
    tp = _fill(tlm.init_params(0, tconfigs.smoke("qwen1_5_4b"),
                               device="cpu"),
               tlm.params_from_arrays(jax.tree.map(np.asarray, jp),
                                      device="cpu"))
    assert list(tp) != sorted(tp)
    ts = topt.AdamWState(
        torch.tensor(3, dtype=torch.int32),
        _tree.map_leaves(lambda p, m: torch.from_numpy(np.array(m)), tp,
                         js.m),
        _tree.map_leaves(lambda p, v: torch.from_numpy(np.array(v)), tp,
                         js.v))
    return (jp, js), (tp, ts)


def _bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.reshape(-1).view(np.uint8)


def test_reference_checkpoint_restores_in_port(tmp_path):
    (jp, js), (tp, ts) = _ref_pair()
    jckpt.save_checkpoint(str(tmp_path), 3, (jp, js))
    template = (tp, topt.init_state(tp))
    step, (rp, rs) = restore_checkpoint(str(tmp_path), template)
    assert step == 3
    want = jax.tree_util.tree_flatten_with_path((jp, js))[0]
    got = list(_tree.leaves_with_paths((rp, rs)))
    assert len(got) == len(want)
    for (name, t), (path, a) in zip(got, want):
        assert name == "/".join(str(getattr(k, "key", getattr(
            k, "idx", getattr(k, "name", k)))) for k in path)
        assert tuple(t.shape) == a.shape, name
        if t.dtype == torch.bfloat16:
            assert str(a.dtype) == "bfloat16", name
            t = t.view(torch.int16)
        assert np.array_equal(_bits(t.numpy()), _bits(a)), name


def test_port_checkpoint_restores_in_reference(tmp_path):
    (jp, js), (tp, ts) = _ref_pair(seed=1)
    save_checkpoint(str(tmp_path / "port"), 3, (tp, ts))
    jckpt.save_checkpoint(str(tmp_path / "ref"), 3, (jp, js))
    step, (rp, rs) = jckpt.restore_checkpoint(
        str(tmp_path / "port"), (jp, jopt.init_state(jp)))
    assert step == 3
    for a, b in zip(jax.tree.leaves((jp, js)), jax.tree.leaves((rp, rs))):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))
    manifests = [json.loads((tmp_path / d / "step_3" / "manifest.json")
                            .read_text()) for d in ("port", "ref")]
    assert manifests[0] == manifests[1]   # names, files, dtypes, SHA-256


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def _grads(seed=0):
    rng = np.random.default_rng(seed)
    g = {"a": rng.normal(size=(300,)).astype(np.float32),
         "b": rng.normal(size=(17, 5)).astype(np.float32),
         "s": np.asarray(rng.normal(), np.float32),
         "z": np.zeros((7, 40), np.float32)}
    # exact ties: block max 127 -> scale 1 (+1e-12), so x.5 rounds to even
    g["t"] = np.concatenate([np.full(256, 127.0), np.arange(-10.5, 10.5),
                             [0.5, 1.5, 2.5, -0.5, -2.5]]).astype(
                                 np.float32)
    return g


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_grads_bit_equal_reference(seed):
    g = _grads(seed)
    (jc, jshapes) = jcomp.compress_grads(jax.tree.map(jnp.asarray, g))
    (tc, tshapes) = tcomp.compress_grads(
        {k: torch.from_numpy(v) for k, v in g.items()})
    for k in g:
        assert tc.q[k].dtype == torch.int8
        assert np.array_equal(tc.q[k].numpy(), np.asarray(jc.q[k])), k
        assert np.array_equal(_bits(tc.scale[k].numpy()),
                              _bits(jc.scale[k])), k
        assert tshapes[k] == tuple(jshapes[k])
    jd = jcomp.decompress_grads((jc, jshapes))
    td = tcomp.decompress_grads((tc, tshapes))
    for k in g:
        assert np.array_equal(_bits(td[k].numpy()), _bits(jd[k])), k


def test_compression_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    g = {"a": torch.from_numpy(rng.normal(size=(300,)).astype(np.float32)),
         "b": torch.from_numpy(rng.normal(size=(17, 5)).astype(np.float32))}
    out = tcomp.decompress_grads(tcomp.compress_grads(g))
    for x, y in zip(_tree.leaves(g), _tree.leaves(out)):
        err = float((x - y).abs().max())
        scale = float(x.abs().max())
        assert err <= scale / 127 + 1e-6


def test_error_feedback_reduces_bias_as_reference():
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(1000,)) * 1e-3).astype(np.float32)
    g = {"w": torch.from_numpy(w)}
    jg = {"w": jnp.asarray(w)}
    res, jres = None, None
    acc_plain = np.zeros(1000)
    acc_ef = np.zeros(1000)
    for _ in range(20):
        deq, res = tcomp.error_feedback_update(g, res)
        jdeq, jres = jcomp.error_feedback_update(jg, jres)
        np.testing.assert_allclose(deq["w"].numpy(), np.asarray(jdeq["w"]),
                                   rtol=0, atol=1e-9)
        acc_ef += deq["w"].numpy()
        acc_plain += tcomp.decompress_grads(
            tcomp.compress_grads(g))["w"].numpy()
    true = 20 * w
    assert (np.abs(acc_ef - true).mean()
            <= np.abs(acc_plain - true).mean() + 1e-7)


def test_roundtrip_in_place_equals_compress(monkeypatch):
    """``roundtrip_`` runs of 2 blocks (and a ragged tail) equal one
    whole-leaf ``decompress(compress(.))``, written over the input."""
    monkeypatch.setattr(tcomp, "RUN", 2 * tcomp.BLOCK)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(9, 130)).astype(np.float32))
    want = tcomp.decompress_grads(tcomp.compress_grads({"x": x}))["x"]
    y = x.clone()
    assert tcomp.roundtrip_(y) is y
    assert torch.equal(y, want)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,index", [(7, 0), (7, 5), (0, 123)])
def test_tokenstream_equals_reference(seed, index):
    ref = JTokenStream(1000, 4, 16, seed=seed).batch_at(index)
    got = TokenStream(1000, 4, 16, seed=seed).batch_at(index)
    for k in ("tokens", "labels"):
        assert got[k].dtype == ref[k].dtype == np.int32
        assert np.array_equal(got[k], ref[k])
    assert np.array_equal(got["labels"][:, :-1], got["tokens"][:, 1:])


def test_tokenstream_deterministic_and_restartable():
    s1 = TokenStream(1000, 4, 16, seed=7)
    s2 = TokenStream(1000, 4, 16, seed=7)
    b5a, b5b = s1.batch_at(5), s2.batch_at(5)
    assert np.array_equal(b5a["tokens"], b5b["tokens"])
    assert np.array_equal(b5a["labels"], b5b["labels"])
    assert not np.array_equal(s1.batch_at(6)["tokens"], b5a["tokens"])
    first = next(iter(s1))
    assert np.array_equal(first["tokens"], s1.batch_at(0)["tokens"])
    cfg = tconfigs.smoke("qwen1_5_4b")
    stream = make_lm_batches(cfg, 2, 8, seed=3)
    assert stream.vocab == cfg.vocab_size and stream.seed == 3


@pytest.mark.parametrize("n,seed,skew", [(200, 0, 0.5), (96, 0, 0.3),
                                         (50, 4, 0.0)])
def test_synthetic_relation_equals_reference(n, seed, skew):
    assert synthetic_relation(n, seed=seed, skew=skew) == j_relation(
        n, seed=seed, skew=skew)


def test_synthetic_relation_skew():
    rows = synthetic_relation(200, seed=0, skew=0.5)
    assert sum(1 for r in rows if r[1] == "John") > 60


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetcher_yields_in_order(device):
    stream = TokenStream(100, 2, 8, seed=0)
    it = (stream.batch_at(i) for i in range(5))
    pf = Prefetcher(it, depth=2, device=device)
    got = [next(pf) for _ in range(5)]
    for i, b in enumerate(got):
        want = stream.batch_at(i)
        if device is None:
            assert np.array_equal(b["tokens"], want["tokens"])
        else:
            assert isinstance(b["tokens"], torch.Tensor)
            assert b["tokens"].dtype == torch.int32
            assert np.array_equal(b["labels"].numpy(), want["labels"])
    pf.close()
    pf._th.join(timeout=10)
    assert not pf._th.is_alive()


# ---------------------------------------------------------------------------
# the launcher: resume from the newest valid checkpoint
# ---------------------------------------------------------------------------

def _run(tmp, steps, history, *extra):
    argv = ["--arch", "qwen1.5-4b", "--smoke", "--steps", str(steps),
            "--batch", "2", "--seq", "16", "--log-every", "100",
            "--device", "cpu", *extra]
    if tmp is not None:
        argv += ["--ckpt-dir", str(tmp), "--ckpt-every", "2"]
    return train_launcher.main(argv, on_step=lambda s, p, o, m: history.append(
        (s, float(m["loss"]), float(m["lr"]))))


class _Crash(Exception):
    pass


def test_launcher_resume_equals_uninterrupted(tmp_path, capsys):
    """A run that dies after step 3 (its step-2 checkpoint and a torn
    step_4.tmp on disk) and is restarted gives the uninterrupted run's
    losses from step 2 on, and the same final parameters."""
    full = []
    final = _run(tmp_path / "a", 6, full)
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == {"final_loss": final, "steps": 6}
    assert [s for s, _, _ in full] == list(range(6))

    crashed = []

    def crash(s, p, o, m):
        crashed.append((s, float(m["loss"]), float(m["lr"])))
        if s == 3:
            raise _Crash

    with pytest.raises(_Crash):
        train_launcher.main(["--arch", "qwen1.5-4b", "--smoke", "--steps",
                           "6", "--batch", "2", "--seq", "16",
                           "--device", "cpu", "--ckpt-dir",
                           str(tmp_path / "b"), "--ckpt-every", "2"],
                          on_step=crash)
    deadline = time.monotonic() + 60   # the step-2 writer outlives the
    while latest_step(str(tmp_path / "b")) != 2 \
            and time.monotonic() < deadline:  # crash in this process
        time.sleep(0.01)
    os.makedirs(tmp_path / "b" / "step_4.tmp")
    resumed = []
    _run(tmp_path / "b", 6, resumed)
    assert "resumed from step 2" in capsys.readouterr().out
    assert crashed == full[:4]
    assert resumed == full[2:]
    cfg = tconfigs.smoke("qwen1_5_4b")
    params = tlm.init_params(0, cfg, device="cpu")
    tmpl = (params, topt.init_state(params))
    sa, a = restore_checkpoint(str(tmp_path / "a"), tmpl)
    sb, b = restore_checkpoint(str(tmp_path / "b"), tmpl)
    assert sa == sb == 6
    for x, y in zip(_tree.leaves(a), _tree.leaves(b)):
        assert _same(x, y)
