"""The encoder-decoder (seamless-m4t-medium) and ViT-prefixed
(internvl2-76b) families of ``repro_torch.models.lm`` against the
reference, at smoke width in float32, the reference's parameters carried
across with ``params_from_arrays`` and every input drawn with numpy from a
seed:

* ``_encode``'s output and the prefilled cross-attention cache
  (``cache["cross"]``) within atol 1e-4 / rtol 1e-4 of the reference's at 8
  frames and at 520 (past one 512-key block of ``flash_attention``);
* the encoder is causal, as the reference's code runs it (its docstring
  says bidirectional): frame i's output does not move when later frames
  do, so a bidirectional port would fail the parity above;
* decode steps read the cross cache, never write it, and give the
  reference's logits;
* internvl's prefix counts in the positions: a decode step at
  ``cache_len`` = n_prefix + prompt writes the cache there and gives the
  reference's logits;
* private generation (``private_embed=True``, the reference's
  ``embed_shares`` carried across) gives the reference's greedy tokens;
* an encoder-decoder batch without ``frames`` raises ``KeyError``;
* ``init_params`` draws pinned weights for the eight decoder-only
  families: the encoder and frontend keys are extra children of the key
  split, so they leave the other children's draws as they are.
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
from repro.models import private_embed as jpe
from repro_torch.models import lm as tlm

ATOL = RTOL = 1e-4
SEAMLESS, INTERNVL = "seamless_m4t_medium", "internvl2_76b"


def _pair(arch, seed=0, shares=False):
    jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.smoke(arch), dtype="float32")
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    if shares:
        jp["embed_shares"] = jpe.setup_private_embed(
            jax.random.PRNGKey(seed + 1), jp["embed"], n_shares=4).values
    tp = tlm.params_from_arrays(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def seamless():
    return _pair(SEAMLESS)


# ---------------------------------------------------------------------------
# encoder-decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_frames", [8, 520])
def test_encoder_and_cross_cache_match_reference(seamless, n_frames):
    jcfg, tcfg, jp, tp = seamless
    frames = _normal((2, n_frames, jcfg.frontend_dim), n_frames)
    _close(tlm._encode(tp, tcfg, torch.as_tensor(frames)),
           jlm._encode(jp, jcfg, jnp.asarray(frames)))
    toks = _tokens(jcfg, (2, 5))
    lj, cj = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                    "frames": jnp.asarray(frames)},
                         max_len=8)
    lt, ct = tlm.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks),
                                    "frames": torch.as_tensor(frames)},
                         max_len=8)
    _close(lt, lj)
    for got, want in zip(ct["cross"], cj["cross"], strict=True):
        assert tuple(got.shape) == want.shape == (
            tcfg.n_layers, 2, n_frames, tcfg.n_kv_heads,
            tcfg.resolved_head_dim)
        _close(got, want)


def test_encoder_is_causal_as_the_reference_runs_it(seamless):
    """Changing the last frames leaves every earlier frame's encoder
    output as it was, in both packages."""
    jcfg, tcfg, jp, tp = seamless
    frames = _normal((1, 12, jcfg.frontend_dim), 3)
    moved = frames.copy()
    moved[:, 8:] = _normal((1, 4, jcfg.frontend_dim), 4)
    got = [tlm._encode(tp, tcfg, torch.as_tensor(f)).numpy()
           for f in (frames, moved)]
    want = [np.asarray(jlm._encode(jp, jcfg, jnp.asarray(f)))
            for f in (frames, moved)]
    for out in (got, want):
        np.testing.assert_array_equal(out[0][:, :8], out[1][:, :8])
        assert np.abs(out[0][:, 8:] - out[1][:, 8:]).max() > 1e-3
    _close(got[1], want[1])


def test_decode_reads_cross_cache_and_matches_reference(seamless):
    jcfg, tcfg, jp, tp = seamless
    frames = _normal((2, 16, jcfg.frontend_dim), 7)
    toks = _tokens(jcfg, (2, 8), seed=2)
    _, cj = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :5]),
                                   "frames": jnp.asarray(frames)}, max_len=8)
    _, ct = tlm.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks[:, :5]),
                                   "frames": torch.as_tensor(frames)},
                        max_len=8)
    cross = [a.clone() for a in ct["cross"]]
    ptrs = [a.data_ptr() for a in ct["cross"]]
    for s in range(5, 8):
        step = toks[:, s:s + 1]
        lj, cj = jlm.decode_step(jp, jcfg, cj, s, {"tokens": jnp.asarray(
            step)})
        lt, ct = tlm.decode_step(tp, tcfg, ct, s, {"tokens": torch.as_tensor(
            step)})
        _close(lt, lj)
    assert [a.data_ptr() for a in ct["cross"]] == ptrs      # in place
    for a, b in zip(ct["cross"], cross):
        assert torch.equal(a, b)                            # never written
    # decode attends to the cache: zeroing it moves the logits
    ct["cross"][0].zero_()
    ct["cross"][1].zero_()
    lz, _ = tlm.decode_step(tp, tcfg, ct, 7, {"tokens": torch.as_tensor(
        toks[:, 7:8])})
    assert not torch.allclose(lz, lt, atol=1e-3)


def test_encdec_batch_without_frames_raises(seamless):
    _, tcfg, _, tp = seamless
    batch = {"tokens": torch.zeros((1, 3), dtype=torch.int64)}
    with pytest.raises(KeyError, match="frames"):
        tlm.forward(tp, tcfg, batch)
    with pytest.raises(KeyError, match="frames"):
        tlm.prefill(tp, tcfg, batch, max_len=4)


# ---------------------------------------------------------------------------
# ViT prefix
# ---------------------------------------------------------------------------

def test_vit_prefix_counts_in_decode_positions():
    jcfg, tcfg, jp, tp = _pair(INTERNVL, seed=3)
    pre = tcfg.n_prefix
    patches = _normal((2, pre, jcfg.frontend_dim), 5)
    toks = _tokens(jcfg, (2, 7), seed=4)
    full = tlm.forward(tp, tcfg, {"tokens": torch.as_tensor(toks),
                                  "patches": torch.as_tensor(patches)})
    assert full.shape == (2, pre + 7, tcfg.vocab_size)
    _close(full, jlm.forward(jp, jcfg, {"tokens": jnp.asarray(toks),
                                        "patches": jnp.asarray(patches)}))
    _, cj = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :6]),
                                   "patches": jnp.asarray(patches)},
                        max_len=pre + 8)
    _, ct = tlm.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks[:, :6]),
                                   "patches": torch.as_tensor(patches)},
                        max_len=pre + 8)
    assert not ct["kv"][0][:, :, pre + 6:].any()
    lj, cj = jlm.decode_step(jp, jcfg, cj, pre + 6,
                             {"tokens": jnp.asarray(toks[:, 6:7])})
    lt, ct = tlm.decode_step(tp, tcfg, ct, pre + 6,
                             {"tokens": torch.as_tensor(toks[:, 6:7])})
    _close(lt, lj)
    _close(lt[:, 0], full[:, pre + 6])
    assert ct["kv"][0][:, :, pre + 6].any()
    assert not ct["kv"][0][:, :, pre + 7:].any()
    for got, want in zip(ct["kv"], cj["kv"]):
        _close(got, want)


# ---------------------------------------------------------------------------
# private generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [SEAMLESS, INTERNVL])
def test_private_generation_matches_reference(arch):
    """Greedy tokens of the private route (``private_embed=True`` over the
    reference's table shares) equal the reference's private route's."""
    jcfg, tcfg, jp, tp = _pair(arch, seed=5, shares=True)
    jcfg = dataclasses.replace(jcfg, private_embed=True)
    tcfg = dataclasses.replace(tcfg, private_embed=True)
    extra = ({"frames": _normal((2, 10, jcfg.frontend_dim), 6)}
             if jcfg.n_enc_layers else
             {"patches": _normal((2, jcfg.n_prefix, jcfg.frontend_dim), 6)})
    pre = jcfg.n_prefix if "patches" in extra else 0
    prompt = _tokens(jcfg, (2, 4), seed=7)
    lj, cj = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt),
                                    **{k: jnp.asarray(v)
                                       for k, v in extra.items()}},
                         max_len=pre + 10)
    lt, ct = tlm.prefill(tp, tcfg, {"tokens": torch.as_tensor(prompt),
                                    **{k: torch.as_tensor(v)
                                       for k, v in extra.items()}},
                         max_len=pre + 10)
    _close(lt, lj)
    tj, tt = [], []
    for i in range(5):
        nj = jnp.argmax(lj[:, -1], axis=-1)[:, None]
        nt = torch.argmax(lt[:, -1], dim=-1, keepdim=True)
        tj.append(np.asarray(nj))
        tt.append(nt.numpy())
        lj, cj = jlm.decode_step(jp, jcfg, cj, pre + 4 + i, {"tokens": nj})
        lt, ct = tlm.decode_step(tp, tcfg, ct, pre + 4 + i, {"tokens": nt})
    assert np.array_equal(np.concatenate(tj, 1), np.concatenate(tt, 1))


# ---------------------------------------------------------------------------
# the decoder-only families draw the same weights as before
# ---------------------------------------------------------------------------

#: sum over every leaf of ``init_params(0, smoke config)`` of each element
#: (float64) times 1 + (its flat index mod 5), as the decoder-only key
#: layout draws them (three children of the root key, three of each block
#: key)
PINNED = {
    "qwen1_5_4b": 25.12842433154583,
    "chatglm3_6b": 17.96226827800274,
    "gemma3_1b": -31.83870692551136,
    "minicpm3_4b": 11.652585744857788,
    "granite_moe_3b_a800m": 132.41697678204218,
    "moonshot_v1_16b_a3b": 164.75935003395716,
    "mamba2_2_7b": -183.0964785516262,
    "hymba_1_5b": -73.49519999325275,
}


def _checksum(tree) -> float:
    total = 0.0
    for _, leaf in sorted(_flat(tree)):
        w = 1 + torch.arange(leaf.numel(), dtype=torch.float64).reshape(
            leaf.shape) % 5
        total += float((leaf.double() * w).sum())
    return total


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", sorted(PINNED))
def test_decoder_only_weights_unchanged(arch):
    params = tlm.init_params(0, tconfigs.smoke(arch), device="cpu")
    assert "enc_blocks" not in params and "frontend_proj" not in params
    assert "cross" not in params["blocks"]
    assert _checksum(params) == pytest.approx(PINNED[arch], abs=1e-6)
