"""The port's decoders (``repro_torch.models.lm``) against the reference.

The reference's parameters (``repro.models.lm.init_params``) are carried
across with ``params_from_arrays``, so both packages run identical weights
on identical tokens (drawn with numpy from a seed):

* qwen1.5-4b, chatglm3-6b (GQA, RoPE on half the head dims), gemma3-1b
  (sliding window with ``global_every``, QK-norm, GeGLU, tied and scaled
  embeddings), minicpm3-4b (MLA), granite and moonshot (MoE, the latter
  with shared experts), mamba2-2.7b (SSM), hymba-1.5b (attention + SSM),
  seamless-m4t-medium (encoder-decoder; 8 audio frames a request) and
  internvl2-76b (a ViT prefix of ``n_prefix`` patches) smoke configs in
  float32: ``forward``, ``prefill`` and three ``decode_step``s give
  logits within atol 1e-4 / rtol 1e-4 of the reference and caches (KV,
  MLA latent, SSM conv buffers and state, cross-attention K/V) within the
  same tolerance; greedy decoding picks the same tokens;
* ``flash_attention`` past one 512-key block (Tk = 513 and 1,300) and a
  600-token prefill plus decode, within the same float32 tolerance: the
  port scans the reference's key blocks in its order;
* the chunked log-sum-exp decode path (a cache of 1,024 positions) within
  the same float32 tolerance;
* one bfloat16 case within atol 0.12 / rtol 0.05, the tolerance the
  reference holds its own bfloat16 decode to: both packages round every
  matmul output to bfloat16 but accumulate in different orders, so the
  last bits of an activation may differ (3 bf16 ulps of a logit seen);
* decode matches forward at the same position within the reference's own
  tolerance (``tests/test_arch_smoke.py``: atol 0.12, rtol 0.05) in the
  configs' own bfloat16;
* ``train_loss`` gives the reference's loss (``tests/test_torch_train.py``
  holds it and its gradients for every family).

The frontend inputs (``frames``, ``patches``) are drawn with numpy from a
seed and given to both packages (``_frontend``).
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
from repro_torch.models import lm as tlm

ARCHS = ["qwen1_5_4b", "chatglm3_6b", "gemma3_1b", "minicpm3_4b",
         "granite_moe_3b_a800m", "moonshot_v1_16b_a3b", "mamba2_2_7b",
         "hymba_1_5b", "seamless_m4t_medium", "internvl2_76b"]
#: a weight of each family drawn as N(0, 1/d_model) (fan-in d_model)
PROBE = {"mla": ("attn", "wdq"), "ssm": ("ssm", "w_x"),
         "moe": ("moe", "w_gate"), "gqa": ("attn", "wq")}
ATOL = RTOL = 1e-4           # float32 logits and caches
BF16_ATOL, BF16_RTOL = 0.12, 0.05    # bfloat16 logits
B, T = 2, 12
N_FRAMES = 8                 # encoder frames a request (encoder-decoder)


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jconfigs.smoke(arch), dtype=dtype),
            dataclasses.replace(tconfigs.smoke(arch), dtype=dtype))


def _pair(arch, dtype="float32", seed=0):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = tlm.params_from_arrays(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _frontend(cfg, b, seed=5):
    """A batch's frontend inputs for ``cfg`` (numpy float32): ``frames``
    (b, N_FRAMES, frontend_dim) for an encoder-decoder, ``patches`` (b,
    n_prefix, frontend_dim) for a ViT prefix, nothing otherwise."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.n_enc_layers:
        out["frames"] = rng.standard_normal(
            (b, N_FRAMES, cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "vit":
        out["patches"] = rng.standard_normal(
            (b, cfg.n_prefix, cfg.frontend_dim)).astype(np.float32)
    return out


def _prefix(cfg):
    """Positions a ViT prefix takes before the tokens."""
    return cfg.n_prefix if cfg.frontend == "vit" else 0


def _jbatch(toks, extra):
    return {"tokens": jnp.asarray(toks),
            **{k: jnp.asarray(v) for k, v in extra.items()}}


def _tbatch(toks, extra):
    return {"tokens": torch.as_tensor(toks),
            **{k: torch.as_tensor(v) for k, v in extra.items()}}


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

def test_config_registry_matches_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    for arch in jconfigs.ARCH_IDS:
        for which in ("full", "smoke"):
            want = dataclasses.asdict(getattr(jconfigs, which)(arch))
            got = dataclasses.asdict(getattr(tconfigs, which)(arch))
            assert got == want, (arch, which)
    assert tconfigs.get("qwen1.5-4b").full().param_count() == \
        jconfigs.full("qwen1_5_4b").param_count()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_cross_bit_exact(dtype):
    """Every leaf carries across bit for bit, bf16 through its bits."""
    _, _, jp, tp = _pair("qwen1_5_4b", dtype)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in jl:
        node = tp
        for k in path:
            node = node[k.key]
        want = np.asarray(leaf)
        assert tuple(node.shape) == want.shape
        assert str(node.dtype).split(".")[-1] == want.dtype.name
        got = node.view(torch.int16).numpy() if node.dtype == torch.bfloat16 \
            else node.numpy()
        ref = want.view(np.int16) if want.dtype.name == "bfloat16" else want
        assert np.array_equal(got, ref), path


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    """The port's own synthetic weights have the reference's tree, shapes
    and dtypes (the numbers come from torch generators) and scales."""
    jcfg, tcfg = jconfigs.smoke(arch), tconfigs.smoke(arch)
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    tp = tlm.init_params(3, tcfg, device="cpu")
    flat = jax.tree_util.tree_leaves_with_path(shapes)
    assert len(flat) == len(jax.tree_util.tree_leaves(
        jax.tree.map(lambda t: 0, tp, is_leaf=torch.is_tensor)))
    for path, sds in flat:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == sds.shape, path
        assert str(node.dtype).split(".")[-1] == str(sds.dtype), path
    kind = ("ssm" if tcfg.family == "ssm" else "mla"
            if tcfg.attn_type == "mla" else "moe" if tcfg.family == "moe"
            else "gqa")
    mod, name = PROBE[kind]
    again = tlm.init_params(3, tcfg, device="cpu")
    assert torch.equal(tp["blocks"][mod][name], again["blocks"][mod][name])
    w = tp["blocks"][mod][name].float()
    assert not torch.equal(w[0], w[1])               # layers drawn apart
    assert abs(float(w.std()) * tcfg.d_model ** 0.5 - 1.0) < 0.1


# ---------------------------------------------------------------------------
# forward / prefill / decode parity (float32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(jcfg, (B, T))
    extra, pre = _frontend(jcfg, B), _prefix(jcfg)
    _close(tlm.forward(tp, tcfg, _tbatch(toks, extra)),
           jlm.forward(jp, jcfg, _jbatch(toks, extra)))

    lj, cj = jlm.prefill(jp, jcfg, _jbatch(toks[:, :8], extra),
                         max_len=16 + pre)
    lt, ct = tlm.prefill(tp, tcfg, _tbatch(toks[:, :8], extra),
                         max_len=16 + pre)
    _close(lt, lj)
    for s in range(3):
        step = toks[:, 8 + s:9 + s]
        lj, cj = jlm.decode_step(jp, jcfg, cj, pre + 8 + s,
                                 {"tokens": jnp.asarray(step)})
        lt, ct = tlm.decode_step(tp, tcfg, ct, pre + 8 + s,
                                 {"tokens": torch.as_tensor(step)})
        assert lt.shape == (B, 1, tcfg.vocab_size)
        _close(lt, lj)
        assert sorted(ct) == sorted(cj)
        for part in cj:
            for got, want in zip(ct[part], cj[part], strict=True):
                assert tuple(got.shape) == want.shape
                assert str(got.dtype).split(".")[-1] == str(want.dtype)
                _close(got, want)


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "hymba_1_5b"])
def test_multi_token_decode_step_matches_reference(arch):
    """A two-token decode step of an SSM family (the reference's SSM
    update takes one token) gives the reference's logits and cache after
    two one-token steps: the SSM's conv buffers and state, and Hymba's KV
    cache, every leaf."""
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(jcfg, (B, 10))
    lj, cj = jlm.prefill(jp, jcfg, _jbatch(toks[:, :8], {}), max_len=12)
    _, ct = tlm.prefill(tp, tcfg, _tbatch(toks[:, :8], {}), max_len=12)
    want = []
    for s in range(2):
        lj, cj = jlm.decode_step(jp, jcfg, cj, 8 + s,
                                 {"tokens": jnp.asarray(toks[:, 8 + s:9 + s])})
        want.append(np.asarray(lj))
    lt, ct = tlm.decode_step(tp, tcfg, ct, 8,
                             {"tokens": torch.as_tensor(toks[:, 8:10])})
    assert lt.shape == (B, 2, tcfg.vocab_size)
    _close(lt, np.concatenate(want, 1))
    assert sorted(ct) == sorted(cj)
    for part in cj:
        for got, w in zip(ct[part], cj[part], strict=True):
            assert tuple(got.shape) == w.shape
            _close(got, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference(arch):
    """Greedy decoding through each package picks the same tokens."""
    jcfg, tcfg, jp, tp = _pair(arch, seed=2)
    prompt = _tokens(jcfg, (B, 6), seed=3)
    extra, pre = _frontend(jcfg, B, seed=6), _prefix(jcfg)
    lj, cj = jlm.prefill(jp, jcfg, _jbatch(prompt, extra), max_len=12 + pre)
    lt, ct = tlm.prefill(tp, tcfg, _tbatch(prompt, extra), max_len=12 + pre)
    tj, tt = [], []
    for i in range(5):
        nj = jnp.argmax(lj[:, -1], axis=-1)[:, None]
        nt = torch.argmax(lt[:, -1], dim=-1, keepdim=True)
        tj.append(np.asarray(nj))
        tt.append(nt.numpy())
        lj, cj = jlm.decode_step(jp, jcfg, cj, pre + 6 + i, {"tokens": nj})
        lt, ct = tlm.decode_step(tp, tcfg, ct, pre + 6 + i, {"tokens": nt})
    assert np.array_equal(np.concatenate(tj, 1), np.concatenate(tt, 1))


def test_chunked_decode_attention_matches_reference():
    """A 1,024-position cache takes the chunked log-sum-exp decode path in
    both packages (``decode_attention``); its logits and the function
    itself on random inputs agree to float32 rounding."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    jcfg, tcfg, jp, tp = _pair("gemma3_1b")
    toks = _tokens(jcfg, (B, 9))
    lj, cj = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :8])},
                         max_len=1024)
    lt, ct = tlm.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks[:, :8])},
                         max_len=1024)
    lj, _ = jlm.decode_step(jp, jcfg, cj, 8, {"tokens": jnp.asarray(
        toks[:, 8:])})
    lt, _ = tlm.decode_step(tp, tcfg, ct, 8, {"tokens": torch.as_tensor(
        toks[:, 8:])})
    _close(lt, lj)

    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 1024, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 1024, 2, 16)).astype(np.float32)
    for kv_len, window in ((700, None), (1024, 100), (5, 3)):
        want = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), kv_len=kv_len,
                                        window=window)
        got = tlayers.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                                       torch.as_tensor(v), kv_len=kv_len,
                                       window=window)
        _close(got, want)


def test_softcap_and_window_attention_match_reference():
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 10, 6, 8)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    for kw in (dict(window=3), dict(softcap=5.0), dict(causal=False),
               dict(q_offset=0, kv_len=7)):
        _close(tlayers.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                                       torch.as_tensor(v), **kw),
               jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), **kw))


@pytest.mark.parametrize("tk", [513, 1300])
@pytest.mark.parametrize("case", ["causal", "window", "softcap", "kv_len",
                                  "q_offset", "full"])
def test_flash_attention_blocks_match_reference(tk, case):
    """Past one 512-key block the port's online softmax follows the
    reference's blocks and order: within float32 rounding at a ragged
    last block (513, 1,300 keys)."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    rng = np.random.default_rng(tk)
    tq = {"q_offset": 7, "kv_len": tk}.get(case, tk)
    q = rng.standard_normal((2, tq, 4, 16)).astype(np.float32) * 2
    k = rng.standard_normal((2, tk, 2, 16)).astype(np.float32) * 2
    v = rng.standard_normal((2, tk, 2, 16)).astype(np.float32)
    kw = {"causal": {}, "window": dict(window=700), "softcap": dict(
        softcap=5.0), "kv_len": dict(kv_len=tk - 200, causal=False),
          "q_offset": dict(q_offset=tk - 7), "full": dict(causal=False)}[case]
    _close(tlayers.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                                   torch.as_tensor(v), **kw),
           jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw))


def test_flash_attention_holds_one_block_of_scores(monkeypatch):
    """No score tensor wider than one key block is made: every einsum's
    output in the loop has at most 512 keys, whatever Tk."""
    from repro_torch.models import layers as tlayers
    widest = []
    real = torch.einsum

    def spy(eq, *ops):
        out = real(eq, *ops)
        if eq.endswith("->bkgts"):
            widest.append(out.shape[-1])
        return out

    monkeypatch.setattr(tlayers.torch, "einsum", spy)
    q = torch.randn(1, 40, 2, 8)
    k = torch.randn(1, 1300, 2, 8)
    tlayers.flash_attention(q, k, k, causal=False)
    assert widest == [512, 512, 512]


@pytest.mark.parametrize("arch", ["qwen1_5_4b", "minicpm3_4b"])
def test_long_prefill_and_decode_match_reference(arch):
    """A float32 prefill of 600 tokens (two key blocks; MLA expands its
    cache and runs ``flash_attention`` on it) and two decode steps."""
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(jcfg, (1, 602), seed=9)
    lj, cj = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :600])},
                         max_len=608)
    lt, ct = tlm.prefill(tp, tcfg, {"tokens": torch.as_tensor(
        toks[:, :600])}, max_len=608)
    _close(lt, lj)
    for s in range(2):
        step = toks[:, 600 + s:601 + s]
        lj, cj = jlm.decode_step(jp, jcfg, cj, 600 + s,
                                 {"tokens": jnp.asarray(step)})
        lt, ct = tlm.decode_step(tp, tcfg, ct, 600 + s,
                                 {"tokens": torch.as_tensor(step)})
        _close(lt, lj)
    for got, want in zip(ct["kv"], cj["kv"]):
        _close(got, want)


# ---------------------------------------------------------------------------
# bfloat16 and decode == forward
# ---------------------------------------------------------------------------

def test_bf16_forward_and_decode_match_reference():
    jcfg, tcfg, jp, tp = _pair("qwen1_5_4b", "bfloat16")
    toks = _tokens(jcfg, (B, T))
    _close(tlm.forward(tp, tcfg, {"tokens": torch.as_tensor(toks)}),
           jlm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}),
           atol=BF16_ATOL, rtol=BF16_RTOL)
    _, cj = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :8])},
                        max_len=12)
    _, ct = tlm.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks[:, :8])},
                        max_len=12)
    lj, _ = jlm.decode_step(jp, jcfg, cj, 8, {"tokens": jnp.asarray(
        toks[:, 8:9])})
    lt, _ = tlm.decode_step(tp, tcfg, ct, 8, {"tokens": torch.as_tensor(
        toks[:, 8:9])})
    assert ct["kv"][0].dtype == torch.bfloat16
    _close(lt, lj, atol=BF16_ATOL, rtol=BF16_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Prefill + decode logits == the full forward at the same position,
    in the config's own dtype (bfloat16), within the reference's
    tolerance."""
    cfg = tconfigs.smoke(arch)
    params = tlm.init_params(3, cfg, device="cpu")
    toks = _tokens(cfg, (1, 9), seed=4)
    extra, pre = _frontend(cfg, 1), _prefix(cfg)
    full = tlm.forward(params, cfg, _tbatch(toks, extra))
    _, cache = tlm.prefill(params, cfg, _tbatch(toks[:, :8], extra),
                           max_len=12 + pre)
    l2, _ = tlm.decode_step(params, cfg, cache, pre + 8,
                            {"tokens": torch.as_tensor(toks[:, 8:9])})
    _close(l2[:, 0], full[:, pre + 8], atol=BF16_ATOL, rtol=BF16_RTOL)


def test_embeds_seam_and_cache_capacity():
    """``batch["embeds"]`` replaces the lookup; a step past the cache's
    capacity raises instead of writing elsewhere."""
    _, tcfg, _, tp = _pair("qwen1_5_4b")
    toks = torch.as_tensor(_tokens(tcfg, (B, 4)))
    emb = tp["embed"][toks]
    want = tlm.forward(tp, tcfg, {"tokens": toks})
    got = tlm.forward(tp, tcfg, {"tokens": toks * 0, "embeds": emb})
    assert torch.equal(got, want)
    _, cache = tlm.prefill(tp, tcfg, {"tokens": toks}, max_len=4)
    with pytest.raises(ValueError, match="cache holds 4"):
        tlm.decode_step(tp, tcfg, cache, 4, {"tokens": toks[:, :1]})


# ---------------------------------------------------------------------------
# training (the full parity suite is tests/test_torch_train.py)
# ---------------------------------------------------------------------------

def test_training_raises():
    """``train_loss`` is ported: on the reference's weights and batch it
    gives the reference's loss and token count; like the reference's, it
    raises ``KeyError`` on a batch without ``labels``."""
    jcfg, tcfg, jp, tp = _pair("qwen1_5_4b")
    toks = _tokens(tcfg, (B, T))
    labels = _tokens(tcfg, (B, T), seed=2)
    labels[1, 0] = -1
    jl, jm = jlm.train_loss(jp, jcfg, {"tokens": jnp.asarray(toks),
                                       "labels": jnp.asarray(labels)})
    tl, tm = tlm.train_loss(tp, tcfg, {"tokens": torch.as_tensor(toks),
                                       "labels": torch.as_tensor(labels)})
    assert abs(float(tl) - float(jl)) <= 1e-5
    assert float(tm["tokens"]) == float(jm["tokens"]) == B * T - 1
    with pytest.raises(KeyError, match="labels"):
        tlm.train_loss(tp, tcfg, {"tokens": torch.as_tensor(toks)})
