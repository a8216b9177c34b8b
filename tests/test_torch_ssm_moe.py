"""The port's Mamba-2 SSM, MoE dispatches and MLA absorbed decode against
the reference (``repro.models.ssm`` and ``repro.models.layers``).

Inputs are drawn with numpy from a seed; parameters are the reference's,
carried across with ``models.lm.params_from_arrays``. Float32 throughout,
within atol 1e-4 / rtol 1e-4:

* ``ssd_chunked`` with and without an initial state, several chunks of 4;
  ``ssm_forward`` at lengths that are a multiple of the chunk and ragged
  (padded), with the prefill cache (the last k-1 raw rows, left-padded
  below k-1 tokens) and the one-token recurrent update; a recurrent step
  of 2 and 3 tokens against as many of the reference's one-token updates;
* ``softplus`` against ``jax.nn.softplus`` across float32's range;
* each MoE dispatch against the reference's, the sort at the default
  capacity and at 0.5 (pairs overflow and are dropped); the port's sort
  against its einsum dispatch at capacity 8.0 in bfloat16 within atol 0.06
  (the port twin of ``tests/test_arch_smoke.py``'s check);
* MLA's absorbed one-token decode against a 1,024-position cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm

ATOL = RTOL = 1e-4


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(jconfigs.smoke(arch), **kw),
            dataclasses.replace(tconfigs.smoke(arch), **kw))


def _params(jcfg, init, seed=0):
    """A reference layer's parameters and the port's copy of them."""
    jp = init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = tlm.params_from_arrays(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(with_state):
    rng = np.random.default_rng(10)
    b, t, h, p, n = 2, 12, 3, 4, 5
    x = _rand(rng, (b, t, h, p))
    a_dt = -np.abs(_rand(rng, (b, t, h), 0.5))
    bm, cm = _rand(rng, (b, t, n)), _rand(rng, (b, t, n))
    s0 = _rand(rng, (b, h, p, n)) if with_state else None
    yj, fj = jssm.ssd_chunked(jnp.asarray(x), jnp.asarray(a_dt),
                              jnp.asarray(bm), jnp.asarray(cm), chunk=4,
                              init_state=None if s0 is None
                              else jnp.asarray(s0))
    yt, ft = tssm.ssd_chunked(torch.as_tensor(x), torch.as_tensor(a_dt),
                              torch.as_tensor(bm), torch.as_tensor(cm),
                              chunk=4, init_state=None if s0 is None
                              else torch.as_tensor(s0))
    assert ft.dtype == torch.float32 and tuple(ft.shape) == (b, h, p, n)
    _close(yt, yj)
    _close(ft, fj)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tssm.ssd_chunked(torch.as_tensor(x[:, :10]),
                         torch.as_tensor(a_dt[:, :10]),
                         torch.as_tensor(bm[:, :10]),
                         torch.as_tensor(cm[:, :10]), chunk=4)


@pytest.mark.parametrize("t", [2, 8, 10, 13])
def test_ssm_prefill_and_recurrent_update_match_reference(t):
    """ssm_chunk = 4, so 8 tokens are two whole chunks, 10 and 13 a padded
    last chunk, and 2 a single chunk shorter than the conv's k-1 = 3
    history rows (the cache left-pads them). Then three one-token updates
    from the prefill cache."""
    jcfg, tcfg = _cfgs("mamba2_2_7b", ssm_chunk=4)
    jp, tp = _params(jcfg, jssm.ssm_init)
    rng = np.random.default_rng(t)
    u = _rand(rng, (2, t + 3, jcfg.d_model))
    yj, cj = jssm.ssm_forward(jp, jcfg, jnp.asarray(u[:, :t]),
                              return_cache=True)
    yt, ct = tssm.ssm_forward(tp, tcfg, torch.as_tensor(u[:, :t]),
                              return_cache=True)
    _close(yt, yj)
    assert isinstance(ct, tssm.SSMCache) and ct._fields == cj._fields
    for got, want in zip(ct, cj):
        assert tuple(got.shape) == want.shape
        _close(got, want)
    if t < 3:
        assert not ct.conv_x[:, :3 - t].any()
    fj, _ = jssm.ssm_forward(jp, jcfg, jnp.asarray(u[:, :t]))
    ft, none = tssm.ssm_forward(tp, tcfg, torch.as_tensor(u[:, :t]))
    assert none is None
    _close(ft, fj)
    for s in range(3):
        step = u[:, t + s:t + s + 1]
        yj, cj = jssm.ssm_forward(jp, jcfg, jnp.asarray(step), cache=cj)
        yt, ct = tssm.ssm_forward(tp, tcfg, torch.as_tensor(step), cache=ct)
        assert ct.state.dtype == torch.float32
        _close(yt, yj)
        for got, want in zip(ct, cj):
            _close(got, want)


@pytest.mark.parametrize("t", [2, 3])
def test_ssm_multi_token_recurrent_step_matches_one_token_steps(t):
    """A recurrent step of ``t`` tokens (the port's; the reference's
    update takes one) equals the reference's ``t`` one-token updates from
    the same prefill cache: the outputs and every cache leaf. It also
    equals the port's own ``t`` one-token steps, up to float32 rounding
    of the projections over ``t`` rows at once."""
    jcfg, tcfg = _cfgs("mamba2_2_7b", ssm_chunk=4)
    jp, tp = _params(jcfg, jssm.ssm_init)
    rng = np.random.default_rng(20 + t)
    u = _rand(rng, (2, 8 + t, jcfg.d_model))
    _, cj = jssm.ssm_forward(jp, jcfg, jnp.asarray(u[:, :8]),
                             return_cache=True)
    _, c0 = tssm.ssm_forward(tp, tcfg, torch.as_tensor(u[:, :8]),
                             return_cache=True)
    yj, ys, c1 = [], [], c0
    for s in range(8, 8 + t):
        y, cj = jssm.ssm_forward(jp, jcfg, jnp.asarray(u[:, s:s + 1]),
                                 cache=cj)
        yj.append(np.asarray(y))
        y, c1 = tssm.ssm_forward(tp, tcfg, torch.as_tensor(u[:, s:s + 1]),
                                 cache=c1)
        ys.append(y)
    yt, ct = tssm.ssm_forward(tp, tcfg, torch.as_tensor(u[:, 8:]), cache=c0)
    assert tuple(yt.shape) == (2, t, tcfg.d_model)
    _close(yt, np.concatenate(yj, 1))
    _close(yt, torch.cat(ys, 1), atol=1e-6, rtol=1e-5)
    for got, want, own in zip(ct, cj, c1, strict=True):
        assert tuple(got.shape) == want.shape and got.dtype == own.dtype
        _close(got, want)
        _close(got, own, atol=1e-6, rtol=1e-5)


def test_ssm_cache_init_and_init_tree():
    jcfg, tcfg = _cfgs("hymba_1_5b")
    want = jssm.ssm_cache_init(jcfg, 3, jnp.bfloat16)
    got = tssm.ssm_cache_init(tcfg, 3, torch.bfloat16, "cpu")
    for g, w in zip(got, want, strict=True):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not g.any()
    shapes = jax.eval_shape(lambda k: jssm.ssm_init(k, jcfg, jnp.bfloat16),
                            jax.random.PRNGKey(0))
    tp = tssm.ssm_init((4,), tcfg, torch.bfloat16, "cpu")
    assert sorted(tp) == sorted(shapes)
    for name, sds in shapes.items():
        assert tuple(tp[name].shape) == sds.shape, name
        assert str(tp[name].dtype).split(".")[-1] == str(sds.dtype), name
    assert torch.equal(tp["conv_B"], tp["conv_C"])      # one key, as jax
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert bool(((dt > 0.00099) & (dt < 0.101)).all())


def test_softplus_matches_jax():
    """torch's softplus returns x above its threshold of 20, where jax's
    adds log1p(exp(-x)): below float32 rounding, so the same function."""
    x = np.concatenate([np.linspace(-100, 100, 20001, dtype=np.float32),
                        np.asarray([-1e30, -88.0, 19.99, 20.0, 20.01, 30.0,
                                    1e30], np.float32)])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = torch.nn.functional.softplus(torch.as_tensor(x)).numpy()
    # XLA's CPU code flushes subnormal results (below x = -87.3) to zero;
    # everywhere else the two agree to float32 rounding
    np.testing.assert_allclose(got, want, rtol=2e-7,
                               atol=np.finfo(np.float32).tiny)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m",
                                  "moonshot_v1_16b_a3b"])
@pytest.mark.parametrize("dispatch,capacity", [("einsum", 1.25),
                                               ("sort", 1.25),
                                               ("sort", 0.5)])
def test_moe_dispatch_matches_reference(arch, dispatch, capacity):
    """Each dispatch against the reference's; the sort at the default
    capacity 1.25 and at 0.5, where 32 tokens over 4 experts overflow
    experts' slots (the pairs past an expert's capacity are dropped in
    both)."""
    jcfg, tcfg = _cfgs(arch, moe_dispatch=dispatch,
                       capacity_factor=capacity)
    jp, tp = _params(jcfg, jlayers.moe_init)
    assert tp["router"].dtype == torch.float32
    x = _rand(np.random.default_rng(5), (2, 16, jcfg.d_model))
    want = jlayers.moe_forward(jp, jcfg, jnp.asarray(x))
    got = tlayers.moe_forward(tp, tcfg, torch.as_tensor(x))
    _close(got, want)
    if capacity < 1:
        logits = x.reshape(-1, jcfg.d_model) @ np.asarray(jp["router"])
        idx = np.argsort(-logits, axis=1)[:, :jcfg.top_k]
        load = np.bincount(idx.reshape(-1), minlength=jcfg.n_experts)
        cap = int(np.ceil(32 * jcfg.top_k / jcfg.n_experts * capacity))
        assert load.max() > cap                       # some pairs dropped


def test_moe_sort_dispatch_matches_einsum():
    """Both dispatches compute the same routing at ample capacity (8.0),
    in the config's bfloat16, within the reference's atol 0.06."""
    cfg_e = dataclasses.replace(tconfigs.smoke("granite_moe_3b_a800m"),
                                capacity_factor=8.0)
    cfg_s = dataclasses.replace(cfg_e, moe_dispatch="sort")
    params = tlm.init_params(0, cfg_e, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg_e.vocab_size, (2, 16)))
    le = tlm.forward(params, cfg_e, {"tokens": toks})
    ls = tlm.forward(params, cfg_s, {"tokens": toks})
    _close(ls, le, atol=0.06, rtol=0)


# ---------------------------------------------------------------------------
# MLA absorbed decode
# ---------------------------------------------------------------------------

def test_mla_absorbed_decode_matches_reference():
    """One token against a 1,024-position compressed cache with 700 valid
    rows: the port's absorbed decode (float32 einsums, one masked softmax
    over all positions) against the reference's, and the cache rows it
    writes."""
    jcfg, tcfg = _cfgs("minicpm3_4b")
    jp, tp = _params(jcfg, jlayers.mla_init)
    rng = np.random.default_rng(8)
    s_max, filled = 1024, 700
    ckv = np.zeros((2, s_max, jcfg.kv_lora_rank), np.float32)
    kpe = np.zeros((2, s_max, jcfg.qk_rope_head_dim), np.float32)
    ckv[:, :filled] = _rand(rng, (2, filled, jcfg.kv_lora_rank))
    kpe[:, :filled] = _rand(rng, (2, filled, jcfg.qk_rope_head_dim))
    x = _rand(rng, (2, 1, jcfg.d_model))
    pos = np.full((1, 1), filled, np.int32)
    jfreq = jlayers.rope_freqs(jcfg.qk_rope_head_dim, 1.0, jcfg.rope_theta)
    tfreq = tlayers.rope_freqs(tcfg.qk_rope_head_dim, 1.0, tcfg.rope_theta,
                               "cpu")
    want, (cj, kj) = jlayers.mla_forward(
        jp, jcfg, jnp.asarray(x), positions=jnp.asarray(pos),
        inv_freq_rope=jfreq, kv_cache=(jnp.asarray(ckv), jnp.asarray(kpe)),
        cache_len=jnp.int32(filled))
    ct, kt = torch.as_tensor(ckv), torch.as_tensor(kpe)
    got = tlayers.mla_forward(tp, tcfg, torch.as_tensor(x),
                              positions=torch.as_tensor(pos),
                              inv_freq_rope=tfreq, kv_cache=(ct, kt),
                              cache_len=filled)
    _close(got, want)
    _close(ct, cj)
    _close(kt, kj)
    with pytest.raises(ValueError, match="cache holds 1024"):
        tlayers.mla_forward(tp, tcfg, torch.as_tensor(x),
                            positions=torch.as_tensor(pos),
                            inv_freq_rope=tfreq, kv_cache=(ct, kt),
                            cache_len=s_max)
