"""Private LM generation in the port against the reference.

* ``private_lookup_inline`` opens to the reference's values bit for bit,
  with a pre-shared table (the reference's shares carried across with
  ``params_from_arrays``) and with the table shared on the fly;
* calls without a key never reuse one, and an explicit key is threaded
  into both the set-up and the lookup;
* the port's ``BatchServer`` generates the reference ``BatchServer``'s
  tokens at smoke size in float32, private and plaintext, for the dense
  (qwen1.5-4b), MLA (minicpm3-4b), MoE (granite, moonshot), SSM
  (mamba2-2.7b) and hybrid (hymba-1.5b) families; the encoder-decoder
  (seamless-m4t-medium) and ViT-prefixed (internvl2-76b) families,
  whose batches carry a frontend input that no ``BatchServer`` passes,
  generate the reference's tokens through a greedy loop over ``prefill``
  and ``decode_step``, and their ``BatchServer``s behave as the
  reference's (internvl serves text only, seamless raises for its
  frames);
* private generations equal plaintext ones whose table is the dequantized
  quantized table, and the private model's logits equal that plaintext
  model's bit for bit (the lookup opens exactly those rows), for qwen,
  mamba2 and minicpm3.

Every comparison here is exact (tolerance 0): opened values are exact, and
the generated tokens are compared as integers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.models import private_embed as jpe
from repro_torch.api import get_backend
from repro_torch.core.queries import embed as teq
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models import private_embed as tpe
from repro_torch.models.config import ModelConfig

V, D = 64, 16
TABLE = np.random.default_rng(5).uniform(-2.0, 2.0, (V, D)).astype(np.float32)


def _cfg(dtype="float32"):
    return ModelConfig(name="t", family="dense", n_layers=1, d_model=D,
                       n_heads=2, n_kv_heads=2, d_ff=32, vocab_size=V,
                       dtype=dtype, private_embed=True)


def _jcfg(dtype="float32"):
    from repro.models.config import ModelConfig as JModelConfig
    return JModelConfig(**dataclasses.asdict(_cfg(dtype)))


def _bits(x):
    """float32 bits of a lookup of either package (bf16 widens exactly)."""
    x = x.float().numpy() if isinstance(x, torch.Tensor) else x
    return np.asarray(x, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# private_lookup_inline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pre_shared", [False, True])
def test_inline_lookup_opens_to_reference_bits(pre_shared, dtype):
    toks = np.asarray([[3, 5, 63], [0, 3, 17]], np.int32)
    jparams = {"embed": jnp.asarray(TABLE)}
    if pre_shared:
        jparams["embed_shares"] = jpe.setup_private_embed(
            jax.random.PRNGKey(2), jparams["embed"], n_shares=4).values
    tparams = tlm.params_from_arrays(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    want = jpe.private_lookup_inline(jparams, _jcfg(dtype), jnp.asarray(toks))
    got = tpe.private_lookup_inline(tparams, _cfg(dtype), toks)
    assert got.shape == (2, 3, D)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert np.array_equal(_bits(got), _bits(want))
    quant = tpe.dequantize_from_field(tpe.quantize_to_field(
        TABLE, device="cpu"))
    assert torch.equal(got.float(), quant[toks].to(got.dtype).float())


def test_inline_lookup_keys_never_repeat():
    params = {"embed": torch.as_tensor(TABLE)}
    k1 = tpe._next_inline_key(params)
    k2 = tpe._next_inline_key(params)
    assert k1 != k2 and k1[:-1] == k2[:-1] == (0,)
    be = get_backend("cuda")
    sh1 = teq.share_tokens(k1, [3], vocab=V, n_shares=4, be=be,
                           device="cpu")
    sh2 = teq.share_tokens(k2, [3], vocab=V, n_shares=4, be=be,
                           device="cpu")
    assert not torch.equal(sh1.values, sh2.values)      # fresh polynomials
    out1 = tpe.private_lookup_inline(params, _cfg(), [[3]])
    out2 = tpe.private_lookup_inline(params, _cfg(), [[3]])
    assert torch.equal(out1, out2)                     # key-independent
    # a params-level base key roots the stream
    k3 = tpe._next_inline_key({"embed_key": (9, 1)})
    assert k3[:2] == (9, 1) and k3[2] > k2[-1]


def test_inline_lookup_threads_explicit_key(monkeypatch):
    seen = {}
    real_setup, real_batched = tpe.setup_private_embed, \
        tpe.private_lookup_batched

    def setup(key, *a, **kw):
        seen["setup"] = key
        return real_setup(key, *a, **kw)

    def batched(key, *a, **kw):
        seen["lookup"] = key
        return real_batched(key, *a, **kw)

    monkeypatch.setattr(tpe, "setup_private_embed", setup)
    monkeypatch.setattr(tpe, "private_lookup_batched", batched)
    params = {"embed": torch.as_tensor(TABLE)}
    before = tpe._next_inline_key(params)
    out = tpe.private_lookup_inline(params, _cfg(), [[3, 5]], key=42)
    assert seen == {"setup": (42, 0), "lookup": (42, 1)}
    assert tpe._next_inline_key(params)[-1] == before[-1] + 1  # not drawn
    quant = tpe.dequantize_from_field(tpe.quantize_to_field(
        TABLE, device="cpu"))
    assert torch.equal(out, quant[torch.tensor([[3, 5]])])
    got = tpe.private_lookup_inline({"embed_shares": real_setup(
        7, TABLE, device="cpu").values}, _cfg(), [[5]], key=(1, 2))
    assert seen["lookup"] == (1, 2, 1)
    assert torch.equal(got, quant[torch.tensor([[5]])])


# ---------------------------------------------------------------------------
# BatchServer: the port against the reference, private against plaintext
# ---------------------------------------------------------------------------

FAMILIES = ["minicpm3_4b", "granite_moe_3b_a800m", "moonshot_v1_16b_a3b",
            "mamba2_2_7b", "hymba_1_5b", "seamless_m4t_medium",
            "internvl2_76b"]


def _smoke_pair(arch):
    """(reference cfg, port cfg, reference params, port params) of
    ``arch``'s smoke config in float32, with a pre-shared table."""
    jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.smoke(arch), dtype="float32")
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    jp["embed_shares"] = jpe.setup_private_embed(
        jax.random.PRNGKey(1), jp["embed"], n_shares=4).values
    tp = tlm.params_from_arrays(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def qwen():
    return _smoke_pair("qwen1_5_4b")


def _requests(mod, cfg, n=3, t=12, new=6, seed=1):
    rng = np.random.default_rng(seed)
    return [mod.Request(prompt=rng.integers(0, cfg.vocab_size, size=t,
                                            dtype=np.int32), max_new=new)
            for _ in range(n)]


def _frontend(cfg, b, seed=4):
    """Frontend inputs (numpy float32): 6 audio frames a request for an
    encoder-decoder, ``n_prefix`` patches for a ViT prefix."""
    rng = np.random.default_rng(seed)
    if cfg.n_enc_layers:
        return {"frames": rng.standard_normal(
            (b, 6, cfg.frontend_dim)).astype(np.float32)}
    if cfg.frontend == "vit":
        return {"patches": rng.standard_normal(
            (b, cfg.n_prefix, cfg.frontend_dim)).astype(np.float32)}
    return {}


def _greedy(mod, params, cfg, prompts, extra, new):
    """``new`` greedy tokens through ``mod``'s (the reference's ``lm`` or
    the port's) ``prefill`` and ``decode_step``, with the frontend inputs
    ``extra`` in the prefill's batch -> int array (B, new)."""
    as_array = jnp.asarray if mod is jlm else torch.as_tensor
    pre = cfg.n_prefix if "patches" in extra else 0
    t = prompts.shape[1]
    batch = {"tokens": as_array(prompts),
             **{k: as_array(v) for k, v in extra.items()}}
    logits, cache = mod.prefill(params, cfg, batch, max_len=pre + t + new)
    out = []
    for i in range(new):
        tok = np.asarray(logits[:, -1]).argmax(-1)[:, None]
        out.append(tok)
        if i + 1 < new:
            logits, cache = mod.decode_step(params, cfg, cache, pre + t + i,
                                            {"tokens": as_array(tok)})
    return np.concatenate(out, 1)


def _dequantized(params):
    out = dict(params)
    out["embed"] = tpe.dequantize_from_field(tpe.quantize_to_field(
        params["embed"], device="cpu")).to(params["embed"].dtype)
    return out


@pytest.mark.parametrize("private", [False, True])
def test_batch_server_matches_reference(qwen, private):
    jcfg, tcfg, jp, tp = qwen
    jcfg = dataclasses.replace(jcfg, private_embed=private)
    tcfg = dataclasses.replace(tcfg, private_embed=private)
    want = jserve.BatchServer(jp, jcfg, max_len=32).serve(
        _requests(jserve, jcfg))
    got = tserve.BatchServer(tp, tcfg, max_len=32, device="cpu").serve(
        _requests(tserve, tcfg))
    for a, b in zip(want, got):
        assert b.out.dtype == np.int32 and b.out.shape == (6,)
        assert np.array_equal(a.out, b.out)
        assert b.latency_s > 0


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("private", [False, True])
def test_batch_server_matches_reference_families(arch, private):
    jcfg, tcfg, jp, tp = _smoke_pair(arch)
    jcfg = dataclasses.replace(jcfg, private_embed=private)
    tcfg = dataclasses.replace(tcfg, private_embed=private)
    if jcfg.frontend:                  # a BatchServer passes tokens only
        prompts = np.stack([r.prompt for r in _requests(
            tserve, tcfg, n=2, t=10, new=5)])
        extra = _frontend(jcfg, 2)
        want = _greedy(jlm, jp, jcfg, prompts, extra, 5)
        got = _greedy(tlm, tp, tcfg, prompts, extra, 5)
        assert got.shape == (2, 5)
        assert np.array_equal(want, got)
        return
    want = jserve.BatchServer(jp, jcfg, max_len=24).serve(
        _requests(jserve, jcfg, n=2, t=10, new=5))
    got = tserve.BatchServer(tp, tcfg, max_len=24, device="cpu").serve(
        _requests(tserve, tcfg, n=2, t=10, new=5))
    for a, b in zip(want, got, strict=True):
        assert b.out.shape == (5,)
        assert np.array_equal(a.out, b.out)


def test_batch_server_frontend_families_as_reference():
    """``BatchServer`` passes tokens only, in both packages: internvl
    serves text without its prefix (the same tokens), seamless raises
    ``KeyError`` for the frames it lacks."""
    jcfg, tcfg, jp, tp = _smoke_pair("internvl2_76b")
    want = jserve.BatchServer(jp, jcfg, max_len=24).serve(
        _requests(jserve, jcfg, n=2, t=10, new=5))
    got = tserve.BatchServer(tp, tcfg, max_len=24, device="cpu").serve(
        _requests(tserve, tcfg, n=2, t=10, new=5))
    for a, b in zip(want, got, strict=True):
        assert np.array_equal(a.out, b.out)
    jcfg, tcfg, jp, tp = _smoke_pair("seamless_m4t_medium")
    with pytest.raises(KeyError, match="frames"):
        jserve.BatchServer(jp, jcfg, max_len=24).serve(
            _requests(jserve, jcfg, n=2, t=10, new=5))
    with pytest.raises(KeyError, match="frames"):
        tserve.BatchServer(tp, tcfg, max_len=24, device="cpu").serve(
            _requests(tserve, tcfg, n=2, t=10, new=5))


@pytest.mark.parametrize("arch", ["qwen1_5_4b", "mamba2_2_7b",
                                  "minicpm3_4b"])
def test_private_generation_equals_dequantized_plaintext(arch):
    _, tcfg, _, tp = _smoke_pair(arch)
    priv = dataclasses.replace(tcfg, private_embed=True)
    plain_params = _dequantized(tp)
    reqs = _requests(tserve, tcfg, n=4, t=10, new=8, seed=7)
    reqs[1].max_new = 3                                 # ragged max_new
    got = tserve.BatchServer(tp, priv, max_len=24, device="cpu").serve(
        [tserve.Request(r.prompt.copy(), r.max_new) for r in reqs])
    want = tserve.BatchServer(plain_params, tcfg, max_len=24,
                              device="cpu").serve(reqs)
    for a, b in zip(want, got):
        assert np.array_equal(a.out, b.out)
    assert got[1].out.shape == (3,)
    toks = torch.as_tensor(np.stack([r.prompt for r in reqs]))
    lp = tlm.forward(tp, priv, {"tokens": toks})
    lq = tlm.forward(plain_params, tcfg, {"tokens": toks})
    assert torch.equal(lp, lq)


def test_batch_server_checks_capacity_and_device(qwen):
    _, tcfg, _, tp = qwen
    srv = tserve.BatchServer(tp, tcfg, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="cache positions"):
        srv.serve(_requests(tserve, tcfg, t=12, new=6))
    assert srv.serve(_requests(tserve, tcfg, n=1, t=12, new=5))[0].out.shape \
        == (5,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.BatchServer(tp, tcfg)
    meta = {"final_norm": torch.zeros(2, device="meta")}
    with pytest.raises(ValueError, match="params live on meta"):
        tserve.BatchServer(meta, tcfg, device="cpu")


def test_decode_step_embeds_seam_carries_private_lookups(qwen):
    """The private_generate flow: an ``EmbedLookup`` per step through a
    client over the shared table, fed to ``decode_step(embeds=)``, gives
    the private model's logits exactly."""
    from repro_torch.api import EmbedLookup, MeshDispatcher, QueryClient
    _, tcfg, _, tp = qwen
    priv = dataclasses.replace(tcfg, private_embed=True)
    client = QueryClient(seed=7, device="cpu")
    client.attach(tpe.as_embed_relation(tpe.Shares(tp["embed_shares"], 1)),
                  name="emb", shards=2,
                  dispatcher=MeshDispatcher(["cpu"]))

    def lookup(toks):
        res = client.run(EmbedLookup(tokens=tuple(int(t) for t in
                                                  toks.reshape(-1))),
                         relation="emb")
        return torch.as_tensor(res.embeddings).reshape(*toks.shape, -1)

    prompt = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 5))
    la, ca = tlm.prefill(tp, tcfg, {"tokens": prompt,
                                    "embeds": lookup(prompt)}, max_len=8)
    lb, cb = tlm.prefill(tp, priv, {"tokens": prompt}, max_len=8)
    assert torch.equal(la, lb)
    tok = torch.argmax(la[:, -1], dim=-1, keepdim=True)
    la, _ = tlm.decode_step(tp, tcfg, ca, 5, {"tokens": tok,
                                              "embeds": lookup(tok.numpy())})
    lb, _ = tlm.decode_step(tp, priv, cb, 5, {"tokens": tok})
    assert torch.equal(la, lb)
