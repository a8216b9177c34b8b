"""The dry-run on the production meshes, on the CPU.

One subprocess (the ``"fake"`` process group is process-wide, so the test
process never starts one) prices, with ``launch.dryrun`` and the walker:

* a Qwen smoke prefill (32 sequences of 32 tokens) at ``single_pod_256``
  and ``multi_pod_512``: rank 0's matmul flops and all-reduce bytes equal
  a hand count from the shapes and placements (below), and every
  collective crosses hosts (InfiniBand: a 16-rank model group spans two
  8-card hosts);
* a (1, 1) mesh of ``DTensor``s: train, prefill and decode steps give the
  unsharded walk's flops, flops by class and HBM bytes exactly, with no
  collective;
* a Granite smoke prefill at ``single_pod_256``: its 4 experts do not
  divide 16 model ranks, so the expert FFN width splits (2 columns a
  rank) and attention runs whole; rank 0's matmul flops and all-reduce
  bytes equal a hand count (below), one all-reduce a layer;
* both MoE families' smoke train, prefill and decode cells, with the
  einsum and the sort dispatch, at ``single_pod_256`` and
  ``multi_pod_512``: status ok, no unpriced op, all-reduces only;
* every family's smoke train, prefill and decode cells at
  ``single_pod_256``, with the published configuration's divisibility by
  16 (heads, KV heads, experts, SSM heads, vocabulary): status ok and no
  unpriced op;
* the three families trained across the four cards of one host
  (``chip_smoke.py --grids-train``) at ``cards_1x4`` and ``cards_2x2``
  with 1 and 2 microbatches: status ok, no unpriced op, the accumulation
  asked for, and a rank's arguments larger at (2, 2), where only the
  model axis splits the parameters;
* ``hlo_analysis.analyze(fn, n_chips=)`` and ``collective_bytes(cost)``,
  the counterparts of the reference's, on a walk in this process.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import torch

from repro_torch import configs
from repro_torch.launch import hlo_analysis, hlo_cost

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r'''
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
import torch

from repro_torch import configs
from repro_torch.launch import hlo_analysis, hlo_cost
from repro_torch.launch import dryrun, hlo_cost, specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import ShapeConfig
from repro_torch.train import AdamWConfig, make_serve_steps, make_train_step

out = {"prefill": {}, "one_by_one": {}, "families": {}, "moe": {}}
prefill = ShapeConfig("prefill_s", 32, 32, "prefill")
KEYS = ("status", "n_chips", "flops_by_class", "collective_kinds",
        "collective_detail", "collectives", "unpriced", "t_collective",
        "memory", "collective_groups")
for grid in ("single_pod_256", "multi_pod_512"):
    r = dryrun.price_cell("qwen1_5_4b", prefill, smoke=True, grid=grid)
    out["prefill"][grid] = {k: r[k] for k in KEYS}
r = dryrun.price_cell("granite_moe_3b_a800m", prefill, smoke=True,
                      grid="single_pod_256")
out["granite_prefill"] = {k: r[k] for k in KEYS}
for arch in ("granite_moe_3b_a800m", "moonshot_v1_16b_a3b"):
    for dispatch in ("einsum", "sort"):
        for grid in ("single_pod_256", "multi_pod_512"):
            for shape in (ShapeConfig("train_s", 32, 32, "train"), prefill,
                          ShapeConfig("decode_s", 32, 32, "decode")):
                r = dryrun.price_cell(arch, shape, smoke=True, grid=grid,
                                      moe_dispatch=dispatch)
                out["moe"][f"{arch}/{dispatch}/{grid}/{shape.kind}"] = {
                    k: r[k] for k in ("status", "unpriced",
                                      "collective_kinds")}

cfg = configs.smoke("qwen1_5_4b")
for kind, shape in (("train", ShapeConfig("t", 32, 8, "train")),
                    ("prefill", ShapeConfig("p", 32, 8, "prefill")),
                    ("decode", ShapeConfig("d", 32, 8, "decode"))):
    costs = []
    for mesh_world in (None, 1):
        mesh = None
        if mesh_world:
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=1)
            mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        args = specs.input_specs(cfg, shape, mesh=mesh)
        fn = (make_train_step(cfg, AdamWConfig()) if kind == "train"
              else make_serve_steps(cfg)[kind == "decode"])
        with hlo_cost.CostMode(device="meta") as mode:
            fn(*args)
        c = mode.cost
        costs.append({"flops": c.flops, "by_class": c.flops_by_class,
                      "hbm": c.hbm_bytes, "coll": c.collective_bytes,
                      "count": c.collective_count,
                      "unpriced": c.unpriced})
        if mesh_world:
            dist.destroy_process_group()
    out["one_by_one"][kind] = costs

M = 16


def published(arch):
    """The smoke configuration's fields set so that what divides a model
    axis of 16 is what divides it in the published configuration: the
    heads and KV heads (8 dims a head), the experts, the SSM heads, the
    vocabulary."""
    full, smoke = configs.full(arch), configs.smoke(arch)
    over = {"n_heads": full.n_heads, "n_kv_heads": full.n_kv_heads}
    if smoke.attn_type == "gqa":
        over["head_dim"] = 8
    if full.n_experts % M == 0 and full.n_experts:
        over["n_experts"] = M
    if (full.family == "ssm" or full.hybrid_ssm) and full.ssm_n_heads % M \
            == 0:
        over["ssm_head_dim"] = smoke.d_inner // M
    if full.vocab_size % M:
        over["vocab_size"] = 255
    return over


for arch in configs.ARCH_IDS:
    for shape in (ShapeConfig("train_s", 32, 32, "train"), prefill,
                  ShapeConfig("decode_s", 32, 32, "decode")):
        try:
            r = dryrun.price_cell(arch, shape, smoke=True,
                                  grid="single_pod_256", **published(arch))
        except Exception as e:  # noqa: BLE001 — a cell that errors
            r = {"status": f"error: {type(e).__name__}: {e}"[:300],
                 "unpriced": {}}
        out["families"][f"{arch}/{shape.kind}"] = {
            "status": r["status"], "unpriced": r.get("unpriced", {})}
out["cards"] = {}
for arch in ("chatglm3_6b", "internvl2_76b", "moonshot_v1_16b_a3b"):
    for grid in ("cards_1x4", "cards_2x2"):
        for ga in (1, 2):
            r = dryrun.price_cell(arch, ShapeConfig("t1", 32, 4, "train"),
                                  smoke=True, grid=grid, grad_accum=ga)
            out["cards"][f"{arch}/{grid}/{ga}"] = {
                k: r[k] for k in ("status", "n_chips", "grad_accum",
                                  "accum_scaled", "unpriced", "memory")}
print("RESULT " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def priced():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(l for l in proc.stdout.splitlines()
                if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


#: Qwen smoke: 2 layers, d 64, 4 heads of 16 (4 KV heads), d_ff 128,
#: vocabulary 256, bf16. On a 16-way model axis the heads do not divide
#: (attention whole on every model rank, the cache split on its
#: sequence), the FFN width and the vocabulary do.
L, D, HD, H, FF, V, T = 2, 64, 16, 4, 128, 256, 32


def _hand_count(b):
    """(bf16 matmul flops, float32 attention flops, all-reduce bytes) of
    rank 0's prefill over ``b`` local sequences."""
    proj = 4 * 2 * b * T * D * D                 # q, k, v, o whole
    mlp = 3 * 2 * b * T * D * (FF // 16)         # gate, up, down: 1/16
    head = 2 * b * 1 * D * (V // 16)             # last token, 1/16 vocab
    attn = 2 * (2 * b * H * T * T * HD)          # scores and p·v, f32
    # the embedding's partial rows and each layer's partial MLP output,
    # (b, T, D) in bf16, summed over the model axis
    allreduce = (1 + L) * b * T * D * 2
    return L * (proj + mlp) + head, L * attn, allreduce


@pytest.mark.parametrize("grid,b", [("single_pod_256", 2),
                                    ("multi_pod_512", 1)])
def test_prefill_matches_the_hand_count(priced, grid, b):
    r = priced["prefill"][grid]
    assert r["status"] == "ok" and not r["unpriced"]
    assert r["n_chips"] == (256 if grid == "single_pod_256" else 512)
    bf16, f32, allreduce = _hand_count(b)
    assert r["flops_by_class"]["dot_bf16"] == bf16
    assert r["flops_by_class"]["dot_f32"] == f32
    assert r["collective_kinds"] == {"all-reduce": allreduce}
    assert r["collectives"]["all-reduce"] == allreduce
    assert r["collectives"]["count"] == 1 + L
    assert r["collective_detail"]["ib"] == allreduce
    assert r["collective_detail"]["nvlink"] == 0
    # each all-reduce over the 16 model ranks (two hosts of 8): NCCL's
    # bus bytes, 2·15/16 of its output, at InfiniBand's 50 GB/s
    assert r["collective_groups"] == {"all-reduce|16|ib": allreduce}
    assert r["t_collective"] == pytest.approx(allreduce * 2 * 15 / 16
                                              / 50e9)
    assert r["memory"]["device_gb"] == 80.0 and r["memory"]["fits"]


#: Granite smoke: 2 layers, d 64, 4 heads of 16 (2 KV heads), 4 experts
#: top-2 of expert d_ff 32, vocabulary 256, bf16. On a 16-way model axis
#: the heads and the experts do not divide (attention whole, every expert
#: on d_ff / 16 = 2 columns a rank), the vocabulary does.
G_H, G_KV, G_E, G_K, G_FF = 4, 2, 4, 2, 32


def _granite_hand_count(b):
    """(bf16 matmul flops, float32 flops, all-reduce bytes) of rank 0's
    Granite prefill over ``b`` local sequences (n = b·T tokens)."""
    n = b * T
    proj = 2 * n * D * (G_H + 2 * G_KV) * HD + 2 * n * G_H * HD * D
    experts = 3 * 2 * G_E * n * D * (G_FF // 16)   # gate, up, down: 1/16
    combine = 2 * n * G_E * D                      # "end,ne->nd", whole
    head = 2 * b * 1 * D * (V // 16)               # last token, 1/16 vocab
    attn = 2 * (2 * b * G_H * T * T * HD)          # scores and p·v, f32
    router = 2 * n * D * G_E                       # float32 logits, whole
    # the embedding's partial rows and each MoE layer's partial output,
    # (b, T, D) in bf16, summed over the model axis: one a layer
    allreduce = (1 + L) * b * T * D * 2
    return (L * (proj + experts + combine) + head, L * (attn + router),
            allreduce)


def test_granite_prefill_matches_the_hand_count(priced):
    """The dispatch einsum ("ne,nd->end", no contracted index) is priced
    as elementwise products, not a matmul; the combine, the router and
    the attention run whole on every model rank."""
    r = priced["granite_prefill"]
    assert r["status"] == "ok" and not r["unpriced"]
    bf16, f32, allreduce = _granite_hand_count(2)
    assert r["flops_by_class"]["dot_bf16"] == bf16
    assert r["flops_by_class"]["dot_f32"] == f32
    assert r["collective_kinds"] == {"all-reduce": allreduce}
    assert r["collectives"]["count"] == 1 + L
    assert r["collective_detail"]["ib"] == allreduce


MOE_CELLS = [f"{a}/{d}/{g}/{k}"
             for a in ("granite_moe_3b_a800m", "moonshot_v1_16b_a3b")
             for d in ("einsum", "sort")
             for g in ("single_pod_256", "multi_pod_512")
             for k in ("train", "prefill", "decode")]


@pytest.mark.parametrize("cell", MOE_CELLS)
def test_moe_cells_price_on_the_production_meshes(priced, cell):
    """No all-to-all and no gather of expert weights: the MoE layer's
    collectives are all-reduces (its partial output; with the sort
    dispatch also the (B, E) pair counts over the data axes)."""
    r = priced["moe"][cell]
    assert r["status"] == "ok" and not r["unpriced"], r
    assert set(r["collective_kinds"]) == {"all-reduce"}, r


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_by_one_mesh_prices_the_unsharded_step(priced, kind):
    plain, mesh = priced["one_by_one"][kind]
    assert mesh["flops"] == plain["flops"]
    assert mesh["by_class"] == plain["by_class"]
    assert mesh["hbm"] == plain["hbm"]
    assert mesh["coll"] == 0 and mesh["count"] == 0
    assert not mesh["unpriced"] and not plain["unpriced"]


#: every family's train, prefill and decode cell; a train cell keeps the
#: bare arch as its id
FAMILY_CELLS = [pytest.param(arch, kind,
                             id=arch if kind == "train" else f"{arch}-{kind}")
                for kind in ("train", "prefill", "decode")
                for arch in configs.ARCH_IDS]


@pytest.mark.parametrize("arch,kind", FAMILY_CELLS)
def test_every_family_prices_on_the_mesh_or_is_queued(priced, arch, kind):
    """Every family's smoke cell at ``single_pod_256``, its heads, KV
    heads, experts, SSM heads and vocabulary dividing a model axis of 16
    as the published configuration's do (ChatGLM3's 32 query heads split
    and its 2 KV heads do not; MiniCPM3's 40 MLA heads stay whole): status
    ok and no unpriced op. No family is excused."""
    r = priced["families"][f"{arch}/{kind}"]
    assert r["status"] == "ok" and not r["unpriced"], (arch, kind, r)


def test_analyze_and_collective_bytes_read_a_walk():
    a = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")
    b = torch.empty((32, 16), dtype=torch.bfloat16, device="meta")
    roof = hlo_analysis.analyze(torch.mm, a, b)
    assert roof.n_chips == 1 and roof.flops == 2 * 64 * 32 * 16
    assert roof.flops_by_class == {"dot_bf16": 2 * 64 * 32 * 16}
    assert hlo_analysis.analyze(torch.mm, a, b, n_chips=256).n_chips == 256
    cost = hlo_cost.analyze(torch.mm, a, b)
    assert hlo_analysis.collective_bytes(cost) == dict(
        {k: 0.0 for k in hlo_analysis.COLLECTIVES}, count=0, total=0.0)


@pytest.mark.parametrize("arch", ["chatglm3_6b", "internvl2_76b",
                                  "moonshot_v1_16b_a3b"])
def test_four_card_grids_price_training(priced, arch):
    cells = priced["cards"]
    for grid in ("cards_1x4", "cards_2x2"):
        for ga in (1, 2):
            r = cells[f"{arch}/{grid}/{ga}"]
            assert r["status"] == "ok" and not r["unpriced"], r
            assert r["n_chips"] == 4 and r["grad_accum"] == ga
            assert r["accum_scaled"] == (ga > 1)
    for ga in (1, 2):
        row = cells[f"{arch}/cards_1x4/{ga}"]["memory"]["argument_gb"]
        both = cells[f"{arch}/cards_2x2/{ga}"]["memory"]["argument_gb"]
        assert both > row
