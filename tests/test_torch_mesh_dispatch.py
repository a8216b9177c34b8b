"""The port's MeshDispatcher, held against its serial dispatcher and the
reference's serial QueryClient.

* **Transcript identity** — rows, counts, addresses, values and
  ``CostLedger``s through ``MeshDispatcher(["cpu"])`` and
  ``MeshDispatcher(["cpu", "cpu"])`` equal the serial dispatcher's, bit for
  bit, at S = 1, 2 and 4, for counts, every select strategy, range
  count/select, a PK/FK join, an equijoin, aggregates and an
  ``EmbedLookup`` (tolerance 0: every opened value is exact).
* **Against the reference** — the same plans over relations and a table
  shared by the JAX package and carried over with ``from_arrays`` /
  ``table_from_arrays``: the mesh at S = 1, 2 and 4 opens what the
  reference's serial ``QueryClient`` opens and charges its ledgers.
* **Device residency** — the first batch charges the one-time placement of
  the share blocks, every later batch zero bytes.
* **Seams** — ``QueryClient.attach(dispatcher=)`` and a ``QueryServer``
  tenant take it with no other change; ``predicted_cost`` has the
  reference's keys.

The reference's own mesh path fails under the installed jax (ROADMAP.md,
Queue 3), so its serial client is the oracle here, as the reference's
tests also hold its mesh to its serial path.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.core import Codec as JCodec  # noqa: E402
from repro.core import outsource as joutsource  # noqa: E402
from repro.models import private_embed as jpe  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import (Aggregate, Between, Count,  # noqa: E402
                             EmbedLookup, Eq, MeshDispatcher, QueryClient,
                             Select)
from repro_torch.core import (Codec, ShardedRelation, from_arrays,  # noqa: E402,E501
                              outsource)
from repro_torch.core.dataplane import SERIAL  # noqa: E402
from repro_torch.launch.serve import QueryServer  # noqa: E402
from repro_torch.models import private_embed as pe  # noqa: E402

CODEC = Codec(word_length=6)
DEVICES = [["cpu"], ["cpu", "cpu"]]
TABLE = np.random.default_rng(5).uniform(-2.0, 2.0, (64, 16)).astype(
    np.float32)


@pytest.fixture(scope="module")
def range_db():
    rows = [[f"id{i}", f"nm{i % 5}", str(500 + 137 * i)] for i in range(32)]
    return rows, outsource(rows, n_shares=20, column_names=["Id", "Name",
                                                            "Val"],
                           codec=CODEC, degree=1, numeric_columns={2: 14},
                           seed=19, device="cpu")


@pytest.fixture(scope="module")
def child_db(range_db):
    rows, _ = range_db
    child = [[rows[i % len(rows)][0], f"t{i}"] for i in range(6)]
    return outsource(child, n_shares=20, column_names=["Id", "Task"],
                     codec=CODEC, degree=1, seed=23, device="cpu")


@pytest.fixture(scope="module")
def table_sh():
    return pe.setup_private_embed(5, TABLE, n_shares=4, device="cpu")


def _family_plans(child, m=api):
    """Every query family, in the plan classes of module ``m``."""
    return [
        m.Count(m.Eq("Name", "nm1")),
        m.Select(m.Eq("Name", "nm2"), strategy="one_round"),
        m.Select(m.Eq("Name", "nm3"), strategy="tree"),
        m.Select(m.Eq("Id", "id7"), strategy="one_tuple"),
        m.RangeCount(m.Between("Val", 500, 2000), reduce_every=2),
        m.RangeSelect(m.Between("Val", 900, 1800), reduce_every=2),
        m.Join(right=child, on=("Id", "Id"), kind="pkfk"),
        m.Join(right=child, on=("Id", "Id"), kind="equi",
               padding=m.Padding.fake_values(1)),
        m.Aggregate("sum", "Val", where=m.Eq("Name", "nm1"), verify=True),
        m.Aggregate("avg", "Val", where=m.Eq("Name", "nm2")),
        m.Aggregate("min", "Val", where=m.Eq("Name", "nm1"),
                    reduce_every=2),
    ]


def _same(a, b):
    assert a.strategy == b.strategy
    assert a.rows == b.rows
    assert a.addresses == b.addresses
    assert a.count == b.count
    assert a.value == b.value
    assert a.ledger.as_dict() == b.ledger.as_dict()
    if a.embeddings is not None or b.embeddings is not None:
        assert np.array_equal(a.embeddings, b.embeddings)


# ---------------------------------------------------------------------------
# transcript identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("devices", DEVICES, ids=["cpu", "cpu-cpu"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_mesh_parity_with_serial_all_families(range_db, child_db, shards,
                                              devices):
    _, db = range_db
    plans = _family_plans(child_db)
    serial = QueryClient(db, 7, device="cpu")
    serial.attach(shards=shards)
    ref = serial.run_batch(plans)

    client = QueryClient(db, 7, device="cpu")
    mesh = MeshDispatcher(devices, strict_transfers=True)
    plane = client.attach(shards=shards, dispatcher=mesh)
    got = client.run_batch(plans)
    for a, b in zip(ref, got):
        _same(a, b)
    assert plane.stats.dispatches == plane.stats.steps * shards
    assert mesh.shard_devices(plane) == [torch.device("cpu")] * shards


@pytest.mark.parametrize("devices", DEVICES, ids=["cpu", "cpu-cpu"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_mesh_embed_lookup_parity(table_sh, shards, devices):
    """EmbedLookup over a vocab-sharded table: one fused dispatch per
    shard, the partial sums folded on the first device, the opened
    embeddings and the ledger equal to the serial dispatcher's."""
    rel = pe.as_embed_relation(table_sh)
    plans = [EmbedLookup(tokens=(17, 4, 17, 63)),
             EmbedLookup(tokens=(0, 5), verify=True)]
    serial = QueryClient(seed=3, device="cpu")
    serial.attach(rel, name="emb", shards=shards)
    ref = serial.run_batch(plans, relation="emb")

    client = QueryClient(seed=3, device="cpu")
    plane = client.attach(rel, name="emb", shards=shards,
                          dispatcher=MeshDispatcher(devices))
    got = client.run_batch(plans, relation="emb")
    for a, b in zip(ref, got):
        _same(a, b)
    quant = pe.dequantize_from_field(pe.quantize_to_field(
        TABLE, device="cpu")).numpy()
    assert np.array_equal(got[0].embeddings, quant[[17, 4, 17, 63]])
    assert plane.stats.dispatches == shards          # ONE step, S shards


def test_mesh_sum_equals_serial_field_add_chain(range_db):
    """The stacked int64 fold with one final % p is the serial add chain
    for every S, on partials at p − 1 where the chain wraps most."""
    _, db = range_db

    def build(v, sh):
        return torch.full((3, 5), 2**31 - 2, dtype=torch.int32)

    for shards in (2, 3, 4):
        plane = ShardedRelation(db, shards=shards)
        want = SERIAL.run_set(plane, plane.dispatch_set(build, reduce="sum"))
        mesh = MeshDispatcher(["cpu", "cpu"])
        on_mesh = ShardedRelation(db, shards=shards, dispatcher=mesh)
        got = mesh.run_set(on_mesh, on_mesh.dispatch_set(build, reduce="sum"))
        assert torch.equal(want, got)


# ---------------------------------------------------------------------------
# against the reference's serial QueryClient
# ---------------------------------------------------------------------------

def _carry(jdb):
    return from_arrays(np.asarray(jdb.relation.values),
                       degree=jdb.relation.degree,
                       alphabet=jdb.codec.alphabet,
                       word_length=jdb.codec.word_length,
                       column_names=jdb.column_names,
                       numeric={c: np.asarray(s.values)
                                for c, s in jdb.numeric.items()},
                       numeric_bits=jdb.numeric_bits,
                       base_degree=jdb.base_degree, device="cpu")


@pytest.fixture(scope="module")
def ref_pair(range_db):
    """(reference DBs, port DBs): the Employee-like relation and its child,
    shared by the JAX package; the port holds the same shares."""
    rows, _ = range_db
    codec = JCodec(word_length=6)
    jdb = joutsource(jax.random.PRNGKey(19), rows, n_shares=20,
                     column_names=["Id", "Name", "Val"], codec=codec,
                     degree=1, numeric_columns={2: 14})
    child = [[rows[i % len(rows)][0], f"t{i}"] for i in range(6)]
    jchild = joutsource(jax.random.PRNGKey(23), child, n_shares=20,
                        column_names=["Id", "Task"], codec=codec, degree=1)
    return (jdb, jchild), (_carry(jdb), _carry(jchild))


@pytest.fixture(scope="module")
def reference_batch(ref_pair):
    (jdb, jchild), _ = ref_pair
    return japi.QueryClient(jdb, key=7, backend="jnp").run_batch(
        _family_plans(jchild, japi))


def _same_as_reference(jr, tr):
    assert tr.strategy == jr.strategy
    assert tr.rows == jr.rows
    assert tr.addresses == jr.addresses
    assert tr.count == jr.count
    assert tr.value == jr.value
    assert tr.ledger.as_dict() == jr.ledger.as_dict()


@pytest.mark.parametrize("devices", DEVICES, ids=["cpu", "cpu-cpu"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_mesh_matches_reference_serial_client(ref_pair, reference_batch,
                                              shards, devices):
    """Every family through the mesh at S shards opens the reference's
    rows, counts and values and charges its ledgers (tolerance 0)."""
    _, (tdb, tchild) = ref_pair
    client = QueryClient(tdb, 7, device="cpu")
    client.attach(shards=shards,
                  dispatcher=MeshDispatcher(devices, strict_transfers=True))
    got = client.run_batch(_family_plans(tchild))
    assert len(got) == len(reference_batch)
    for jr, tr in zip(reference_batch, got):
        _same_as_reference(jr, tr)


@pytest.fixture(scope="module")
def ref_tables():
    """(reference table Shares, port table Shares), identical shares."""
    jsh = jpe.setup_private_embed(jax.random.PRNGKey(5), TABLE, n_shares=4)
    return jsh, pe.table_from_arrays(np.asarray(jsh.values), jsh.degree,
                                     device="cpu")


EMBED_TOKENS = [(17, 4, 17, 63), (0, 5)]


@pytest.fixture(scope="module")
def reference_lookups(ref_tables):
    jsh, _ = ref_tables
    jc = japi.QueryClient(key=3)
    jc.attach(jpe.as_embed_relation(jsh), name="emb")
    return jc.run_batch([japi.EmbedLookup(tokens=t, verify=i == 1)
                         for i, t in enumerate(EMBED_TOKENS)],
                        relation="emb")


@pytest.mark.parametrize("devices", DEVICES, ids=["cpu", "cpu-cpu"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_mesh_embed_lookup_matches_reference(ref_tables, reference_lookups,
                                             shards, devices):
    """The vocab-sharded lookup through the mesh opens the reference's
    embeddings bit for bit and charges its ledgers."""
    _, tsh = ref_tables
    client = QueryClient(seed=3, device="cpu")
    client.attach(pe.as_embed_relation(tsh), name="emb", shards=shards,
                  dispatcher=MeshDispatcher(devices, strict_transfers=True))
    got = client.run_batch([EmbedLookup(tokens=t, verify=i == 1)
                            for i, t in enumerate(EMBED_TOKENS)],
                           relation="emb")
    for jr, tr in zip(reference_lookups, got):
        assert tr.strategy == jr.strategy == "embed"
        assert np.array_equal(tr.embeddings, np.asarray(jr.embeddings))
        assert tr.ledger.as_dict() == jr.ledger.as_dict()


# ---------------------------------------------------------------------------
# device residency
# ---------------------------------------------------------------------------

def test_mesh_placement_charged_once_then_zero(range_db, child_db):
    _, db = range_db
    client = QueryClient(db, 7, device="cpu")
    mesh = MeshDispatcher(["cpu", "cpu"], strict_transfers=True)
    plane = client.attach(shards=2, dispatcher=mesh)
    placed = db.relation.values.numel() * 4 + sum(
        s.values.numel() * 4 for s in db.numeric.values())
    plans = _family_plans(child_db)[:4]
    client.run_batch(plans)
    assert plane.stats.transfer_bytes == placed
    client.run_batch(plans)
    assert plane.stats.transfer_bytes == placed      # zero after placement
    assert plane.stats.dispatch_s > 0.0
    assert plane.stats.steps > 0
    mesh.bind_plane(plane)                           # idempotent
    client.run_batch(plans[:1])
    assert plane.stats.transfer_bytes == placed


def test_shared_mesh_bills_each_plane_its_own_placement(range_db,
                                                         child_db):
    """One dispatcher behind two relations: each plane's first step pays
    its own blocks' bytes, never the other's."""
    _, db = range_db
    mesh = MeshDispatcher(["cpu", "cpu"])
    client = QueryClient(seed=7, device="cpu")
    emp = client.attach(db, name="emp", shards=2, dispatcher=mesh)
    kid = client.attach(child_db, name="kid", shards=2, dispatcher=mesh)
    client.run_batch([Count(Eq("Task", "t1"))], relation="kid")
    client.run_batch([Count(Eq("Name", "nm1"))], relation="emp")
    for plane, rel in ((emp, db), (kid, child_db)):
        assert plane.stats.transfer_bytes == rel.relation.values.numel() * 4 \
            + sum(s.values.numel() * 4 for s in rel.numeric.values())


def test_default_devices_are_the_visible_gpus():
    """The default grid is every visible card on the data axis, as the
    reference's ``make_dispatch_mesh()``; without a card it raises."""
    if torch.cuda.is_available():
        mesh = MeshDispatcher()
        assert mesh.devices == [torch.device("cuda", i) for i in
                                range(torch.cuda.device_count())]
        assert mesh.grid.shape == {"data": torch.cuda.device_count(),
                                   "model": 1}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MeshDispatcher()


# ---------------------------------------------------------------------------
# predicted cost and the serving seam
# ---------------------------------------------------------------------------

def test_mesh_predicted_cost_report(range_db):
    _, db = range_db
    client = QueryClient(db, 3, device="cpu")
    mesh = MeshDispatcher(["cpu", "cpu"])
    assert mesh.predicted_cost() == dict(flops=0.0, hbm_bytes=0.0,
                                         collective_bytes=0.0, programs=0)
    client.attach(shards=2, dispatcher=mesh)
    client.run_batch([Count(Eq("Name", "nm1")), Aggregate("sum", "Val")])
    cost = mesh.predicted_cost()
    assert set(cost) == {"flops", "hbm_bytes", "collective_bytes",
                         "programs"}
    assert cost["programs"] >= 1
    assert cost["flops"] > 0 and cost["hbm_bytes"] > cost["flops"]
    # the copies are counted by grid slot: shard 1's (c, 1) SUM partial
    # goes from data row 1 to row 0, although both rows are the CPU
    assert cost["collective_bytes"] == 20 * 1 * 4
    # a repeat of the same shapes adds no new reduction
    client.run_batch([Count(Eq("Name", "nm1")), Aggregate("sum", "Val")])
    assert mesh.predicted_cost() == cost


def test_query_server_tenant_gets_mesh_transparently(range_db):
    _, db = range_db
    plans = [Count(Eq("Name", "nm1")), Count(Eq("Name", "nm2")),
             Select(Eq("Name", "nm3"), strategy="one_round")]
    solo = QueryServer(device="cpu")
    solo.attach("emp", db, key=5)
    with solo:
        ref = [solo.submit(p, relation="emp").wait(timeout=60).result
               for p in plans]
    server = QueryServer(device="cpu")
    server.attach("emp", db, key=5, shards=2,
                  dispatcher=MeshDispatcher(["cpu", "cpu"]))
    with server:
        got = [server.submit(p, relation="emp").wait(timeout=60).result
               for p in plans]
    for a, b in zip(ref, got):
        _same(a, b)
    snap = server.stats.snapshot()["relations"]["emp"]
    assert snap["dispatches"] > 0
    assert snap["transfer_bytes"] == db.relation.values.numel() * 4 + sum(
        s.values.numel() * 4 for s in db.numeric.values())
