"""The port's MeshDispatcher on a ("data", "model") grid of devices.

* **Transcript identity** — over grids (1, 1), (2, 1), (1, 2), (2, 2) and
  (4, 1) of ``"cpu"`` slots at 1–4 tuple shards, every query family's
  rows, addresses, counts, values and ``CostLedger``s equal the serial
  dispatcher's and the reference's serial ``QueryClient``'s on the same
  shares (carried over with ``from_arrays``), bit for bit; so do the
  embeddings of an ``EmbedLookup``. c = 20 splits over 2 model slots
  (two groups of 10 clouds); c = 21 keeps its cloud axis whole.
* **Operands follow their block** — on the CPU no two devices differ, so
  a forgotten operand would pass there. A grid whose second model slot is
  ``"meta"`` puts cloud group 1 on meta tensors; each cloud step's meta
  blocks run alone (without the reduce) on a backend that checks that
  every operand of an op lies on one device, and torch's own ops raise
  when a meta tensor meets a CPU one. Every dispatch closure of the query
  suite runs there, and its outputs keep the group's clouds on axis 0.
* **Non-communication** — the counterpart of
  ``tests/test_noncommunication.py``, which finds no collective in the
  reference's compiled cloud program. Here every cloud step runs twice,
  the second time with every cloud outside group 0 changed in place:
  group 0's clouds of the step's result must come out bit-identical, and
  the other clouds must change, so a block that read another group's
  shares fails. With 2 and 4 cloud groups the steps of a count and a
  fetch hold, and so do every family's on 2 groups; the dispatcher's
  record of copies shows the user-side assembly as the only place the
  groups meet.
* **Grids** — ``make_dispatch_mesh`` shapes and its ``ValueError``,
  ``share_spec``'s cases, placement charged once per plane, and a
  ``QueryServer`` tenant under a grid.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.core import Codec as JCodec  # noqa: E402
from repro.core import outsource as joutsource  # noqa: E402
from repro.models import private_embed as jpe  # noqa: E402
from repro_torch import _tree, api, sharding  # noqa: E402
from repro_torch.api import (Count, EmbedLookup, Eq,  # noqa: E402
                             MeshDispatcher, QueryClient, Select)
from repro_torch.api.backends import Backend, get_backend  # noqa: E402
from repro_torch.core import field  # noqa: E402
from repro_torch.core.dataplane import (SERIAL, DispatchSet,  # noqa: E402
                                        ShardDispatch)
from repro_torch.core.grid import DeviceGrid  # noqa: E402
from repro_torch.core.mesh_dispatch import CLIENT  # noqa: E402
from repro_torch.launch.mesh import (make_dispatch_mesh,  # noqa: E402
                                     make_host_mesh)
from repro_torch.launch.serve import QueryServer  # noqa: E402
from repro_torch.models import private_embed as pe  # noqa: E402
from test_torch_mesh_dispatch import (EMBED_TOKENS, TABLE,  # noqa: E402
                                      _carry, _family_plans, _same,
                                      _same_as_reference)

GRIDS = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1)]
GRID_IDS = [f"{d}x{m}" for d, m in GRIDS]
ROWS = [[f"id{i}", f"nm{i % 5}", str(500 + 137 * i)] for i in range(32)]
CHILD = [[ROWS[i % len(ROWS)][0], f"t{i}"] for i in range(6)]


def _grid(shape, devices=None):
    n_data, n_model = shape
    return make_dispatch_mesh(
        n_model, devices=devices or ["cpu"] * (n_data * n_model))


@pytest.fixture(scope="module", params=[20, 21], ids=["c20", "c21"])
def shared(request):
    """The relation and its child shared by the reference over c clouds,
    the port's copies of the same shares, and the reference's serial
    batch over every family."""
    c = request.param
    codec = JCodec(word_length=6)
    jdb = joutsource(jax.random.PRNGKey(19), ROWS, n_shares=c,
                     column_names=["Id", "Name", "Val"], codec=codec,
                     degree=1, numeric_columns={2: 14})
    jchild = joutsource(jax.random.PRNGKey(23), CHILD, n_shares=c,
                        column_names=["Id", "Task"], codec=codec, degree=1)
    ref = japi.QueryClient(jdb, key=7, backend="jnp").run_batch(
        _family_plans(jchild, japi))
    return dict(c=c, db=_carry(jdb), child=_carry(jchild), reference=ref,
                serial={})


def _serial(shared, shards):
    if shards not in shared["serial"]:
        client = QueryClient(shared["db"], 7, device="cpu")
        client.attach(shards=shards)
        shared["serial"][shards] = client.run_batch(
            _family_plans(shared["child"]))
    return shared["serial"][shards]


# ---------------------------------------------------------------------------
# transcript identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_grid_parity_all_families(shared, grid, shards):
    c = shared["c"]
    mesh = MeshDispatcher(_grid(grid), strict_transfers=True)
    client = QueryClient(shared["db"], 7, device="cpu")
    plane = client.attach(shards=shards, dispatcher=mesh)
    got = client.run_batch(_family_plans(shared["child"]))
    for a, b in zip(_serial(shared, shards), got):
        _same(a, b)
    assert len(got) == len(shared["reference"])
    for jr, tr in zip(shared["reference"], got):
        _same_as_reference(jr, tr)

    groups = grid[1] if c % grid[1] == 0 else 1
    blocks = mesh.blocks(plane)
    assert len(blocks) == shards * groups
    assert {b.n_clouds for b in blocks} == {c // groups}
    assert [b.slot for b in blocks] == [(i % grid[0], g)
                                        for i in range(shards)
                                        for g in range(groups)]
    assert plane.stats.dispatches == plane.stats.steps * shards * groups
    assert mesh.cross_group_bytes() == 0


def test_share_count_that_model_does_not_divide_stays_whole():
    """c = 21 over 2 model slots: one group of every cloud, on column 0."""
    grid = _grid((2, 2))
    assert MeshDispatcher(grid).groups(21) == [(0, 21)]
    assert MeshDispatcher(grid).groups(20) == [(0, 10), (10, 20)]


@pytest.fixture(scope="module")
def embed_tables():
    """(the reference's lookups, the port's copy of its table shares)."""
    jsh = jpe.setup_private_embed(jax.random.PRNGKey(5), TABLE, n_shares=4)
    jc = japi.QueryClient(key=3)
    jc.attach(jpe.as_embed_relation(jsh), name="emb")
    ref = jc.run_batch([japi.EmbedLookup(tokens=t, verify=i == 1)
                        for i, t in enumerate(EMBED_TOKENS)],
                       relation="emb")
    return ref, pe.table_from_arrays(np.asarray(jsh.values), jsh.degree,
                                     device="cpu")


def _lookups(table, shards, dispatcher=None):
    client = QueryClient(seed=3, device="cpu")
    client.attach(pe.as_embed_relation(table), name="emb", shards=shards,
                  dispatcher=dispatcher)
    return client.run_batch([EmbedLookup(tokens=t, verify=i == 1)
                             for i, t in enumerate(EMBED_TOKENS)],
                            relation="emb")


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_grid_embed_lookup_parity(embed_tables, grid, shards):
    """The vocab-sharded lookup over c = 4 clouds (two groups of 2 on
    a 2-column grid) opens the serial dispatcher's and the reference's
    embeddings and charges their ledgers."""
    ref, table = embed_tables
    got = _lookups(table, shards, MeshDispatcher(_grid(grid)))
    for a, b in zip(_lookups(table, shards), got):
        _same(a, b)
    for jr, tr in zip(ref, got):
        assert np.array_equal(tr.embeddings, np.asarray(jr.embeddings))
        assert tr.ledger.as_dict() == jr.ledger.as_dict()


# ---------------------------------------------------------------------------
# operands follow their block
# ---------------------------------------------------------------------------

#: every dispatch closure of the query suite, by qualified name
CLOSURES = {
    "_MatcherPlan.bit_shares.<locals>.<lambda>",     # _shard_values
    "_block_sums.<locals>.one",
    "one_tuple_round.<locals>.one",
    "range_phase.<locals>.<lambda>",
    "_fetch_stack.<locals>.<lambda>",
    "join_match_round.<locals>.rows",
    "equijoin_rounds.<locals>.<lambda>",
    "agg_sum_phase.<locals>.one",
    "agg_minmax_rounds.<locals>.<lambda>",
    "lookup_shares.<locals>.<lambda>",
}


def _one_device(fn):
    """``fn`` after a check that its tensor arguments lie on one device
    (torch's matmuls do not always refuse a meta and a CPU operand)."""
    def run(*args, **kw):
        devs = {t.device for t in list(args) + list(kw.values())
                if isinstance(t, torch.Tensor)}
        assert len(devs) == 1, f"operands on {devs}"
        return fn(*args, **kw)
    return run


CHECKED = Backend("checked", **{
    f: (_one_device(getattr(get_backend("torch"), f))
        if callable(getattr(get_backend("torch"), f)) else None)
    for f in ("ss_matmul", "aa_match_batch", "aa_match_rows",
              "ripple_segment", "ripple_carry", "aa_slide_batch",
              "aa_slide_rows", "share_onehot", "match_matrix")})


class MetaProbe(MeshDispatcher):
    """A (1, 2) grid of ``cpu`` and ``meta``: each step's meta blocks run
    alone, without the reduce; the step's result comes from the serial
    dispatcher on the CPU views, so the query goes on."""

    def __init__(self):
        super().__init__(_grid((1, 2), ["cpu", "meta"]))
        self.probed = set()

    def run_set(self, plane, ds):
        for d in ds.dispatches:
            if d.shard.device.type != "meta":
                continue
            out = d.run()
            for leaf in _tree.leaves(out):
                if isinstance(leaf, torch.Tensor):
                    assert leaf.device.type == "meta"
                    assert leaf.shape[0] == d.shard.n_clouds
            self.probed.add(d.run.func.__qualname__)
        build = ds.dispatches[0].run.func
        serial = DispatchSet(tuple(
            ShardDispatch(sh, functools.partial(build, plane.view(sh.index),
                                                sh))
            for sh in plane.shards), reduce=ds.reduce, axis=ds.axis)
        return SERIAL.run_set(plane, serial)


@pytest.mark.parametrize("shared", [20], indirect=True, ids=["c20"])
@pytest.mark.parametrize("shards", [1, 2])
def test_every_closure_brings_its_operands_to_its_block(shared, shards):
    """Cloud group 1 lives on meta: a closure that captured an operand
    without ``sh.take`` (or read the global cloud count) mixes a CPU
    tensor into a meta block and raises. Every closure runs there — none
    reads a value on the host — and the answers stay the serial ones."""
    probe = MetaProbe()
    client = QueryClient(shared["db"], 7, device="cpu", backend=CHECKED)
    plane = client.attach(shards=shards, dispatcher=probe)
    assert {b.device.type for b in probe.blocks(plane)} == {"cpu", "meta"}
    plans = _family_plans(shared["child"]) + [
        api.Count(api.Contains("Name", "m1")),
        api.Count(api.Suffix("Name", "1")),
        api.Select(api.Prefix("Name", "nm"), strategy="tree")]
    got = client.run_batch(plans)
    for a, b in zip(_serial(shared, shards), got):
        _same(a, b)

    eprobe = MetaProbe()
    table = pe.setup_private_embed(5, TABLE, n_shares=4, device="cpu")
    emb = QueryClient(seed=3, device="cpu", backend=CHECKED)
    emb.attach(pe.as_embed_relation(table), name="emb", shards=shards,
               dispatcher=eprobe)
    emb.run_batch([EmbedLookup(tokens=(17, 4, 63))], relation="emb")
    assert probe.probed | eprobe.probed == CLOSURES


# ---------------------------------------------------------------------------
# the non-communicating clouds
# ---------------------------------------------------------------------------

class Isolating(MeshDispatcher):
    """Runs every cloud step twice: first with each share of the clouds
    outside group 0 raised by one (mod p) in place, in the client's
    relation and so in the blocks placed as views of it, then on the
    relation as shared, whose result it returns. Group 0's clouds of the
    two results must be bit-identical; ``moved`` counts the steps whose
    other clouds changed, ``steps`` every step."""

    def __init__(self, grid):
        super().__init__(grid)
        self.steps = self.moved = 0

    def run_set(self, plane, ds):
        k = self.groups(plane.db.n_shares)[0][1]
        held = [plane.db.relation.values] + [
            s.values for s in plane.db.numeric.values()]
        for t in held:
            t[k:].add_(1).remainder_(field.P)
        try:
            changed = super().run_set(plane, ds)
        finally:
            for t in held:
                t[k:].sub_(1).remainder_(field.P)
        out = super().run_set(plane, ds)
        moved = False
        for a, b in zip(_tree.leaves(out), _tree.leaves(changed),
                        strict=True):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a[:k], b[:k]), \
                    "group 0's clouds moved with another group's shares"
                moved |= not torch.equal(a[k:], b[k:])
            else:
                assert a == b
        self.steps += 1
        self.moved += moved
        return out


@pytest.mark.parametrize("shared", [20], indirect=True, ids=["c20"])
@pytest.mark.parametrize("grid", [(1, 2), (2, 2), (1, 4)],
                         ids=["1x2", "2x2", "1x4"])
def test_cloud_steps_copy_nothing_between_cloud_groups(shared, grid):
    """A count and a fetch (one_round select) with 2 and 4 cloud groups:
    group 0's clouds of every step's result ignore the other groups'
    shares, which move the other clouds of every step; a slot's bytes go
    to its own group's row 0 (the reduce) or to the user (the assembly),
    and nothing goes from one group's slot to another's."""
    mesh = Isolating(_grid(grid))
    client = QueryClient(shared["db"], 7, device="cpu")
    client.attach(shards=2, dispatcher=mesh)
    res = client.run_batch([Count(Eq("Name", "nm1")),
                            Select(Eq("Name", "nm2"), strategy="one_round")])
    assert res[0].count == 7 and len(res[1].rows) == 6
    assert mesh.steps == mesh.moved == 3       # match, match, fetch
    assert mesh.cross_group_bytes() == 0
    gathered = set()
    for cp in mesh.copies():
        src, dst, why = cp["src"], cp["dst"], cp["why"]
        assert cp["bytes"] > 0
        if src == CLIENT:                      # placement, at attach
            assert why in ("operand", "place")
        elif dst == CLIENT:
            assert why == "gather"
            gathered.add(src[1])
        else:
            assert why == "reduce" and src[1] == dst[1] and dst[0] == 0
    assert gathered == set(range(grid[1]))     # every group reaches the user


@pytest.mark.parametrize("shared", [20], indirect=True, ids=["c20"])
@pytest.mark.parametrize("plan", range(11))
def test_group_zero_ignores_other_groups_shares(shared, plan):
    """Every family on a (1, 2) grid at 2 shards: no cloud step's group-0
    clouds move when group 1's shares do, and the answers stay the serial
    dispatcher's. Every step that reads the placed relation moves group
    1's clouds. A range query's segments read the bit rows the user
    stacked from the relation before the step (operands that ``sh.take``
    cuts to each block), which the change does not reach; only a
    RangeSelect's fetch reads the placed relation."""
    mesh = Isolating(_grid((1, 2)))
    client = QueryClient(shared["db"], 7, device="cpu")
    client.attach(shards=2, dispatcher=mesh)
    query = _family_plans(shared["child"])[plan]
    got = client.run(query)
    _same(_serial(shared, 2)[plan], got)
    if isinstance(query, (api.RangeCount, api.RangeSelect)):
        assert mesh.moved == isinstance(query, api.RangeSelect)
    else:
        assert mesh.moved == mesh.steps >= 1


# ---------------------------------------------------------------------------
# grids, placement and the serving seam
# ---------------------------------------------------------------------------

def test_make_dispatch_mesh_shapes():
    cpus = ["cpu"] * 8
    assert make_dispatch_mesh(devices=cpus).shape == {"data": 8, "model": 1}
    grid = make_dispatch_mesh(2, devices=cpus)
    assert grid.shape == {"data": 4, "model": 2}
    assert grid.axis_names == ("data", "model")
    assert grid.devices == [torch.device("cpu")] * 8
    assert make_dispatch_mesh(2, devices=["cpu", "meta"]).rows == (
        (torch.device("cpu"), torch.device("meta")),)
    assert make_host_mesh("cpu").shape == {"data": 1, "model": 1}
    for n_model in (3, 0):
        with pytest.raises(ValueError, match="does not divide"):
            make_dispatch_mesh(n_model, devices=cpus)


def test_strict_transfers_refuses_a_grid_with_a_host_slot():
    """A host slot's copies wait on the device, so strict mode refuses a
    grid of CUDA and host slots when the dispatcher is made."""
    mixed = DeviceGrid(((torch.device("cuda", 0), torch.device("cpu")),))
    with pytest.raises(ValueError, match="CUDA and host slots"):
        MeshDispatcher(mixed, strict_transfers=True)
    assert not MeshDispatcher(mixed).strict_transfers


def test_default_grid_is_the_visible_gpus():
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert make_dispatch_mesh().shape == {"data": n, "model": 1}
    else:
        for make in (make_dispatch_mesh, make_host_mesh, MeshDispatcher):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


def test_share_spec_cases():
    """The port's twins of the reference's ``share_spec`` assertions."""
    host = make_host_mesh("cpu")
    assert sharding.share_spec(host, (20, 32, 4, 3)) == ("model", "data")
    assert sharding.share_spec(host, (20,)) == ("model",)
    grid = _grid((4, 2))
    assert sharding.share_spec(grid, (20, 32, 4, 3)) == ("model", "data")
    assert sharding.share_spec(grid, (21, 30, 4, 3)) == (None, None)


def test_grid_placement_charged_once_per_plane_then_zero(shared):
    db = shared["db"]
    mesh = MeshDispatcher(_grid((2, 2)), strict_transfers=True)
    client = QueryClient(db, 7, device="cpu")
    plane = client.attach(shards=3, dispatcher=mesh)
    placed = db.relation.values.numel() * 4 + sum(
        s.values.numel() * 4 for s in db.numeric.values())
    plans = _family_plans(shared["child"])[:4]
    client.run_batch(plans)
    assert plane.stats.transfer_bytes == placed
    client.run_batch(plans)
    assert plane.stats.transfer_bytes == placed      # zero after placement
    assert sum(cp["bytes"] for cp in mesh.copies()
               if cp["why"] == "place") == placed
    assert plane.db is db                            # no second copy
    for b in mesh.blocks(plane):                     # views of the client's
        v = plane.view(b.index, b).relation.values
        assert v.data_ptr() == db.relation.values[b.c_lo, b.lo].data_ptr()


def test_query_server_tenant_under_a_grid(shared):
    db = shared["db"]
    plans = [Count(Eq("Name", "nm1")), Count(Eq("Name", "nm2")),
             Select(Eq("Name", "nm3"), strategy="one_round")]
    solo = QueryServer(device="cpu")
    solo.attach("emp", db, key=5)
    with solo:
        ref = [solo.submit(p, relation="emp").wait(timeout=60).result
               for p in plans]
    server = QueryServer(device="cpu")
    server.attach("emp", db, key=5, shards=2,
                  dispatcher=MeshDispatcher(_grid((2, 2))))
    with server:
        got = [server.submit(p, relation="emp").wait(timeout=60).result
               for p in plans]
    for a, b in zip(ref, got):
        _same(a, b)
