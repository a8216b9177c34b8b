"""The ``share_onehot`` kernel's launch plan (``kernels/ss_matmul.py``
``onehot_plan``), which is pure Python and runs here, a numpy emulation of
the quad route's word -> (row, column, hot) mapping, and the routes the
embedding lookups' calls would take.

The plan picks one of two routes from a1's and the output's pointers, a1's
strides, M and V: ``quad`` (16-byte quads of the flat (M, V) plane: a1 one
flat run, both bases 16-byte aligned, M·V % 4 == 0) or ``word``
(anything else). The kernel itself runs only on a GPU
(``tests/test_torch_kernels_cuda.py``); here a spy on the plain version
plans each call the lookup paths make.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, configs  # noqa: E402
from repro_torch.core import ShardedRelation  # noqa: E402
from repro_torch.kernels import ss_matmul  # noqa: E402
from repro_torch.models import private_embed as pe  # noqa: E402

P = 2**31 - 1
BASE = 1 << 20                     # a 16-byte-aligned stand-in address
#: every main path's M: decode steps of 4 and 8 requests, 256-row
#: prefills, slice 10's 2,048-token training step
MAIN_M = (4, 8, 256, 2048)


def _plan(m, v, strides=None, a1_ptr=BASE, out_ptr=BASE + 4096):
    return ss_matmul.onehot_plan(a1_ptr, out_ptr,
                                 strides or (v, 1), m, v)


# -- the plan --------------------------------------------------------------

@pytest.mark.parametrize("m", MAIN_M)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_plan_quad_for_every_main_path_shape(arch, m):
    """Every configuration's vocabulary (65,024; 262,144; 49,155; 32,001;
    128,256; 50,280; 73,448; 151,936; 256,206; 163,840) at every main-path
    M takes the quad route: M is a multiple of 4, so M·V is too."""
    v = configs.full(arch).vocab_size
    assert _plan(m, v) == "quad"


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_plan_quad_on_allocated_operands(arch):
    """The same at M = 4 on real tensors: a fresh a1 and the wrapper's
    output allocation are both 16-byte aligned."""
    v = configs.full(arch).vocab_size
    a1 = torch.empty((4, v), dtype=torch.int32)
    out = torch.empty((4, 4, v), dtype=torch.int32)
    assert ss_matmul.onehot_plan(a1.data_ptr(), out.data_ptr(), a1.stride(),
                                 4, v) == "quad"


@pytest.mark.parametrize("m,v,strides,a1_off,out_off,route", [
    (8, 1024, (1030, 1), 0, 0, "word"),      # a column slice of wider rows
    (3, 8, (2 * 1030, 1), 0, 0, "word"),     # every other row of a slice
    (4, 1000, (1000, 1), 4, 0, "word"),      # a1 4 bytes off 16-byte bounds
    (4, 1000, (1000, 1), 12, 0, "word"),
    (4, 1000, (1000, 1), 0, 8, "word"),      # the output off 16-byte bounds
    (4, 1000, (1000, 1), 16, 32, "quad"),    # both on 16-byte bounds
    (4, 6, (1, 4), 0, 0, "word"),            # a transposed a1
    (4, 1000, (2000, 2), 0, 0, "word"),      # a column stride of 2
    (3, 1001, (1001, 1), 0, 0, "word"),      # M·V % 4 == 3
    (2, 1001, (1001, 1), 0, 0, "word"),      # M·V % 4 == 2
    (1, 1003, (1003, 1), 0, 0, "word"),      # M·V % 4 == 3
    (4, 1001, (1001, 1), 0, 0, "quad"),
    (1, 1000, (4096, 1), 0, 0, "quad"),      # one row: its stride is free
    (8, 1, (1, 7), 0, 0, "quad"),            # one column: its stride is free
    (2, 2, (2, 1), 0, 0, "quad"),            # V < 4: a quad spans 2 rows
    (4, 1, (1, 1), 0, 0, "quad"),            # V = 1: 4 rows a quad
])
def test_plan_route(m, v, strides, a1_off, out_off, route):
    assert _plan(m, v, strides, BASE + a1_off, BASE + 4096 + out_off) \
        == route


def test_plan_routes_of_views():
    """The strided a1 views ``chip_smoke.py`` holds the kernel to take the
    word route; the contiguous buffers the quad route."""
    wide = torch.empty((6, 1030), dtype=torch.int32)
    out = torch.empty(4096, dtype=torch.int32)
    for view, route in ((wide[:, 3:1027], "word"), (wide[::2, 1:9], "word"),
                        (wide[:, :1024], "word"), (wide[:4, :1028], "word"),
                        (wide, "quad"), (wide[2:4], "quad"),
                        (wide[1:3], "word")):       # base 4,120 B in
        assert ss_matmul.onehot_plan(view.data_ptr(), out.data_ptr(),
                                     view.stride(), *view.shape) == route


# -- a numpy emulation of the quad route -------------------------------------

def _quad_route(toks: np.ndarray, a1: np.ndarray, c: int) -> np.ndarray:
    """The quad route's arithmetic, read from ``csrc/share_onehot.cu``:
    thread q owns words w = 4q..4q+3 of the flat plane, its first row is
    r = w // V, and every row whose span [r·V, r·V + V) meets [w, w + 4)
    adds its hot word (token t in [0, V)) at h = r·V + t − w when
    0 <= h < 4. The shares follow as s = hot + a1, s += a1 (mod p) for
    each further cloud. Rows past M stop the walk where M·V % 4 != 0 (the
    kernel takes the word route there; the mapping is the same)."""
    m, v = a1.shape
    n = m * v
    flat = a1.reshape(-1).astype(np.int64)
    w = 4 * np.arange(-(-n // 4), dtype=np.int64)
    bits = np.zeros(w.shape, dtype=np.int64)
    r = w // v
    start = r * v
    while True:
        live = (start < w + 4) & (r < m)
        if not live.any():
            break
        t = toks[np.minimum(r, m - 1)]
        ok = live & (t >= 0) & (t < v)
        h = np.where(ok, start + np.where(ok, t, 0) - w, -1)
        hit = (h >= 0) & (h < 4)
        bits |= np.where(hit, 1 << np.clip(h, 0, 3), 0)
        start, r = start + v, r + 1
    hot = ((bits[:, None] >> np.arange(4)) & 1).reshape(-1)[:n]
    # the (row, column) each word's hot bit stands for
    word = np.arange(n)
    row, col = word // v, word % v
    assert np.array_equal(hot, (toks[row] == col).astype(np.int64))
    out = np.empty((c, n), dtype=np.int64)
    s = (hot + flat) % P
    for k in range(c):
        out[k] = s
        s = (s + flat) % P
    return out.reshape(c, m, v)


@pytest.mark.parametrize("v", [1, 2, 3, 4, 5, 6, 7, 8, 13, 1000, 1001, 1002,
                               1003])
def test_quad_route_emulation_equals_plain(v):
    """V % 4 in {0, 1, 2, 3}, M = 1..9, tokens −1, 0, V−1 and V (and −5,
    2³¹ + 3) in every row position: the emulation equals
    ``share_onehot_plain`` word for word."""
    rng = np.random.default_rng(v)
    edges = np.array([-1, 0, v - 1, v, -5, 2**31 + 3], dtype=np.int64)
    for m in range(1, 10):
        for shift in range(len(edges)):
            toks = np.roll(np.resize(edges, m), shift)
            toks[rng.random(m) < 0.3] = rng.integers(0, v)
            a1 = rng.integers(0, P, size=(m, v)).astype(np.int32)
            a1[rng.random((m, v)) < 0.125] = P - 1
            want = ss_matmul.share_onehot_plain(
                torch.from_numpy(toks), torch.from_numpy(a1), n_shares=4)
            assert np.array_equal(_quad_route(toks, a1, 4),
                                  want.numpy().astype(np.int64))


# -- the routes of the lookups' calls ----------------------------------------

@pytest.fixture
def planned(monkeypatch):
    """Spy on ``share_onehot_plain`` (what ``ops.share_onehot`` runs on a
    CPU tensor): record (M, V, the route ``onehot_plan`` names for the
    call's a1 and an output allocated as the wrapper allocates it)."""
    seen = []
    inner = ss_matmul.share_onehot_plain

    def spy(tokens, a1, *, n_shares):
        out = torch.empty((n_shares, *a1.shape), dtype=torch.int32)
        seen.append((*a1.shape, ss_matmul.onehot_plan(
            a1.data_ptr(), out.data_ptr(), a1.stride(), *a1.shape)))
        return inner(tokens, a1, n_shares=n_shares)

    monkeypatch.setattr(ss_matmul, "share_onehot_plain", spy)
    return seen


@pytest.mark.parametrize("shards", [1, 2])
def test_lookups_take_the_quad_route(planned, shards):
    """Every lookup shares its step's tokens in one call on a fresh
    (ΣN, V) a1: the quad route whenever ΣN·V % 4 == 0, as at every
    main-path M; ΣN = 3 over V = 1,001 takes the word route."""
    v, d = 1001, 8
    table = np.random.default_rng(3).uniform(-1, 1, (v, d)).astype(
        np.float32)
    shares = pe.setup_private_embed(3, table, n_shares=4, device="cpu")
    rel = pe.as_embed_relation(shares)
    client = api.QueryClient(ShardedRelation(rel, shards=shards)
                             if shards > 1 else rel, seed=1, device="cpu")
    toks = np.random.default_rng(4).integers(0, v, 16)
    client.run(api.EmbedLookup(tokens=toks[:4]))
    client.run_batch([api.EmbedLookup(tokens=toks[:8]),
                      api.EmbedLookup(tokens=toks[8:12], verify=True)])
    pe.private_lookup_batched((5,), shares, toks[:8].reshape(2, 4))
    client.run(api.EmbedLookup(tokens=toks[:3]))
    assert planned == [(4, v, "quad"), (12, v, "quad"), (8, v, "quad"),
                       (3, v, "word")]
