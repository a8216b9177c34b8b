"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: every test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import). On a GPU machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Results must be bit-identical (the arithmetic is exact mod p).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import aa_match, ops, ss_matmul  # noqa: E402

P = 2**31 - 1
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _field(shape, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, P, shape, generator=g, dtype=torch.int32, device=dev)
    hot = torch.rand(shape, generator=g, device=dev) < 0.125
    return torch.where(hot, torch.full_like(x, P - 1), x)


@pytest.mark.parametrize("sa,sb", [
    ((37, 1000), (1000, 300)), ((3, 5, 4097), (3, 4097, 129)),
    ((4, 7, 513), (513, 200)), ((2, 0, 64), (2, 64, 10)),
    ((2, 3, 64), (2, 64, 0)), ((2, 3, 300000), (2, 300000, 64)),
    ((1, 17, 131), (1, 131, 255))])
def test_ss_matmul_kernel_equals_plain(cuda, sa, sb):
    a, b = _field(sa, 1, cuda), _field(sb, 2, cuda)
    ops.reset_launch_counts()
    got = ops.ss_matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, ss_matmul.ss_matmul_plain(a, b))
    empty = 0 in sa or 0 in sb
    assert ops.launch_counts()["ss_matmul"] == (0 if empty else 1)


@pytest.mark.parametrize("c,b,n,w,a", [(3, 1, 1000, 8, 69), (2, 3, 77, 5, 33),
                                       (4, 2, 33, 12, 69)])
def test_aa_match_batch_kernel_equals_plain(cuda, c, b, n, w, a):
    col = _field((c, b, n, w, a), 3, cuda)
    pat = _field((c, b, w, a), 4, cuda)
    got = ops.aa_match_batch(col, pat)
    torch.cuda.synchronize()
    assert torch.equal(got, aa_match.aa_match_batch_plain(col, pat))
    one = col[:, :1].expand(c, b, n, w, a)
    assert torch.equal(ops.aa_match_batch(one, pat),
                       aa_match.aa_match_batch_plain(one, pat))


def test_aa_match_rows_kernel_equals_plain(cuda):
    rel = _field((3, 500, 4, 8, 69), 5, cuda)
    pat = _field((3, 5, 8, 69), 6, cuda)
    blocks = dict(columns=[0, 3, 3, 1, 2], starts=[0, 17, 250, 499, 100],
                  lengths=[500, 40, 250, 1, 0])
    got = ops.aa_match_rows(rel, pat=pat, height=500, **blocks)
    torch.cuda.synchronize()
    assert torch.equal(got, aa_match.aa_match_rows_plain(
        rel, pat=pat, height=500, **blocks))
