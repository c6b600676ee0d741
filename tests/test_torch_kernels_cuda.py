"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card: ragged tiles, every block size the kernels are built for, canvas
blocks no entry covers, ``first`` resets in the middle of a run, runs that
add onto the canvas, and bitwise repeatability.  Every case needs a card and
skips without one; this file imports no JAX, so it runs on a machine that
has only the port's dependencies::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spdmm as tspdmm
from repro_torch.kernels import spmm as tspmm

# f32 with another summation order: the tolerance of tests/test_kernels.py
RTOL, ATOL = 2e-5, 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _runs(rng, n_row_blocks, n_col_blocks, pool, ids_hi, cover=0.6):
    """Descriptor lists sorted by output block: every covered block gets
    one consecutive run whose ``first`` pattern is drawn from: reset at the
    start, no reset (adds onto the canvas), or a reset in the middle."""
    orow, ocol, aid, yid, first = [], [], [], [], []
    for r in range(n_row_blocks):
        for c in range(n_col_blocks):
            if rng.uniform() > cover:
                continue
            n = int(rng.integers(1, 5))
            kind = rng.integers(0, 3)
            f = np.zeros(n, np.int32)
            if kind == 0:
                f[0] = 1
            elif kind == 2:
                f[int(rng.integers(0, n))] = 1
            orow += [r] * n
            ocol += [c] * n
            aid += list(rng.integers(0, pool, n))
            yid += list(rng.integers(0, ids_hi, n))
            first += list(f)
    as32 = lambda a: np.asarray(a, np.int32)
    return as32(aid), as32(yid), as32(orow), as32(ocol), as32(first)


def _gemm_case(rng, T=4, m=16, k=20, n=8, grid=(3, 2)):
    x = rng.normal(size=(T, m, k)).astype(np.float32)
    y = rng.normal(size=(T, k, n)).astype(np.float32)
    tiles = rng.permutation(grid[0] * grid[1])[:T]
    rows = (tiles // grid[1]).astype(np.int32)
    cols = (tiles % grid[1]).astype(np.int32)
    z = rng.normal(size=(grid[0] * m, grid[1] * n)).astype(np.float32)
    return x, y, rows, cols, z


def _spdmm_case(rng, B=8, bn=16, nrb=5, ncs=2, K_blocks=6, P=9):
    a = rng.normal(size=(P, B, B)).astype(np.float32)
    y = rng.normal(size=(K_blocks * B, ncs * bn)).astype(np.float32)
    desc = _runs(rng, nrb, ncs, P, K_blocks)
    z = rng.normal(size=(nrb * B, ncs * bn)).astype(np.float32)
    return a, y, desc, z


def _spmm_case(rng, B=8, nrb=4, ncb=3, Pa=7, Py=5):
    a = rng.normal(size=(Pa, B, B)).astype(np.float32)
    yb = rng.normal(size=(Py, B, B)).astype(np.float32)
    desc = _runs(rng, nrb, ncb, Pa, Py)
    z = rng.normal(size=(nrb * B, ncb * B)).astype(np.float32)
    return a, yb, desc, z


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(16, 20, 8), (100, 500, 128), (64, 7, 3),
                                   (130, 128, 70)])
def test_gemm_batch_scatter_kernel_matches_plain(cuda, m, k, n):
    rng = np.random.default_rng(m + k + n)
    x, y, rows, cols, z = _gemm_case(rng, T=5, m=m, k=k, n=n, grid=(3, 2))
    xs, ys, rs, cs = _t(x, y, rows, cols, device=cuda)
    tops.reset_cuda_launch_counts()
    got = tgemm.gemm_batch_scatter(xs, ys, rs, cs,
                                   torch.as_tensor(z, device=cuda))
    assert tops.cuda_launch_counts() == {"gemm_batch_scatter": 1}
    want = tgemm.gemm_batch_scatter_plain(xs, ys, rs, cs,
                                          torch.as_tensor(z, device=cuda))
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("B,bn", [(8, 16), (8, 128), (8, 8), (8, 200),
                                  (4, 16), (16, 32)])
def test_spdmm_fused_kernel_matches_plain(cuda, B, bn):
    rng = np.random.default_rng(B * bn)
    a, y, desc, z = _spdmm_case(rng, B=B, bn=bn, nrb=9, ncs=2, K_blocks=7)
    args = _t(a, y, *desc, device=cuda)
    got = tspdmm.spdmm_fused(*args, block_size=B, bn=bn,
                             z=torch.as_tensor(z, device=cuda))
    again = tspdmm.spdmm_fused(*args, block_size=B, bn=bn,
                               z=torch.as_tensor(z, device=cuda))
    want = tspdmm.spdmm_fused_plain(*args, block_size=B, bn=bn,
                                    z=torch.as_tensor(z, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, again)                 # no atomics: bitwise
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 4, 8, 16, 32])
def test_spmm_fused_kernel_matches_plain(cuda, B):
    rng = np.random.default_rng(B)
    a, yb, desc, z = _spmm_case(rng, B=B, nrb=11, ncb=6)
    args = _t(a, yb, *desc, device=cuda)
    got = tspmm.spmm_fused(*args, block_size=B,
                           z=torch.as_tensor(z, device=cuda))
    again = tspmm.spmm_fused(*args, block_size=B,
                             z=torch.as_tensor(z, device=cuda))
    want = tspmm.spmm_fused_plain(*args, block_size=B,
                                  z=torch.as_tensor(z, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_kernel_wrappers_refuse_bad_operands(cuda):
    rng = np.random.default_rng(0)
    x, y, rows, cols, z = _gemm_case(rng)
    xs, ys, rs, cs, zs = _t(x, y, rows, cols, z, device=cuda)
    with pytest.raises(TypeError):
        tgemm.gemm_batch_scatter(xs.double(), ys, rs, cs, zs)
    with pytest.raises(ValueError):
        tgemm.gemm_batch_scatter(xs, ys, rs, cs, zs.t().contiguous().t())
    with pytest.raises(ValueError):
        tgemm.gemm_batch_scatter(xs, ys, rs, cs, zs.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["GCN", "GIN"])
def test_literal_engine_on_card_matches_cpu(cuda, model):
    """The whole slice at a small size: the literal engine on the card
    launches the kernels and gives the CPU run's logits."""
    from repro_torch.core import DynasparseEngine
    from repro_torch.data.graphs import load_graph
    from repro_torch.models import gnn

    out = {}
    for dev in ("cpu", cuda):
        g = load_graph("CO", scale=0.05, device=dev)
        p = gnn.init_params(model, g.features_dense.shape[1], 16,
                            g.stats.classes, device=dev)
        eng = DynasparseEngine(tile_m=64, tile_n=16, literal=True,
                               device=dev)
        tops.reset_cuda_launch_counts()
        out[str(dev)], _ = gnn.run_inference(model, eng, g.adj,
                                             g.features_dense, p, device=dev)
    launches = tops.cuda_launch_counts()
    assert launches.get("spdmm_fused", 0) > 0, launches
    np.testing.assert_allclose(out[str(cuda)].cpu().numpy(),
                               out["cpu"].numpy(), rtol=1e-4, atol=1e-4)
