"""The port's three GNN property sweeps (``tests/test_properties.py:27,
55, 97``) as bodies that take a device, and their run on the card's CUDA
kernels.  This file imports no JAX, so it runs on a machine that has only
the port's dependencies::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_properties_cuda.py

``tests/test_torch_properties.py`` runs the same bodies on the CPU (the
kernels' plain versions).  Invariants, as the reference states them:

- ``spdmm`` / ``spmm`` equal the dense product for any block pattern;
- for any ragged geometry and operand sparsity, the engine's compiled
  dispatch, the eager batched path and the per-task path agree bitwise;
- for any ragged geometry, activation block pattern, dtype, eps and
  capacity within budget, the compiled block-skip route equals the eager
  batched and per-task paths bitwise; a capacity below the need raises the
  overflow flag and gives the dense ``gemm``'s result bitwise.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings, strategies as st  # noqa: E402

from repro_torch.core import DynasparseEngine, SparseCOO  # noqa: E402
from repro_torch.core import dispatch as dispatch_mod  # noqa: E402
from repro_torch.core.scheduler import execute_plan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.formats import pack_blockcsr  # noqa: E402

# the reference's tolerances against the float64-free dense product
DENSE_TOL = dict(rtol=2e-4, atol=2e-3)
BF16_DENSE_TOL = dict(rtol=2e-2, atol=2e-2)

SPARSE = dict(nrb=st.integers(1, 4), ncb=st.integers(1, 4),
              nnb=st.integers(1, 3), da=st.floats(0.0, 1.0),
              dy=st.floats(0.0, 1.0), seed=st.integers(0, 2**31 - 1))
COMPILED = dict(M=st.integers(9, 70), K=st.integers(8, 48),
                N=st.integers(4, 40), tm=st.sampled_from([8, 16, 24, 32]),
                tn=st.sampled_from([8, 12, 16]), dx=st.floats(0.02, 0.9),
                dy=st.floats(0.02, 1.0), seed=st.integers(0, 2**31 - 1))
SKIP = dict(M=st.integers(9, 70), K=st.integers(8, 48), N=st.integers(4, 40),
            tm=st.sampled_from([8, 16, 32]), tn=st.sampled_from([8, 16, 24]),
            bd=st.floats(0.0, 0.6), dy=st.floats(0.02, 1.0),
            eps=st.sampled_from([0.0, 0.05]),
            dtype=st.sampled_from(["float32", "bfloat16"]),
            capmode=st.sampled_from(["auto", "exact", "slack", "overflow"]),
            seed=st.integers(0, 2**31 - 1))


def sweep(n_examples: int, strategies: dict):
    """Hypothesis settings of the port's sweeps: derandomized (every run
    and every worker draws the same examples), no example database."""
    def wrap(fn):
        return settings(max_examples=n_examples, deadline=None,
                        database=None, derandomize=True,
                        suppress_health_check=list(HealthCheck))(
            given(**strategies)(fn))
    return wrap


def check_sparse_kernels_match_dense(device, nrb, ncb, nnb, da, dy, seed):
    block = 8
    rng = np.random.default_rng(seed)
    m, k, n = nrb * block, ncb * block, nnb * block
    am = (rng.uniform(size=(nrb, ncb)) < da).astype(np.float32)
    ym = (rng.uniform(size=(ncb, nnb)) < dy).astype(np.float32)
    a_dense = (rng.normal(size=(m, k)) * np.kron(am, np.ones((block, block)))
               ).astype(np.float32)
    y_dense = (rng.normal(size=(k, n)) * np.kron(ym, np.ones((block, block)))
               ).astype(np.float32)
    a = pack_blockcsr(a_dense, block, device=device)
    y_sp = pack_blockcsr(y_dense, block, device=device)
    want = a_dense @ y_dense
    got_spdmm = ops.spdmm(a, torch.as_tensor(y_dense, device=device))
    got_spmm = ops.spmm(a, y_sp)
    np.testing.assert_allclose(got_spdmm.cpu().numpy(), want, **DENSE_TOL)
    np.testing.assert_allclose(got_spmm.cpu().numpy(), want, **DENSE_TOL)


def check_compiled_eager_pertask_bit_identity(device, M, K, N, tm, tn, dx,
                                              dy, seed):
    rng = np.random.default_rng(seed)
    xd = (rng.normal(size=(M, K)) *
          (rng.uniform(size=(M, K)) < dx)).astype(np.float32)
    yd = (rng.normal(size=(K, N)) *
          (rng.uniform(size=(K, N)) < dy)).astype(np.float32)
    r, c = np.nonzero(xd)
    as_t = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    x = SparseCOO(xd.shape, as_t(r.astype(np.int32)),
                  as_t(c.astype(np.int32)), as_t(xd[r, c]), tag="adjacency")
    eng = DynasparseEngine(tile_m=tm, tile_n=tn, literal=True, device=device)
    y = as_t(yd)
    plan = eng.plan(x, y)
    z_c = eng.execute(plan, x, y)
    z_b = execute_plan(plan.part, plan.stq, plan.dtq, as_t(xd), y,
                       batched=True)
    z_p = execute_plan(plan.part, plan.stq, plan.dtq, as_t(xd), y,
                       batched=False)
    assert torch.equal(z_c, z_b)
    assert torch.equal(z_c, z_p)
    np.testing.assert_allclose(z_c.cpu().numpy(), xd @ yd, **DENSE_TOL)


def check_activation_skip_bit_identity(device, M, K, N, tm, tn, bd, dy, eps,
                                       dtype, capmode, seed):
    rng = np.random.default_rng(seed)
    B = 8
    nrb, ncb = -(-M // B), -(-K // B)
    mask = (rng.uniform(size=(nrb, ncb)) < bd).astype(np.float32)
    xf = ((rng.normal(size=(nrb * B, ncb * B))
           * np.kron(mask, np.ones((B, B))))[:M, :K]).astype(np.float32)
    yd = (rng.normal(size=(K, N)) *
          (rng.uniform(size=(K, N)) < dy)).astype(np.float32)
    x = torch.as_tensor(xf, device=device).to(getattr(torch, dtype))
    y = torch.as_tensor(yd, device=device)
    eng = DynasparseEngine(tile_m=tm, tile_n=tn, literal=True, eps=eps,
                           device=device)
    plan = eng.plan(x, y)
    if not plan.stq:
        return                                    # dense wins: no route
    need = dispatch_mod.activation_capacity(x, plan.part, B, eps=eps,
                                            slack=1.0)
    if need is None:
        return                                    # misaligned canvas
    cap = {"auto": None, "exact": need, "slack": need + 3,
           "overflow": max(1, need - 1)}[capmode]
    ad = eng.activation_dispatch_for(plan, x, capacity=cap)
    assert ad is not None
    z_a, diag = dispatch_mod.execute_activation(ad, x, y)
    if capmode == "overflow" and need > 1:
        assert bool(diag["overflow"])
        assert torch.equal(z_a, ops.gemm(x, y, out_dtype=torch.float32))
        return
    assert not bool(diag["overflow"])
    z_b = execute_plan(plan.part, plan.stq, plan.dtq, x, y, batched=True,
                       eps=eps)
    z_p = execute_plan(plan.part, plan.stq, plan.dtq, x, y, batched=False,
                       eps=eps)
    assert torch.equal(z_a, z_b)
    assert torch.equal(z_a, z_p)
    if eps == 0.0:
        np.testing.assert_allclose(z_a.cpu().numpy(),
                                   x.float().cpu().numpy() @ yd,
                                   **BF16_DENSE_TOL)


# ------------------------------------------------------------- the card
CUDA_EXAMPLES = 25


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_property_sparse_kernels_match_dense_cuda(cuda):
    sweep(CUDA_EXAMPLES, SPARSE)(
        lambda **kw: check_sparse_kernels_match_dense(cuda, **kw))()


@pytest.mark.gpu
def test_property_compiled_eager_pertask_bit_identity_cuda(cuda):
    sweep(CUDA_EXAMPLES, COMPILED)(
        lambda **kw: check_compiled_eager_pertask_bit_identity(cuda, **kw))()


@pytest.mark.gpu
def test_property_activation_skip_bit_identity_cuda(cuda):
    sweep(CUDA_EXAMPLES, SKIP)(
        lambda **kw: check_activation_skip_bit_identity(cuda, **kw))()
