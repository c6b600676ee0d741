"""The port's per-task path and its kernels (``gemm``, ``spdmm``,
``spmm`` through the fused SpMM kernel, ``gemm_batch``) on the CPU,
against the JAX package on the same numpy inputs (Pallas interpret mode):
each wrapper agrees with the reference within the tolerance of
``tests/test_kernels.py``, bfloat16 included, and the per-task path is
bitwise equal to the port's own batched drain, as the reference's is.
Ports ``tests/test_inplace_assembly.py`` and the ``gemm`` / ``spdmm`` /
``spmm`` cases of ``tests/test_kernels.py``."""
import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import DynasparseEngine as JEngine
from repro.core import sparsity as jsparsity
from repro.core.partition import make_tasks as jmake_tasks
from repro.core.scheduler import execute_plan as jexecute_plan
from repro.data.graphs import load_graph as jload
from repro.kernels import ops as jops
from repro.kernels.formats import pack_blockcsr as jpack
from repro.models import gnn as jgnn
from repro_torch.core import DynasparseEngine as TEngine, SparseCOO as TCOO
from repro_torch.core import sparsity as tsparsity
from repro_torch.core.partition import make_tasks as tmake_tasks
from repro_torch.core.scheduler import execute_plan
from repro_torch.data.graphs import load_graph as tload
from repro_torch.kernels import ops as tops
from repro_torch.kernels.formats import pack_blockcsr as tpack
from repro_torch.models import gnn as tgnn

TOL = dict(rtol=1e-4, atol=1e-4)      # f32 end to end
KTOL = {np.float32: 2e-5, "bf16": 2e-1}   # tests/test_kernels.py


def _rand(rng, m, n, density=1.0, block_mask=None, block=None):
    x = rng.normal(size=(m, n)).astype(np.float32)
    if density < 1.0:
        x = x * (rng.uniform(size=(m, n)) < density)
    if block_mask is not None:
        x = x * np.kron(block_mask, np.ones((block, block)))[:m, :n]
    return x.astype(np.float32)


def _pair(x, dtype):
    """(JAX operand, port operand) of one numpy matrix in ``dtype``."""
    if dtype == "bf16":
        xb = x.astype(ml_dtypes.bfloat16)
        return jnp.asarray(xb), torch.as_tensor(
            xb.astype(np.float32)).to(torch.bfloat16)
    return jnp.asarray(x), torch.as_tensor(x)


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (100, 60, 36), (256, 128, 64)])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_gemm_matches_reference(m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    jx, tx = _pair(_rand(rng, m, k), dtype)
    jy, ty = _pair(_rand(rng, k, n), dtype)
    want = jops.gemm(jx, jy, bm=32, bn=32, bk=32, interpret=True,
                     out_dtype=jnp.float32)
    got = tops.gemm(tx, ty, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=KTOL[dtype], atol=KTOL[dtype] * 10)


def test_gemm_out_dtype_and_mixed_inputs():
    rng = np.random.default_rng(7)
    x, y = _rand(rng, 20, 12), _rand(rng, 12, 9)
    jx, tx = _pair(x, "bf16")
    got = tops.gemm(tx, torch.as_tensor(y))            # mixed: widened
    want = jops.gemm(jx, jnp.asarray(y), interpret=True)
    assert got.dtype == torch.bfloat16                  # x's dtype, as ref
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("T,m,k,n", [(4, 16, 20, 8), (3, 5, 7, 9)])
def test_gemm_batch_matches_reference(T, m, k, n):
    rng = np.random.default_rng(T * m)
    x = rng.normal(size=(T, m, k)).astype(np.float32)
    y = rng.normal(size=(T, k, n)).astype(np.float32)
    want = jops.gemm_batch(jnp.asarray(x), jnp.asarray(y), interpret=True)
    got = tops.gemm_batch(torch.as_tensor(x), torch.as_tensor(y))
    assert got.shape == (T, m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-4)
    # each stacked product is bitwise the dense gemm of that pair
    for t in range(T):
        assert torch.equal(got[t], tops.gemm(torch.as_tensor(x[t]),
                                             torch.as_tensor(y[t])))


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_spdmm_block_density_sweep(block, density):
    rng = np.random.default_rng(block + int(10 * density))
    m, k, n = 4 * block, 6 * block, 3 * block
    mask = (rng.uniform(size=(4, 6)) < density).astype(np.float32)
    a = _rand(rng, m, k, block_mask=mask, block=block)
    y = _rand(rng, k, n)
    want = jops.spdmm(jpack(a, block), jnp.asarray(y), bn=block,
                      interpret=True)
    got = tops.spdmm(tpack(a, block), torch.as_tensor(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-4)
    np.testing.assert_allclose(got.numpy(), a @ y, rtol=2e-5, atol=2e-4)


def test_spdmm_ragged_and_capacity_padding():
    rng = np.random.default_rng(3)
    a = _rand(rng, 50, 70, density=0.2)
    y = _rand(rng, 70, 36)
    want = jops.spdmm(jpack(a, 16), jnp.asarray(y), bn=16, interpret=True)
    got = tops.spdmm(tpack(a, 16), torch.as_tensor(y))
    assert got.shape == (50, 36)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-4)
    a0 = tpack(a, 8)
    a1 = tpack(a, 8, capacity=a0.stored_blocks + 7)
    assert torch.equal(tops.spdmm(a0, torch.as_tensor(y)),
                       tops.spdmm(a1, torch.as_tensor(y)))


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_spdmm_dtypes(dtype):
    rng = np.random.default_rng(5)
    a = _rand(rng, 24, 40, density=0.4)
    y = _rand(rng, 40, 24)
    ja, ta = _pair(a, dtype)
    jy, ty = _pair(y, dtype)
    want = jops.spdmm(jpack(np.asarray(ja), 8), jy, bn=8, interpret=True)
    got = tops.spdmm(tpack(ta, 8), ty)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=KTOL[dtype], atol=KTOL[dtype] * 10)


@pytest.mark.parametrize("da,dy", [(0.0, 0.5), (0.2, 0.2), (1.0, 1.0),
                                   (1.0, 0.0)])
def test_spmm_density_sweep(da, dy):
    rng = np.random.default_rng(int(10 * da + dy * 100))
    am = (rng.uniform(size=(3, 4)) < da).astype(np.float32)
    ym = (rng.uniform(size=(4, 2)) < dy).astype(np.float32)
    a = _rand(rng, 24, 32, block_mask=am, block=8)
    y = _rand(rng, 32, 16, block_mask=ym, block=8)
    want = jops.spmm(jpack(a, 8), jpack(y, 8), interpret=True)
    tops.reset_kernel_call_count()
    got = tops.spmm(tpack(a, 8), tpack(y, 8))
    assert tops.kernel_call_count() == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-4)
    np.testing.assert_allclose(got.numpy(), a @ y, rtol=2e-5, atol=2e-4)


def test_spmm_ragged():
    rng = np.random.default_rng(9)
    a, y = _rand(rng, 20, 28, density=0.3), _rand(rng, 28, 12, density=0.3)
    got = tops.spmm(tpack(a, 8), tpack(y, 8))
    want = jops.spmm(jpack(a, 8), jpack(y, 8), interpret=True)
    assert got.shape == (20, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-4)


# ------------------------------------------------ per-task == batched
def _mixed_ragged():
    """A plan with all three primitives AND ragged edge tiles:
    M=90 over tile_m=32 (extents 32/32/26), N=44 over tile_n=24 (24/20)."""
    rng = np.random.default_rng(1)
    xd = rng.normal(size=(90, 64)).astype(np.float32)
    xd[:32] *= (rng.uniform(size=(32, 64)) < 0.01)
    xd[32:64] *= (rng.uniform(size=(32, 64)) < 0.3)
    yd = rng.normal(size=(64, 44)).astype(np.float32)
    yd[:, :24] *= (rng.uniform(size=(64, 24)) < 0.05)
    r, c = np.nonzero(xd)
    tx = TCOO(xd.shape, torch.as_tensor(r.astype(np.int32)),
              torch.as_tensor(c.astype(np.int32)), torch.as_tensor(xd[r, c]),
              tag="adjacency")
    eng = TEngine(tile_m=32, tile_n=24, literal=True, device="cpu")
    return eng.plan(tx, torch.as_tensor(yd)), xd, yd


def test_pertask_mixed_primitives_ragged_bitwise_and_reference():
    plan, xd, yd = _mixed_ragged()
    assert {t.primitive for t in plan.stq + plan.dtq} == {"SpDMM", "SpMM",
                                                          "GEMM"}
    x, y = torch.as_tensor(xd), torch.as_tensor(yd)
    tops.reset_kernel_call_count()
    z_p = execute_plan(plan.part, plan.stq, plan.dtq, x, y, batched=False)
    assert tops.kernel_call_count() == len(plan.stq) + len(plan.dtq)
    z_b = execute_plan(plan.part, plan.stq, plan.dtq, x, y, batched=True)
    assert torch.equal(z_b, z_p)
    want = jexecute_plan(plan.part, plan.stq, plan.dtq, xd, yd,
                         batched=False)
    np.testing.assert_allclose(z_p.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(z_p.numpy(), xd @ yd, **TOL)


def _forced_plan(xd, yd, tm, tn, assign):
    """Task grid of both packages with ``assign(task) -> primitive``."""
    parts = []
    for stripe_density, make in ((tsparsity.stripe_density, tmake_tasks),
                                 (jsparsity.stripe_density, jmake_tasks)):
        conv = torch.as_tensor if make is tmake_tasks else jnp.asarray
        row_d = np.asarray(stripe_density(conv(xd), tm, axis=0))
        col_d = np.asarray(stripe_density(conv(yd), tn, axis=1))
        part = make("k", xd.shape[0], xd.shape[1], yd.shape[1], row_d, col_d,
                    tm, tn)
        for t in part.tasks:
            t.primitive = assign(t)
            t.queue = "DTQ" if t.primitive == "GEMM" else "STQ"
        parts.append((part, [t for t in part.tasks if t.queue == "STQ"],
                      [t for t in part.tasks if t.queue == "DTQ"]))
    return parts


@pytest.mark.parametrize("primitive", ["GEMM", "SpDMM", "SpMM"])
def test_single_primitive_ragged_bitwise(primitive):
    rng = np.random.default_rng(7)
    xd = (rng.normal(size=(40, 32)) *
          (rng.uniform(size=(40, 32)) < 0.4)).astype(np.float32)
    yd = (rng.normal(size=(32, 20)) *
          (rng.uniform(size=(32, 20)) < 0.5)).astype(np.float32)
    (part, stq, dtq), _ = _forced_plan(xd, yd, 16, 8, lambda t: primitive)
    x, y = torch.as_tensor(xd), torch.as_tensor(yd)
    tops.reset_kernel_call_count()
    z_b = execute_plan(part, stq, dtq, x, y, batched=True)
    assert tops.kernel_call_count() == 1          # ONE fused launch
    z_p = execute_plan(part, stq, dtq, x, y, batched=False)
    assert torch.equal(z_b, z_p)
    np.testing.assert_allclose(z_b.numpy(), xd @ yd, **TOL)


def test_uncovered_tiles_stay_zero():
    plan, xd, yd = _mixed_ragged()
    part = plan.part
    x, y = torch.as_tensor(xd), torch.as_tensor(yd)
    z = execute_plan(part, plan.stq, [], x, y, batched=False).numpy()
    z_full = execute_plan(part, plan.stq, plan.dtq, x, y).numpy()
    tm, tn = part.tile_m, part.tile_n
    for tasks, want in ((plan.dtq, None), (plan.stq, z_full)):
        for task in tasks:
            rs = slice(task.i * tm, task.i * tm + part.row_extent(task.i))
            cs = slice(task.j * tn, task.j * tn + part.col_extent(task.j))
            ref = np.zeros_like(z[rs, cs]) if want is None else want[rs, cs]
            np.testing.assert_array_equal(z[rs, cs], ref)


def test_misaligned_tiles_fall_back_to_pertask_and_match():
    """tile_m = 12 is not lcm(block, 8)-aligned: the batched call takes the
    per-task path, equal to an explicit per-task call and to the
    reference's fallback."""
    rng = np.random.default_rng(3)
    xd = (rng.normal(size=(36, 24)) *
          (rng.uniform(size=(36, 24)) < 0.3)).astype(np.float32)
    yd = rng.normal(size=(24, 16)).astype(np.float32)
    mixed = lambda t: "SpDMM" if (t.i + t.j) % 2 else "GEMM"
    (part, stq, dtq), (jpart, jstq, jdtq) = _forced_plan(xd, yd, 12, 8, mixed)
    x, y = torch.as_tensor(xd), torch.as_tensor(yd)
    tops.reset_kernel_call_count()
    z_b = execute_plan(part, stq, dtq, x, y, batched=True)
    assert tops.kernel_call_count() == len(stq) + len(dtq)
    z_p = execute_plan(part, stq, dtq, x, y, batched=False)
    assert torch.equal(z_b, z_p)
    want = jexecute_plan(jpart, jstq, jdtq, xd, yd, batched=True)
    np.testing.assert_allclose(z_b.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(z_b.numpy(), xd @ yd, **TOL)


def test_misaligned_sparse_only_engine_uses_packed_stripes():
    """Misaligned tiles, all-sparse plan, x never densified: the per-task
    fallback consumes the packed stripes."""
    rng = np.random.default_rng(9)
    n, nnz = 36, 60
    flat = np.sort(rng.choice(n * n, size=nnz, replace=False))
    rows, cols = (flat // n).astype(np.int32), (flat % n).astype(np.int32)
    vals = np.abs(rng.normal(size=nnz)).astype(np.float32)
    adj = TCOO((n, n), torch.as_tensor(rows), torch.as_tensor(cols),
               torch.as_tensor(vals), tag="adjacency")
    y = rng.normal(size=(n, 8)).astype(np.float32)
    eng = TEngine(tile_m=12, tile_n=8, literal=True, mode="sparse_only",
                  device="cpu")
    z, _ = eng.matmul(adj, torch.as_tensor(y))
    np.testing.assert_allclose(z.numpy(), adj.todense() @ y, **TOL)


def test_single_stripe_padded_slots_inplace():
    rng = np.random.default_rng(5)
    xd = (rng.normal(size=(20, 16)) *
          (rng.uniform(size=(20, 16)) < 0.4)).astype(np.float32)
    yd = rng.normal(size=(16, 5)).astype(np.float32)
    eng = TEngine(tile_m=128, tile_n=128, literal=True, device="cpu")
    z, _ = eng.matmul(torch.as_tensor(xd), torch.as_tensor(yd))
    assert z.shape == (20, 5)
    np.testing.assert_allclose(z.numpy(), xd @ yd, **TOL)


# ---------------------------------------------------------- whole engine
@pytest.mark.parametrize("model", ["GCN", "GIN"])
def test_batched_false_engine_matches_reference_and_batched(model):
    """The per-task engine end to end: the reference's per-task logits
    within 1e-4, the same kernel names and queues, and the port's batched
    engine's logits bit for bit."""
    jg = jload("CO", scale=0.02)
    tg = tload("CO", scale=0.02, device="cpu")
    jp = jgnn.init_params(model, jg.features_dense.shape[1], 16,
                          jg.stats.classes)
    tp = tgnn.params_from_jax(jp, "cpu")
    je = JEngine(tile_m=32, tile_n=16, literal=True, batched=False)
    te = TEngine(tile_m=32, tile_n=16, literal=True, batched=False,
                 device="cpu")
    jl, jr = jgnn.run_inference(model, je, jg.adj, jg.features_dense, jp)
    tl, tr = tgnn.run_inference(model, te, tg.adj, tg.features_dense, tp,
                                device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert [n for n, _ in tr.kernels] == [n for n, _ in jr.kernels]
    assert te.cache.stats.dispatch_builds == 0     # no compiled dispatch
    tb = TEngine(tile_m=32, tile_n=16, literal=True, device="cpu")
    bl, _ = tgnn.run_inference(model, tb, tg.adj, tg.features_dense, tp,
                               device="cpu")
    assert torch.equal(tl, bl)
