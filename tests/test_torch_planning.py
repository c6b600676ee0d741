"""The port's planning layer equals the JAX package's exactly: perf-model
closed forms, density measurements (dtype and bits), task grids, Analyzer
assignments, simulated schedules, fingerprints and dispatch digests."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import analyzer as ja
from repro.core import dispatch as jd
from repro.core import partition as jpart
from repro.core import perfmodel as jpm
from repro.core import plancache as jpc
from repro.core import scheduler as jsch
from repro.core import sparsity as jsp
from repro.core import DynasparseEngine as JEngine, SparseCOO as JCOO
from repro_torch.core import analyzer as ta
from repro_torch.core import dispatch as td
from repro_torch.core import partition as tpart
from repro_torch.core import perfmodel as tpm
from repro_torch.core import plancache as tpc
from repro_torch.core import scheduler as tsch
from repro_torch.core import sparsity as tsp
from repro_torch.core import DynasparseEngine as TEngine, SparseCOO as TCOO

HW = ["VCK5000", "VCK5000_384", "TPUV5E"]


def _rand_x(rng, m, k, density):
    x = rng.normal(size=(m, k)).astype(np.float32)
    return x * (rng.uniform(size=(m, k)) < density)


def _coo_pair(xd, tag="adjacency"):
    r, c = np.nonzero(xd)
    rows, cols, vals = r.astype(np.int32), c.astype(np.int32), xd[r, c]
    j = JCOO(xd.shape, jnp.asarray(rows), jnp.asarray(cols),
             jnp.asarray(vals), tag=tag)
    t = TCOO(xd.shape, torch.as_tensor(rows), torch.as_tensor(cols),
             torch.as_tensor(vals), tag=tag)
    return j, t


@pytest.mark.parametrize("hw", HW)
def test_perfmodel_closed_forms_equal(hw):
    jhw, thw = getattr(jpm, hw), getattr(tpm, hw)
    assert dataclasses.asdict(jhw) == dataclasses.asdict(thw)
    rng = np.random.default_rng(0)
    for _ in range(50):
        m, n, d = (int(v) for v in rng.integers(1, 5000, 3))
        ax, ay = (float(v) for v in rng.uniform(0, 1, 2))
        js, ts = jpm.TaskShape(m, n, d, ax, ay), tpm.TaskShape(m, n, d, ax, ay)
        assert jpm.t_dense(js, jhw) == tpm.t_dense(ts, thw)
        assert jpm.t_sparse(js, jhw) == tpm.t_sparse(ts, thw)
        for prim in ("GEMM", "SpDMM", "SpMM"):
            assert jpm.flops(js, prim) == tpm.flops(ts, prim)
            assert jpm.data_count(js, prim) == tpm.data_count(ts, prim)


def test_runtime_fallback_equal():
    """Every backend kind but ``"cuda"`` keeps the reference's table; the
    port's ``"cuda"`` entry holds the H100 data-sheet guesses instead of
    the TPUv5e constants (still ``fallback=True``)."""
    for backend in ("tpu", "gpu", "cpu"):
        assert (dataclasses.asdict(jpm.runtime_fallback(backend))
                == dataclasses.asdict(tpm.runtime_fallback(backend)))
    cuda = tpm.runtime_fallback("cuda")
    assert cuda.fallback and cuda.name == "cuda-fallback"
    assert cuda.mem_bw == 3.35e12 and cuda.bytes_per_elem == 4
    assert cuda.f_dense * cuda.dense_macs_per_cycle == 67e12 / 2


@pytest.mark.parametrize("shape,tile,eps", [
    ((90, 64), 32, 0.0), ((37, 101), 8, 0.0), ((2368, 3), 2368, 0.0),
    ((64, 48), 24, 0.5), ((17, 5), 17, 0.0)])
def test_densities_float32_bitwise(shape, tile, eps):
    rng = np.random.default_rng(sum(shape))
    x = _rand_x(rng, *shape, 0.3)
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    for axis in (0, 1):
        t = min(tile, shape[axis])
        want = np.asarray(jsp.stripe_density(xj, t, axis=axis, eps=eps))
        got = tsp.stripe_density(xt, t, axis=axis, eps=eps)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tsp.tile_density(xt, 8, 16, eps=eps).numpy(),
        np.asarray(jsp.tile_density(xj, 8, 16, eps=eps)))
    np.testing.assert_array_equal(tsp.density(xt, eps).numpy(),
                                  np.asarray(jsp.density(xj, eps)))
    np.testing.assert_array_equal(
        tsp.sketch_col_density(xt, 8, max_rows=16, eps=eps),
        jsp.sketch_col_density(xj, 8, max_rows=16, eps=eps))
    assert tsp.block_density(x, 8, eps) == jsp.block_density(x, 8, eps)


def test_row_stripe_density_float64_equal():
    rng = np.random.default_rng(3)
    j, t = _coo_pair(_rand_x(rng, 100, 80, 0.1))
    for tile, eps in ((32, 0.0), (7, 0.0), (32, 1.0)):
        want = j.row_stripe_density(tile, eps=eps)
        got = t.row_stripe_density(tile, eps=eps)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    a = rng.uniform(size=5)
    assert tsp.density_drift(a, a + 0.1) == jsp.density_drift(a, a + 0.1)


def _tasks_tuple(tasks):
    return [(t.kernel, t.i, t.j, dataclasses.astuple(t.shape), t.primitive,
             t.queue, t.t_dense, t.t_sparse) for t in tasks]


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("strategy", ["balanced", "greedy", "STQ", "DTQ"])
def test_analyzer_and_schedule_equal(hw, strategy):
    rng = np.random.default_rng(9)
    M, K, N, tm, tn = 300, 256, 70, 64, 32
    row_d = rng.uniform(0, 0.6, -(-M // tm))
    col_d = np.concatenate([rng.uniform(0, 1, -(-N // tn) - 1), [1.0]])
    jp = jpart.make_tasks("k", M, K, N, row_d, col_d, tm, tn)
    tp = tpart.make_tasks("k", M, K, N, row_d, col_d, tm, tn)
    assert _tasks_tuple(jp.tasks) == _tasks_tuple(tp.tasks)
    jhw, thw = getattr(jpm, hw), getattr(tpm, hw)
    if strategy in ("STQ", "DTQ"):
        js, jq = ja.force_queue(jp, jhw, strategy)
        ts, tq = ta.force_queue(tp, thw, strategy)
    else:
        js, jq = ja.analyze_kernel(jp, jhw, strategy)
        ts, tq = ta.analyze_kernel(tp, thw, strategy)
    assert _tasks_tuple(js) == _tasks_tuple(ts)
    assert _tasks_tuple(jq) == _tasks_tuple(tq)
    assert (dataclasses.asdict(jsch.simulate(js, jq, jhw))
            == dataclasses.asdict(tsch.simulate(ts, tq, thw)))


def test_choose_tile_equal():
    for m, n in ((89250, 128), (2708, 2708), (100, 7), (12345, 600)):
        assert jpart.choose_tile(m, n) == tpart.choose_tile(m, n)


def test_fingerprint_plan_and_digest_equal():
    """Same operand -> same coo_fingerprint, same engine plan (densities,
    assignment, report) and the same dispatch digest in both packages."""
    rng = np.random.default_rng(1)
    xd = _rand_x(rng, 90, 64, 0.1)
    xd[32:64] = _rand_x(rng, 32, 64, 0.4)
    yd = _rand_x(rng, 64, 44, 0.5)
    jx, tx = _coo_pair(xd)
    assert jpc.coo_fingerprint(jx) == tpc.coo_fingerprint(tx)
    je = JEngine(tile_m=32, tile_n=24, literal=True)
    te = TEngine(tile_m=32, tile_n=24, literal=True, device="cpu")
    jplan = je.plan(jx, jnp.asarray(yd))
    tplan = te.plan(tx, torch.as_tensor(yd))
    assert jplan.struct_key == tplan.struct_key
    np.testing.assert_array_equal(tplan.row_density, jplan.row_density)
    np.testing.assert_array_equal(tplan.col_density, jplan.col_density)
    assert _tasks_tuple(jplan.stq) == _tasks_tuple(tplan.stq)
    assert _tasks_tuple(jplan.dtq) == _tasks_tuple(tplan.dtq)
    assert (dataclasses.asdict(jplan.report)
            == dataclasses.asdict(tplan.report))
    assert jd.plan_digest(jplan, 8) == td.plan_digest(tplan, 8)
    # a dense-X plan measures float32 row densities, as the reference does
    jdense = je.plan(jnp.asarray(xd), jnp.asarray(yd))
    tdense = te.plan(torch.as_tensor(xd), torch.as_tensor(yd))
    assert tdense.row_density.dtype == jdense.row_density.dtype
    np.testing.assert_array_equal(tdense.row_density, jdense.row_density)
    assert _tasks_tuple(jdense.stq) == _tasks_tuple(tdense.stq)


def test_plan_cache_accounting_equal():
    """Two plans of one adjacency: both packages count the same hits and
    misses and charge the same bytes for the cached plans and densities."""
    rng = np.random.default_rng(4)
    jx, tx = _coo_pair(_rand_x(rng, 64, 64, 0.1))
    yd = _rand_x(rng, 64, 16, 0.5)
    je = JEngine(tile_m=16, tile_n=8)
    te = TEngine(tile_m=16, tile_n=8, device="cpu")
    for _ in range(2):
        je.plan(jx, jnp.asarray(yd))
        te.plan(tx, torch.as_tensor(yd))
    for k in ("plan_hits", "plan_misses", "struct_hits", "struct_misses",
              "analyzes"):
        assert getattr(je.cache.stats, k) == getattr(te.cache.stats, k), k
    assert len(je.cache) == len(te.cache)
    assert je.cache.bytes_used == te.cache.bytes_used


@pytest.mark.parametrize("chunk", [7, 1_000_000])
def test_coo_spdmm_matches_reference(chunk):
    """The non-literal engine's COO aggregation, whole and chunked over
    edges, against the reference's ``lax.scan`` version."""
    from repro.core import primitives as jprim
    from repro_torch.core import primitives as tprim
    rng = np.random.default_rng(8)
    jx, tx = _coo_pair(_rand_x(rng, 40, 30, 0.2))
    h = rng.normal(size=(30, 6)).astype(np.float32)
    want = np.asarray(jprim.coo_spdmm(jx.rows, jx.cols, jx.vals,
                                      jnp.asarray(h), n_rows=40, chunk=chunk))
    got = tprim.coo_spdmm(tx.rows, tx.cols, tx.vals, torch.as_tensor(h),
                          n_rows=40, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_drift_replan_equal():
    """A plan hit whose Y-density sketch drifted past the threshold is
    re-planned, and both packages count and decide it the same way."""
    rng = np.random.default_rng(6)
    jx, tx = _coo_pair(_rand_x(rng, 64, 64, 0.1))
    ys = [_rand_x(rng, 64, 16, d) for d in (0.9, 0.9, 0.05)]
    je = JEngine(tile_m=16, tile_n=8, drift_threshold=0.2)
    te = TEngine(tile_m=16, tile_n=8, drift_threshold=0.2, device="cpu")
    for yd in ys:
        jp = je.plan(jx, jnp.asarray(yd))
        tp = te.plan(tx, torch.as_tensor(yd))
        assert _tasks_tuple(jp.stq + jp.dtq) == _tasks_tuple(tp.stq + tp.dtq)
    assert te.cache.stats.replans == je.cache.stats.replans == 1
    assert te.cache.stats.plan_hits == je.cache.stats.plan_hits == 1
