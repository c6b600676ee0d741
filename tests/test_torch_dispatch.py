"""The port's compiled dispatch: descriptor arrays equal the JAX package's,
execution agrees with the JAX executor, the compiled path is bitwise equal
to the port's own eager batched drain, one wrapper call per primitive is
made as in the reference, and no output block is split over two runs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import DynasparseEngine as JEngine, SparseCOO as JCOO
from repro.core import dispatch as jd
from repro.kernels import ops as jops
from repro_torch.core import DynasparseEngine as TEngine, SparseCOO as TCOO
from repro_torch.core import dispatch as td
from repro_torch.core.scheduler import execute_plan
from repro_torch.kernels import formats as tf, ops as tops
from test_torch_kernels_cuda import INPLACE, inplace_against_padded

DESCRIPTORS = ("gemm_rows", "gemm_cols", "sp_a_ids", "sp_y_rows",
               "sp_out_rows", "sp_out_cols", "sp_first", "mm_a_ids",
               "mm_y_ids", "mm_out_rows", "mm_out_cols", "mm_first")


def _mixed_ragged():
    """The three-primitive ragged plan of tests/test_inplace_assembly.py:
    M=90 over tile_m=32 (extents 32/32/26), N=44 over tile_n=24 (24/20)."""
    rng = np.random.default_rng(1)
    xd = rng.normal(size=(90, 64)).astype(np.float32)
    xd[:32] *= (rng.uniform(size=(32, 64)) < 0.01)
    xd[32:64] *= (rng.uniform(size=(32, 64)) < 0.3)
    yd = rng.normal(size=(64, 44)).astype(np.float32)
    yd[:, :24] *= (rng.uniform(size=(64, 24)) < 0.05)
    r, c = np.nonzero(xd)
    rows, cols, vals = r.astype(np.int32), c.astype(np.int32), xd[r, c]
    jx = JCOO(xd.shape, jnp.asarray(rows), jnp.asarray(cols),
              jnp.asarray(vals), tag="adjacency")
    tx = TCOO(xd.shape, torch.as_tensor(rows), torch.as_tensor(cols),
              torch.as_tensor(vals), tag="adjacency")
    je = JEngine(tile_m=32, tile_n=24, literal=True)
    te = TEngine(tile_m=32, tile_n=24, literal=True, device="cpu")
    jplan = je.plan(jx, jnp.asarray(yd))
    tplan = te.plan(tx, torch.as_tensor(yd))
    return (je, jx, jplan), (te, tx, tplan), xd, yd


@pytest.fixture(scope="module")
def mixed():
    return _mixed_ragged()


def test_descriptor_arrays_equal_reference(mixed):
    (je, jx, jplan), (te, tx, tplan), _, _ = mixed
    prims = {t.primitive for t in tplan.stq + tplan.dtq}
    assert prims == {"GEMM", "SpDMM", "SpMM"}
    jdisp = je.dispatch_for(jplan, jx)
    tdisp = te.dispatch_for(tplan, tx)
    assert jdisp.geom.__dict__ == tdisp.geom.__dict__
    assert jdisp.fingerprint == tdisp.fingerprint
    assert set(jdisp.arrays) == set(tdisp.arrays)
    for k in DESCRIPTORS:
        t = tdisp.arrays[k]
        assert t.dtype == torch.int32, k
        np.testing.assert_array_equal(t.numpy(), np.asarray(jdisp.arrays[k]))
    for k in ("sp_pool", "mm_pool"):
        np.testing.assert_array_equal(tdisp.arrays[k].numpy(),
                                      np.asarray(jdisp.arrays[k]))
    assert (tdisp.n_entries, tdisp.n_triples) == (jdisp.n_entries,
                                                  jdisp.n_triples)


@pytest.mark.parametrize("prefix", ["sp", "mm"])
def test_each_output_block_is_one_run(mixed, prefix):
    """Runs come from key changes; no (out_row, out_col) key may open two
    runs, or two thread blocks would race on it on the card."""
    _, (te, tx, tplan), _, _ = mixed
    a = te.dispatch_for(tplan, tx).arrays
    orow = a[f"{prefix}_out_rows"].numpy().astype(np.int64)
    ocol = a[f"{prefix}_out_cols"].numpy().astype(np.int64)
    runs = tf.run_starts(a[f"{prefix}_out_rows"],
                         a[f"{prefix}_out_cols"]).numpy()
    keys = orow * (ocol.max() + 1) + ocol
    starts = runs[:-1]
    assert runs[-1] == len(keys) and np.all(np.diff(runs) > 0)
    assert len(np.unique(keys[starts])) == len(starts)
    for s, e in zip(runs[:-1], runs[1:]):
        assert np.all(keys[s:e] == keys[s])


def test_execute_dispatch_matches_reference(mixed):
    (je, jx, jplan), (te, tx, tplan), xd, yd = mixed
    jdisp, jxd = je.compiled_operands(jplan, jx)
    tdisp, txd = te.compiled_operands(tplan, tx)
    want = np.asarray(jd.execute_dispatch(jdisp, jxd, jnp.asarray(yd),
                                          interpret=True))
    got = td.execute_dispatch(tdisp, txd, torch.as_tensor(yd))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), xd @ yd, rtol=1e-4, atol=1e-4)


def test_compiled_equals_eager_batched_bitwise(mixed):
    _, (te, tx, tplan), xd, yd = mixed
    tdisp, txd = te.compiled_operands(tplan, tx)
    y = torch.as_tensor(yd)
    compiled = td.execute_dispatch(tdisp, txd, y)
    _, entry = te._packed_structure(tplan, tx)
    eager = execute_plan(tplan.part, tplan.stq, tplan.dtq,
                         torch.as_tensor(xd), y, block=8,
                         packed=entry.stripes)
    assert torch.equal(compiled, eager)


def test_wrapper_calls_per_dispatch_equal_reference(mixed):
    (je, jx, jplan), (te, tx, tplan), _, yd = mixed
    jdisp, jxd = je.compiled_operands(jplan, jx)
    tdisp, txd = te.compiled_operands(tplan, tx)
    n0 = jops.pallas_call_count()
    jd.apply_dispatch(jdisp.geom, jdisp.arrays, jxd, jnp.asarray(yd),
                      interpret=True)
    jcalls = jops.pallas_call_count() - n0
    tops.reset_kernel_call_count()
    td.apply_dispatch(tdisp.geom, tdisp.arrays, txd, torch.as_tensor(yd))
    assert tops.kernel_call_count() == jcalls == 3


def test_engine_cache_accounting_equals_reference():
    """Two literal matmuls of one adjacency: plan, structure, dispatch and
    executor-signature counters move the same way in both packages, and
    the densified operand is materialized only for the dense queue."""
    (je, jx, _), (te, tx, _), xd, yd = _mixed_ragged()
    jd.reset_trace_registry()
    td.reset_trace_registry()
    for _ in range(2):
        jz, _ = je.matmul(jx, jnp.asarray(yd))
        tz, _ = te.matmul(tx, torch.as_tensor(yd))
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz),
                                   rtol=1e-5, atol=1e-5)
    keys = ("plan_hits", "plan_misses", "packs", "dispatch_builds",
            "dispatch_hits", "trace_builds", "trace_cache_hits")
    assert ({k: getattr(te.cache.stats, k) for k in keys}
            == {k: getattr(je.cache.stats, k) for k in keys})
    assert te.cache.stats.dispatch_hits > 0


@pytest.mark.parametrize("case", list(INPLACE))
def test_inplace_sparse_body_equals_padded_body(case, monkeypatch):
    """An SpDMM-only kernel's in-place body (the plain version here, the
    kernel in ``test_torch_kernels_cuda.py``) is bitwise the padded
    ``apply_prepared`` body's result for a ragged last stripe (N = 500),
    N = 128, N = 7 (SN != tn), K and M that are not block multiples and a
    strided Y; a lowering that leaves an output block uncovered is not
    ``covered``, and a mixed GEMM + SpDMM plan keeps ``apply_prepared``."""
    got, a, y = inplace_against_padded(case, "cpu", monkeypatch)
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), a.astype(np.float64)
                               @ y.double().numpy(), rtol=1e-4, atol=1e-4)
