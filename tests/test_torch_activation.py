"""The port's activation block-skip route on the CPU, against the JAX
package on the same numpy inputs (Pallas interpret mode on the JAX side):
the device packer's outputs and the ActivationDispatch descriptor arrays
equal the reference's exactly, the route's result agrees with the
reference's within 1e-4 and is bitwise equal to the port's own eager
batched and per-task paths, overflow takes the dense ``gemm`` result, one
dispatch serves every sparsity within budget, and the cache counters move
as the reference's do.  Ports the kernel- and model-level cases of
``tests/test_activation_skip.py``."""
import dataclasses

import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import DynasparseEngine as JEngine
from repro.core import dispatch as jd
from repro.kernels import ops as jops
from repro.models import gnn as jgnn
from repro_torch.core import DynasparseEngine as TEngine, SparseCOO as TCOO
from repro_torch.core import dispatch as td
from repro_torch.core.scheduler import execute_plan
from repro_torch.kernels import ops as tops
from repro_torch.models import gnn as tgnn

TOL = dict(rtol=1e-4, atol=1e-4)   # f32, another summation order
REF_KEYS = ("gemm_rows", "gemm_cols", "asp_a_ids", "asp_out_cols",
            "asp_base_rows", "amm_a_ids", "amm_y_cols", "amm_base_rows")


def _block_sparse(rng, m, k, block_density, *, block=8):
    nrb, ncb = -(-m // block), -(-k // block)
    mask = (rng.uniform(size=(nrb, ncb)) < block_density).astype(np.float32)
    full = rng.normal(size=(nrb * block, ncb * block))
    return (full * np.kron(mask, np.ones((block, block))))[:m, :k].astype(
        np.float32)


def _engines(tm, tn, eps=0.0):
    return (JEngine(tile_m=tm, tile_n=tn, literal=True, eps=eps),
            TEngine(tile_m=tm, tile_n=tn, literal=True, eps=eps,
                    device="cpu"))


def _tasks(plan):
    return ([(t.i, t.j, t.primitive) for t in plan.stq],
            [(t.i, t.j) for t in plan.dtq])


def _assert_dispatch_equal(jad, tad):
    assert dataclasses.asdict(jad.geom) == dataclasses.asdict(tad.geom)
    assert jad.fingerprint == tad.fingerprint
    assert set(tad.arrays) == set(jad.arrays) | {"act_caps"}
    for k in jad.arrays:
        np.testing.assert_array_equal(tad.arrays[k].numpy(),
                                      np.asarray(jad.arrays[k]), err_msg=k)
    np.testing.assert_array_equal(tad.arrays["act_caps"].numpy(),
                                  tad.geom.cap_vec)


def _both_routes(xd, yd, tm, tn, *, eps=0.0, capacity=None, x_t=None):
    """Plan + activation dispatch + route result in both packages, and the
    port's eager batched and per-task results."""
    je, te = _engines(tm, tn, eps)
    x_t = torch.as_tensor(xd) if x_t is None else x_t
    y_t = torch.as_tensor(yd)
    jplan = je.plan(xd, jnp.asarray(yd))
    tplan = te.plan(x_t, y_t)
    assert _tasks(tplan) == _tasks(jplan)
    jad = je.activation_dispatch_for(jplan, xd, capacity=capacity)
    tad = te.activation_dispatch_for(tplan, x_t, capacity=capacity)
    assert (jad is None) == (tad is None)
    if tad is None:
        return None
    _assert_dispatch_equal(jad, tad)
    jz, jdiag = jd.execute_activation(jad, xd, yd, interpret=True)
    tz, tdiag = td.execute_activation(tad, x_t, y_t, stats=te.cache.stats)
    for k in ("stored", "capacity", "logical", "overflow"):
        assert int(tdiag[k]) == int(jdiag[k]), k
    z_b = execute_plan(tplan.part, tplan.stq, tplan.dtq, x_t, y_t,
                       batched=True, eps=eps)
    z_p = execute_plan(tplan.part, tplan.stq, tplan.dtq, x_t, y_t,
                       batched=False, eps=eps)
    return te, tplan, tad, tz, tdiag, np.asarray(jz), z_b, z_p


# ------------------------------------------------------------ the packer
@pytest.mark.parametrize("capacity,eps", [(5, 0.0), ((3, 6, 2, 9), 0.0),
                                          ((1, 1, 1, 1), 0.0), (4, 0.3)])
def test_packer_outputs_equal_reference(capacity, eps):
    rng = np.random.default_rng(51)
    x = _block_sparse(rng, 60, 30, 0.3)
    x[x != 0] += 0.05 * np.sign(x[x != 0])
    kw = dict(block=8, n_stripes=4, slot_rows=2, n_block_cols=4,
              capacity=np.asarray(capacity), eps=eps)
    want = jops.pack_activation_stripes(x, **kw)
    got = tops.pack_activation_stripes(torch.as_tensor(x), **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_packer_filler_and_padding_blocks_are_positive_zero():
    """Filler and padding slots are exact +0 blocks, never -0."""
    x = -np.abs(_block_sparse(np.random.default_rng(2), 32, 16, 0.5))
    x[x == 0] = -0.0
    pool = tops.pack_activation_stripes(
        torch.as_tensor(x), block=8, n_stripes=2, slot_rows=2,
        n_block_cols=2, capacity=6)[0].numpy()
    empty = ~np.any(pool != 0, axis=(1, 2))
    assert empty.any() and not np.signbit(pool[empty]).any()


# ----------------------------------------------------------- kernel level
@pytest.mark.parametrize("tm,tn,mkn,bd,eps,seed", [
    (32, 24, (90, 64, 44), 0.12, 0.0, 1),    # ragged rows, mixed primitives
    (32, 24, (90, 64, 44), 0.12, 0.1, 2),    # eps-thresholded packing
    (16, 8, (40, 32, 20), 0.50, 0.0, 3),     # ragged both axes
    (8, 16, (24, 16, 33), 0.40, 0.0, 4),     # ragged col tail
    (16, 8, (48, 32, 8), 0.05, 0.0, 5),      # nearly empty stripes (fillers)
])
def test_activation_route_matches_reference_and_eager_paths(tm, tn, mkn, bd,
                                                            eps, seed):
    M, K, N = mkn
    rng = np.random.default_rng(seed)
    xd = _block_sparse(rng, M, K, bd)
    yd = (rng.normal(size=(K, N)) *
          (rng.uniform(size=(K, N)) < 0.5)).astype(np.float32)
    out = _both_routes(xd, yd, tm, tn, eps=eps)
    if out is None:
        pytest.skip("plan routed no sparse tasks")
    _, _, _, tz, tdiag, jz, z_b, z_p = out
    assert not bool(tdiag["overflow"])
    np.testing.assert_allclose(tz.numpy(), jz, **TOL)
    assert torch.equal(tz, z_b) and torch.equal(tz, z_p)
    if eps == 0.0:
        np.testing.assert_allclose(tz.numpy(), xd @ yd, **TOL)


def test_activation_route_skips_blocks():
    rng = np.random.default_rng(11)
    xd = _block_sparse(rng, 96, 64, 0.25)
    yd = rng.normal(size=(64, 16)).astype(np.float32)
    _, _, _, tz, diag, jz, z_b, _ = _both_routes(xd, yd, 32, 8)
    assert int(diag["stored"]) < int(diag["logical"])
    assert int(diag["stored"]) <= int(diag["capacity"])
    assert torch.equal(tz, z_b)
    np.testing.assert_allclose(tz.numpy(), jz, **TOL)


def test_activation_route_bfloat16():
    """A bfloat16 activation: the pool is widened to float32 before the
    fused kernels (exact), as the reference's jnp.dot(bf16, f32) promotes."""
    rng = np.random.default_rng(13)
    xd = _block_sparse(rng, 64, 32, 0.4).astype(ml_dtypes.bfloat16)
    yd = rng.normal(size=(32, 16)).astype(np.float32)
    x_t = torch.as_tensor(xd.astype(np.float32)).to(torch.bfloat16)
    out = _both_routes(xd, yd, 16, 8, x_t=x_t)
    if out is None:
        pytest.skip("plan routed no sparse tasks")
    _, _, _, tz, _, jz, z_b, z_p = out
    assert torch.equal(tz, z_b) and torch.equal(tz, z_p)
    np.testing.assert_allclose(tz.numpy(), jz, **TOL)


def test_capacity_exact_and_overflow_fallback():
    """Exact need: bitwise the eager batched path; one slot short: the
    overflow flag is raised and the result is the dense gemm's bitwise."""
    rng = np.random.default_rng(17)
    xd = _block_sparse(rng, 64, 48, 0.35)
    yd = rng.normal(size=(48, 16)).astype(np.float32)
    je, te = _engines(16, 8)
    tplan = te.plan(torch.as_tensor(xd), torch.as_tensor(yd))
    jplan = je.plan(xd, jnp.asarray(yd))
    need = td.activation_capacity(torch.as_tensor(xd), tplan.part, te.block,
                                  slack=1.0)
    assert need == jd.activation_capacity(xd, jplan.part, je.block,
                                          slack=1.0) and need > 1
    _, _, tad, tz, diag, jz, z_b, _ = _both_routes(xd, yd, 16, 8,
                                                   capacity=need)
    assert tad.geom.cap == need and not bool(diag["overflow"])
    assert torch.equal(tz, z_b)

    x_t, y_t = torch.as_tensor(xd), torch.as_tensor(yd)
    ad2 = te.activation_dispatch_for(tplan, x_t, capacity=need - 1)
    z_o, diag2 = td.execute_activation(ad2, x_t, y_t)
    assert bool(diag2["overflow"])
    assert torch.equal(z_o, tops.gemm(x_t, y_t, out_dtype=torch.float32))
    jad2 = je.activation_dispatch_for(jplan, xd, capacity=need - 1)
    jz_o, jdiag2 = jd.execute_activation(jad2, xd, yd, interpret=True)
    assert bool(jdiag2["overflow"])
    np.testing.assert_allclose(z_o.numpy(), np.asarray(jz_o), **TOL)


def test_one_dispatch_serves_varying_sparsity_within_budget():
    """One dispatch, three activation patterns: one executor signature
    (one trace in the reference), every result bitwise the eager path's,
    and the counters equal the reference's."""
    rng = np.random.default_rng(19)
    yd = rng.normal(size=(48, 16)).astype(np.float32)
    xs = [_block_sparse(rng, 64, 48, bd) for bd in (0.30, 0.18, 0.05)]
    je, te = _engines(16, 8)
    jd.reset_trace_registry()
    td.reset_trace_registry()
    jplan = je.plan(xs[0], jnp.asarray(yd))
    tplan = te.plan(torch.as_tensor(xs[0]), torch.as_tensor(yd))
    cap = td.activation_capacity(torch.as_tensor(xs[0]), tplan.part,
                                 te.block, slack=1.0)
    jad = je.activation_dispatch_for(jplan, xs[0], capacity=cap)
    tad = te.activation_dispatch_for(tplan, torch.as_tensor(xs[0]),
                                     capacity=cap)
    for xd in xs:
        jz, _ = jd.execute_activation(jad, xd, yd, interpret=True,
                                      stats=je.cache.stats)
        x_t = torch.as_tensor(xd)
        tz, diag = td.execute_activation(tad, x_t, torch.as_tensor(yd),
                                         stats=te.cache.stats)
        assert not bool(diag["overflow"])
        z_b = execute_plan(tplan.part, tplan.stq, tplan.dtq, x_t,
                           torch.as_tensor(yd))
        assert torch.equal(tz, z_b)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    for k in ("trace_builds", "trace_cache_hits", "act_builds", "act_hits"):
        assert getattr(te.cache.stats, k) == getattr(je.cache.stats, k), k
    assert te.cache.stats.trace_builds == 1


def test_descriptors_content_independent_across_activations():
    rng = np.random.default_rng(23)
    yd = torch.as_tensor(rng.normal(size=(32, 8)).astype(np.float32))
    te = TEngine(tile_m=16, tile_n=8, literal=True, device="cpu")
    x1 = _block_sparse(rng, 48, 32, 0.15)
    x2 = (x1 * 1.7).astype(np.float32)
    p1 = te.plan(torch.as_tensor(x1), yd)
    cap = td.activation_capacity(torch.as_tensor(x1), p1.part, te.block)
    a1 = te.activation_dispatch_for(p1, torch.as_tensor(x1), capacity=cap)
    p2 = te.plan(torch.as_tensor(x2), yd)
    a2 = te.activation_dispatch_for(p2, torch.as_tensor(x2), capacity=cap)
    assert a1 is not None and a1 is a2
    assert te.cache.stats.act_builds == 1 and te.cache.stats.act_hits == 1
    assert te.cache.activation_count() == 1


def test_dense_plans_and_sparse_x_decline_activation_route():
    rng = np.random.default_rng(29)
    xd = torch.as_tensor(rng.normal(size=(64, 32)).astype(np.float32))
    yd = torch.as_tensor(rng.normal(size=(32, 16)).astype(np.float32))
    te = TEngine(tile_m=16, tile_n=8, literal=True, device="cpu")
    plan = te.plan(xd, yd)
    assert not plan.stq
    assert te.activation_dispatch_for(plan, xd) is None
    adj = TCOO((64, 32), torch.tensor([0], dtype=torch.int32),
               torch.tensor([0], dtype=torch.int32), torch.tensor([1.0]),
               tag="adjacency")
    assert te.activation_dispatch_for(te.plan(adj, yd), adj) is None
    batched_off = TEngine(tile_m=16, tile_n=8, literal=True, batched=False,
                          device="cpu")
    x = torch.as_tensor(_block_sparse(rng, 64, 32, 0.1))
    assert batched_off.activation_dispatch_for(
        batched_off.plan(x, yd), x) is None


# ------------------------------------------- per-stripe capacity budgets
def _skewed_activation(rng, m=96, k=64, block=8):
    x = np.zeros((m, k), np.float32)
    x[:16] = rng.normal(size=(16, k)).astype(np.float32)
    x[16:] = _block_sparse(rng, m - 16, k, 0.06, block=block)
    return x


def test_per_stripe_budgets_equal_reference_and_cut_waste():
    rng = np.random.default_rng(57)
    xd = _skewed_activation(rng)
    yd = rng.normal(size=(64, 16)).astype(np.float32)
    je, te = _engines(16, 8)
    x_t, y_t = torch.as_tensor(xd), torch.as_tensor(yd)
    jplan, tplan = je.plan(xd, jnp.asarray(yd)), te.plan(x_t, y_t)
    np.testing.assert_array_equal(
        td.activation_budgets(x_t, tplan.part, te.block),
        jd.activation_budgets(xd, jplan.part, je.block))
    ad_u = te.activation_dispatch_for(tplan, x_t, per_stripe=False)
    ad_v = te.activation_dispatch_for(tplan, x_t, per_stripe=True)
    _assert_dispatch_equal(
        je.activation_dispatch_for(jplan, xd, per_stripe=True), ad_v)
    assert ad_u.geom.caps == () and ad_v.geom.caps != ()
    assert ad_v.geom.total_slots < ad_u.geom.total_slots
    z_u, diag_u = td.execute_activation(ad_u, x_t, y_t)
    z_v, diag_v = td.execute_activation(ad_v, x_t, y_t)
    assert not bool(diag_u["overflow"]) and not bool(diag_v["overflow"])
    z_b = execute_plan(tplan.part, tplan.stq, tplan.dtq, x_t, y_t)
    assert torch.equal(z_u, z_v) and torch.equal(z_v, z_b)
    stored = int(diag_v["stored"])
    waste_u = (diag_u["capacity"] - stored) / max(stored, 1)
    waste_v = (diag_v["capacity"] - stored) / max(stored, 1)
    assert waste_v <= 0.8 * waste_u, (waste_u, waste_v)


def test_per_stripe_budget_serves_jitter_without_overflow():
    rng = np.random.default_rng(59)
    xd = _skewed_activation(rng)
    y_t = torch.as_tensor(rng.normal(size=(64, 16)).astype(np.float32))
    te = TEngine(tile_m=16, tile_n=8, literal=True, device="cpu")
    plan = te.plan(torch.as_tensor(xd), y_t)
    ad = te.activation_dispatch_for(plan, torch.as_tensor(xd))
    builds0 = te.cache.stats.act_builds
    for i in range(3):
        xi = torch.as_tensor(
            (xd * (rng.uniform(size=xd.shape) < 0.9)).astype(np.float32))
        z, diag = td.execute_activation(ad, xi, y_t)
        assert not bool(diag["overflow"]), i
        assert torch.equal(z, execute_plan(plan.part, plan.stq, plan.dtq,
                                           xi, y_t))
        assert te.cache.stats.act_builds == builds0


# ------------------------------------------------------------ whole model
def _block_sparse_graph(rng, n=80, nnz=240):
    flat = np.sort(rng.choice(n * n, size=nnz, replace=False))
    rows = (flat // n).astype(np.int32)
    cols = (flat % n).astype(np.int32)
    vals = np.abs(rng.normal(size=nnz)).astype(np.float32)
    from repro.core import SparseCOO as JCOO
    return (JCOO((n, n), jnp.asarray(rows), jnp.asarray(cols),
                 jnp.asarray(vals), tag="adjacency"),
            TCOO((n, n), torch.as_tensor(rows), torch.as_tensor(cols),
                 torch.as_tensor(vals), tag="adjacency"))


def test_compile_model_uses_activation_route_and_matches():
    """A compiled GCN takes the block-skip route on at least one activation
    kernel, agrees with the reference's compiled program, and re-serves a
    sparser input of the same support with one program."""
    rng = np.random.default_rng(31)
    jadj, tadj = _block_sparse_graph(rng)
    h = _block_sparse(rng, 80, 12, 0.35)
    jp = jgnn.init_params("GCN", 12, 8, 5)
    tp = tgnn.params_from_jax(jp, "cpu")
    je, te = _engines(16, 8)
    jwarm, jcm = jgnn.compile_model("GCN", je, jadj, jnp.asarray(h), jp)
    twarm, tcm = tgnn.compile_model("GCN", te, tadj, torch.as_tensor(h), tp)
    assert tcm.n_act == jcm.n_act >= 1
    np.testing.assert_allclose(twarm.numpy(), np.asarray(jwarm), **TOL)
    h2 = (h * (rng.uniform(size=h.shape) < 0.7)).astype(np.float32)
    for hh in (h, h2):
        z = tcm(torch.as_tensor(hh))
        np.testing.assert_allclose(z.numpy(), np.asarray(jcm(jnp.asarray(hh))),
                                   **TOL)
        assert len(tcm.last_activation) == tcm.n_act
        for dt, dj in zip(tcm.last_activation, jcm.last_activation):
            for k in ("stored", "capacity", "logical", "overflow"):
                assert int(dt[k]) == int(dj[k]), k
    assert any(int(d["stored"]) < d["logical"] for d in tcm.last_activation)
    assert tcm.calls == 2 and tcm.traces == 1
    for k in ("trace_builds", "trace_cache_hits", "plan_hits", "act_hits",
              "act_builds"):
        assert getattr(te.cache.stats, k) == getattr(je.cache.stats, k), k


def test_compile_model_activation_skip_off_keeps_dense_route():
    rng = np.random.default_rng(37)
    _, tadj = _block_sparse_graph(rng)
    h = torch.as_tensor(_block_sparse(rng, 80, 12, 0.35))
    tp = tgnn.init_params("GCN", 12, 8, 5, device="cpu")
    te = TEngine(tile_m=16, tile_n=8, literal=True, device="cpu")
    warm, cm = tgnn.compile_model("GCN", te, tadj, h, tp,
                                  activation_skip=False)
    assert cm is not None and cm.n_act == 0
    z = cm(h)
    assert cm.last_activation == []
    # the dense route's gemm sums in the DTQ kernel's order: bitwise
    assert torch.equal(z, warm)
    ref = tgnn.run_reference("GCN", tadj, h, tp)
    np.testing.assert_allclose(z.numpy(), ref.numpy(), **TOL)


def test_compiled_model_credits_act_hits():
    rng = np.random.default_rng(61)
    _, tadj = _block_sparse_graph(rng)
    h = torch.as_tensor(_block_sparse(rng, 80, 12, 0.35))
    tp = tgnn.init_params("GCN", 12, 8, 5, device="cpu")
    te = TEngine(tile_m=16, tile_n=8, literal=True, device="cpu")
    _, cm = tgnn.compile_model("GCN", te, tadj, h, tp)
    assert cm is not None and cm.n_act >= 1
    hits0 = te.cache.stats.act_hits
    cm(h)
    cm(h)
    assert te.cache.stats.act_hits == hits0 + 2 * cm.n_act > 0
