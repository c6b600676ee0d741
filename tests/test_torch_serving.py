"""The port's serving subsystem on the CPU: per-request results of a
micro-batch equal the reference's ServingEngine within 1e-4 for all four
models at max_batch 1 and 4, with equal ``dispatch_stats()`` counters on
the keys both fill; and every case of ``tests/test_serving.py`` —
coalescing, per-request stats, padding, single-plan serving, drift
replanning, the compiled path, the degradation of malformed requests and
``run_serving`` — against the port's own ``run_reference``."""
import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DynasparseEngine as JEngine, SparseCOO as JCOO
from repro.core import dispatch as jdispatch
from repro.models import gnn as jgnn
from repro.serving import (ServingConfig as JConfig,
                           ServingEngine as JServing,
                           SharedPlanCache as JShared)
from repro_torch.core import DynasparseEngine, SparseCOO
from repro_torch.core import dispatch as tdispatch
from repro_torch.core.plancache import PlanCache, StructureEntry
from repro_torch.models import gnn
from repro_torch.serving import (ServingConfig, ServingEngine, SharedPlanCache,
                                 SketchConfig)

RNG = np.random.default_rng(7)
CPU = "cpu"
TOL = dict(rtol=1e-3, atol=1e-3)       # the reference test's tolerance
PARITY = dict(rtol=1e-4, atol=1e-4)    # port vs reference, f32


def _arrays(n, nnz, seed):
    rng = np.random.default_rng(seed)
    flat = np.sort(rng.choice(n * n, size=nnz, replace=False))
    return ((flat // n).astype(np.int32), (flat % n).astype(np.int32),
            np.abs(rng.normal(size=nnz)).astype(np.float32))


def _rand_graph(n=80, nnz=240, seed=5):
    r, c, v = _arrays(n, nnz, seed)
    return SparseCOO((n, n), torch.as_tensor(r), torch.as_tensor(c),
                     torch.as_tensor(v), tag="adjacency")


def _params(model, i, h, o):
    return gnn.init_params(model, i, h, o, device=CPU)


def _serving(model, params, *, max_batch=4, literal=True,
             drift=0.25, cache=None, pad=True):
    eng = DynasparseEngine(tile_m=16, tile_n=8, literal=literal,
                           cache=cache if cache is not None
                           else SharedPlanCache(device=CPU), device=CPU)
    cfg = ServingConfig(max_batch=max_batch,
                        sketch=SketchConfig(threshold=drift),
                        pad_to_max_batch=pad)
    return ServingEngine(model, params, engine=eng, config=cfg)


def _ref(model, adj, h, params):
    return gnn.run_reference(model, adj, torch.as_tensor(h), params).numpy()


# --------------------------------------------------- parity with the JAX side
@pytest.mark.parametrize("max_batch", [1, 4])
@pytest.mark.parametrize("model", gnn.MODELS)
def test_per_request_results_and_counters_equal_reference(model, max_batch):
    # the executor-signature registries are process-wide: an earlier test's
    # traces would count as hits on one side only
    jdispatch.reset_trace_registry()
    tdispatch.reset_trace_registry()
    r, c, v = _arrays(80, 240, 5)
    jadj = JCOO((80, 80), jnp.asarray(r), jnp.asarray(c), jnp.asarray(v),
                tag="adjacency")
    tadj = _rand_graph()
    jp = jgnn.init_params(model, 12, 8, 5)
    feats = [np.random.default_rng(100 + i).normal(size=(80, 12))
             .astype(np.float32) for i in range(6)]
    js = JServing(model, jp, engine=JEngine(tile_m=16, tile_n=8, literal=True,
                                            cache=JShared()),
                  config=JConfig(max_batch=max_batch))
    ts = _serving(model, gnn.params_from_jax(jp, CPU), max_batch=max_batch)
    try:
        js.register_graph("g", jadj)
        ts.register_graph("g", tadj)
        jouts = js.serve(("g", h) for h in feats)
        touts = ts.serve(("g", h) for h in feats)
    finally:
        js.close()
        ts.close()
    for jz, tz in zip(jouts, touts):
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **PARITY)
    jd, td = js.dispatch_stats(), ts.dispatch_stats()
    shared = set(jd) & set(td) - {"health"}
    assert {"plans", "dispatch_builds", "trace_cache_hits", "act_builds",
            "compiled_batches", "calib_builds"} <= shared
    assert {k: td[k] for k in shared} == {k: jd[k] for k in shared}
    assert td["health"]["hosts"].keys() == jd["health"]["hosts"].keys()
    assert ts.stats.as_dict().keys() == js.stats.as_dict().keys()
    for k in ("requests", "batches", "compiled_batches", "errors"):
        assert ts.stats.as_dict()[k] == js.stats.as_dict()[k], k


@pytest.mark.parametrize("config", [
    ServingConfig(n_devices=2), ServingConfig(operand_sharding="replicate")])
def test_multi_device_serving_comes_later(config):
    """The mesh knobs of ``ServingConfig`` beside a caller's engine, as in
    the reference: ``n_devices`` must match the engine's mesh, and
    ``operand_sharding`` is ignored without ``n_devices`` (the engine keeps
    its own)."""
    eng = DynasparseEngine(device=CPU)
    if config.n_devices is not None:
        with pytest.raises(ValueError, match="conflicts"):
            ServingEngine("GCN", _params("GCN", 12, 8, 5), engine=eng,
                          config=config)
        return
    srv = ServingEngine("GCN", _params("GCN", 12, 8, 5), engine=eng,
                        config=config)
    assert srv.engine is eng and srv.engine.mesh is None
    assert srv.dispatch_stats()["operand_sharding"] == "halo"
    srv.close()


# ------------------------------------------------------------ equivalence
@pytest.mark.parametrize("model", gnn.MODELS)
def test_micro_batched_matches_per_request_reference(model):
    adj = _rand_graph()
    params = _params(model, 12, 8, 5)
    srv = _serving(model, params, max_batch=4)
    srv.register_graph("g", adj)
    batches = [RNG.normal(size=(80, 12)).astype(np.float32)
               for _ in range(6)]
    outs = srv.serve(("g", h) for h in batches)
    assert srv.stats.batches < len(batches)
    for h, z in zip(batches, outs):
        np.testing.assert_allclose(z.numpy(), _ref(model, adj, h, params),
                                   **TOL)
    srv.close()


def test_coalescing_respects_max_batch_and_records_stats():
    adj = _rand_graph(seed=9)
    srv = _serving("GCN", _params("GCN", 12, 8, 5), max_batch=4)
    srv.register_graph("g", adj)
    srv.serve(("g", RNG.normal(size=(80, 12)).astype(np.float32))
              for _ in range(10))
    stats = srv.stats
    assert len(stats.requests) == 10
    assert stats.batches == 3
    assert sorted(r.batch_size for r in stats.requests) == [2, 2] + [4] * 8
    assert all(r.latency >= r.t_queue >= 0.0 for r in stats.requests)
    assert all(r.report is not None for r in stats.requests)
    assert max(r.queue_depth for r in stats.requests) > 0
    pct = stats.latency_percentiles()
    assert pct["p95"] >= pct["p50"] > 0.0
    srv.close()


def test_one_plan_execute_pass_per_micro_batch():
    adj = _rand_graph(seed=3)
    srv = _serving("GCN", _params("GCN", 12, 8, 8), max_batch=8)
    srv.register_graph("g", adj)
    srv.serve(("g", RNG.normal(size=(80, 12)).astype(np.float32))
              for _ in range(8))
    assert srv.stats.batches == 1
    assert len(srv.stats.requests[0].report.kernels) == 4
    srv.close()


def test_multi_graph_requests_do_not_mix():
    adj_a, adj_b = _rand_graph(seed=1), _rand_graph(seed=2)
    params = _params("GCN", 12, 8, 5)
    cache = SharedPlanCache(device=CPU)
    srv = _serving("GCN", params, max_batch=4, cache=cache)
    srv.register_graph("a", adj_a)
    srv.register_graph("b", adj_b)
    h = RNG.normal(size=(80, 12)).astype(np.float32)
    outs = srv.serve([("a", h), ("b", h), ("a", h)])
    np.testing.assert_allclose(outs[0].numpy(), _ref("GCN", adj_a, h, params),
                               **TOL)
    np.testing.assert_allclose(outs[1].numpy(), _ref("GCN", adj_b, h, params),
                               **TOL)
    np.testing.assert_allclose(outs[0].numpy(), outs[2].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert set(cache.graphs) == {"a", "b"}
    srv.close()


def test_partial_batch_padding_matches_reference():
    adj = _rand_graph(seed=13)
    params = _params("GCN", 12, 8, 5)
    srv = _serving("GCN", params, max_batch=8)
    srv.register_graph("g", adj)
    batches = [RNG.normal(size=(80, 12)).astype(np.float32)
               for _ in range(3)]
    outs = srv.serve(("g", h) for h in batches)
    assert srv.stats.batches == 1
    assert [r.batch_size for r in srv.stats.requests] == [3, 3, 3]
    for h, z in zip(batches, outs):
        assert tuple(z.shape) == (80, 5)
        np.testing.assert_allclose(z.numpy(), _ref("GCN", adj, h, params),
                                   **TOL)
    srv.close()


def test_single_plan_across_batch_sizes():
    adj = _rand_graph(seed=14)
    params = _params("GCN", 12, 8, 5)
    cache = SharedPlanCache(device=CPU)
    srv = _serving("GCN", params, max_batch=4, cache=cache)
    srv.register_graph("g", adj)
    h = RNG.normal(size=(80, 12)).astype(np.float32)
    ref = _ref("GCN", adj, h, params)
    for k in (1, 2, 3, 4):
        for z in srv.serve([("g", h)] * k):
            np.testing.assert_allclose(z.numpy(), ref, **TOL)
    assert cache.plan_count() == 2

    cache2 = SharedPlanCache(device=CPU)
    srv2 = _serving("GCN", params, max_batch=4, cache=cache2, pad=False)
    srv2.register_graph("g", adj)
    for k in (1, 2, 3, 4):
        srv2.serve([("g", h)] * k)
    assert cache2.plan_count() == 2 * 4
    srv.close()
    srv2.close()


def test_padded_partial_batches_do_not_thrash_replanner():
    adj = _rand_graph(seed=19)
    cache = SharedPlanCache(device=CPU)
    srv = _serving("GCN", _params("GCN", 12, 8, 5), max_batch=4, cache=cache)
    srv.register_graph("g", adj)
    h = RNG.normal(size=(80, 12)).astype(np.float32)
    for k in (4, 1, 4, 1, 4):
        srv.serve([("g", h)] * k)
    assert cache.stats.replans == 0
    assert cache.plan_count() == 2
    srv.close()


def test_serve_inside_running_loop():
    adj = _rand_graph(seed=15)
    params = _params("GCN", 12, 8, 5)
    srv = _serving("GCN", params, max_batch=2)
    srv.register_graph("g", adj)
    h = RNG.normal(size=(80, 12)).astype(np.float32)

    async def main():
        return srv.serve([("g", h), ("g", h)])

    outs = asyncio.run(main())
    assert len(outs) == 2
    for z in outs:
        np.testing.assert_allclose(z.numpy(), _ref("GCN", adj, h, params),
                                   **TOL)
    srv.close()


def test_failed_requests_recorded_in_stats():
    adj = _rand_graph(seed=16)
    params = _params("GCN", 12, 8, 5)
    srv = _serving("GCN", params, max_batch=2)
    srv.register_graph("g", adj)
    h_a = RNG.normal(size=(80, 12)).astype(np.float32)
    h_b = RNG.normal(size=(80, 13)).astype(np.float32)   # wrong fan-in
    with pytest.raises(ValueError):
        srv.serve([("g", h_a), ("g", h_b)])
    assert len(srv.stats.requests) == 2
    assert srv.stats.bisections >= 1
    assert srv.stats.errors == 1
    assert srv.stats.quarantined == 1
    bad = [r for r in srv.stats.requests if r.error is not None]
    assert len(bad) == 1 and bad[0].batch_size == 1
    good = [r for r in srv.stats.requests if r.error is None]
    assert len(good) == 1 and good[0].report is not None
    assert srv.stats.as_dict()["errors"] == 1
    outs = srv.serve([("g", h_a), ("g", h_b)], return_exceptions=True)
    assert not isinstance(outs[0], Exception)
    assert isinstance(outs[1], Exception)
    np.testing.assert_allclose(outs[0].numpy(), _ref("GCN", adj, h_a, params),
                               **TOL)
    srv.close()


def test_error_escaping_dispatch_fails_batch_instead_of_hanging():
    adj = _rand_graph(seed=22)
    srv = _serving("GCN", _params("GCN", 12, 8, 5), max_batch=2)
    srv.register_graph("g", adj)
    h_a = RNG.normal(size=(80, 12)).astype(np.float32)
    h_b = RNG.normal(size=(96, 12)).astype(np.float32)  # wrong row count
    with pytest.raises(Exception):
        srv.serve([("g", h_a), ("g", h_b)])
    assert len(srv.stats.requests) == 2
    assert srv.stats.errors == 1
    assert srv.stats.quarantined == 1
    assert len(srv.stats.batch_reports) == 1
    srv.close()


def test_serve_after_close_raises_instead_of_hanging():
    adj = _rand_graph(seed=23)
    srv = _serving("GCN", _params("GCN", 12, 8, 5), max_batch=2)
    srv.register_graph("g", adj)
    srv.close()
    with pytest.raises(RuntimeError):
        srv.serve([("g", RNG.normal(size=(80, 12)).astype(np.float32))])
    assert srv.stats.errors == 1


def test_per_request_report_attribution():
    adj = _rand_graph(seed=17)
    srv = _serving("GCN", _params("GCN", 12, 8, 5), max_batch=4)
    srv.register_graph("g", adj)
    srv.serve(("g", RNG.normal(size=(80, 12)).astype(np.float32))
              for _ in range(4))
    assert srv.stats.batches == 1
    assert len(srv.stats.batch_reports) == 1
    batch_rep = srv.stats.batch_reports[0]
    assert batch_rep.hardware_time > 0.0
    for r in srv.stats.requests:
        assert r.report.hardware_time == pytest.approx(
            batch_rep.hardware_time / 4)
        assert r.report.total.flops_executed == pytest.approx(
            batch_rep.total.flops_executed / 4)
        assert len(r.report.kernels) == len(batch_rep.kernels) == 4
    assert sum(r.report.hardware_time for r in srv.stats.requests) == (
        pytest.approx(batch_rep.hardware_time))
    srv.close()


def test_unregistered_graph_raises():
    srv = _serving("GCN", _params("GCN", 12, 8, 5))
    with pytest.raises(KeyError, match="not registered"):
        asyncio.run(srv.infer("nope", np.zeros((4, 12), np.float32)))
    srv.close()


def test_dispatch_error_fails_requests_instead_of_hanging():
    adj = _rand_graph(seed=4)
    srv = _serving("GCN", _params("GCN", 10, 8, 5), max_batch=2)
    srv.register_graph("g", adj)
    bad = RNG.normal(size=(80, 7)).astype(np.float32)   # fan-in mismatch
    with pytest.raises(ValueError):
        srv.serve([("g", bad), ("g", bad)])
    srv.close()


def test_run_serving_restores_engine_drift_settings():
    adj = _rand_graph(seed=5)
    params = _params("SGC", 10, 8, 8)
    eng = DynasparseEngine(tile_m=16, tile_n=8, device=CPU)
    assert eng.drift_threshold is None
    gnn.run_serving("SGC", eng, adj,
                    [RNG.normal(size=(80, 10)).astype(np.float32)], params,
                    device=CPU)
    assert eng.drift_threshold is None


# ------------------------------------------------- compiled-dispatch path
def test_compiled_serving_steady_state_stats_and_results():
    adj = _rand_graph(seed=31)
    params = _params("GCN", 12, 8, 5)
    srv = _serving("GCN", params, max_batch=4)
    srv.register_graph("g", adj)
    batches = [RNG.normal(size=(80, 12)).astype(np.float32)
               for _ in range(16)]
    outs = srv.serve(("g", h) for h in batches)
    ds = srv.dispatch_stats()
    assert srv.stats.compiled_batches == srv.stats.batches - 1
    assert ds["dispatch_builds"] == ds["plans"]
    assert ds["replans"] == 0
    assert ds["trace_cache_hits"] > 0
    assert ds["trace_cache_hits"] >= srv.stats.compiled_batches - 1
    for h, z in zip(batches, outs):
        np.testing.assert_allclose(z.numpy(), _ref("GCN", adj, h, params),
                                   **TOL)
    srv.close()


def test_compile_models_off_keeps_eager_path():
    adj = _rand_graph(seed=32)
    params = _params("GCN", 12, 8, 5)
    eng = DynasparseEngine(tile_m=16, tile_n=8, literal=True,
                           cache=SharedPlanCache(device=CPU), device=CPU)
    srv = ServingEngine("GCN", params, engine=eng,
                        config=ServingConfig(max_batch=4,
                                             compile_models=False))
    srv.register_graph("g", adj)
    h = RNG.normal(size=(80, 12)).astype(np.float32)
    outs = srv.serve([("g", h)] * 8)
    assert srv.stats.compiled_batches == 0
    for z in outs:
        np.testing.assert_allclose(z.numpy(), _ref("GCN", adj, h, params),
                                   **TOL)
    srv.close()


def test_compiled_drift_invalidation_recompiles():
    adj = _rand_graph(seed=33)
    params = _params("GCN", 12, 8, 5)
    cache = SharedPlanCache(device=CPU)
    srv = _serving("GCN", params, max_batch=1, cache=cache)
    srv.register_graph("g", adj)
    sparse_h = (RNG.normal(size=(80, 12)) *
                (RNG.uniform(size=(80, 12)) < 0.03)).astype(np.float32)
    dense_h = RNG.normal(size=(80, 12)).astype(np.float32)
    outs = srv.serve([("g", sparse_h), ("g", sparse_h),
                      ("g", dense_h), ("g", dense_h)])
    assert srv.stats.compile_invalidations >= 1
    assert cache.stats.replans > 0
    for z in outs[2:]:
        np.testing.assert_allclose(z.numpy(),
                                   _ref("GCN", adj, dense_h, params), **TOL)
    srv.close()


def test_reregistered_graph_drops_stale_compiled_program():
    adj_a, adj_b = _rand_graph(seed=41), _rand_graph(seed=42)
    params = _params("GCN", 12, 8, 5)
    srv = _serving("GCN", params, max_batch=2)
    srv.register_graph("g", adj_a)
    h = RNG.normal(size=(80, 12)).astype(np.float32)
    srv.serve([("g", h)] * 4)
    assert srv.stats.compiled_batches >= 1
    srv.register_graph("g", adj_b)
    outs = srv.serve([("g", h)] * 2)
    for z in outs:
        np.testing.assert_allclose(z.numpy(), _ref("GCN", adj_b, h, params),
                                   **TOL)
    srv.close()


def test_graph_scale_sparse_only_serving_never_densifies():
    adj = _rand_graph(seed=34, n=96, nnz=200)
    params = _params("GCN", 12, 8, 5)
    cache = SharedPlanCache(device=CPU)
    eng = DynasparseEngine(tile_m=16, tile_n=8, literal=True,
                           mode="sparse_only", cache=cache, device=CPU)
    srv = ServingEngine("GCN", params, engine=eng,
                        config=ServingConfig(max_batch=4))
    srv.register_graph("g", adj)
    batches = [RNG.normal(size=(96, 12)).astype(np.float32)
               for _ in range(8)]
    outs = srv.serve(("g", h) for h in batches)
    assert srv.stats.compiled_batches >= 1
    entries = [v for (kind, _k), v in cache.items()
               if kind == PlanCache._STRUCT]
    assert entries, "expected packed structure entries"
    assert all(isinstance(e, StructureEntry) and e.dense is None
               for e in entries)
    for h, z in zip(batches, outs):
        np.testing.assert_allclose(z.numpy(), _ref("GCN", adj, h, params),
                                   **TOL)
    srv.close()


# ------------------------------------------------------- density drift
def test_density_drift_triggers_replan_and_matches_reference():
    adj = _rand_graph(seed=11)
    params = _params("GCN", 12, 8, 5)
    cache = SharedPlanCache(device=CPU)
    srv = _serving("GCN", params, max_batch=1, cache=cache)
    srv.register_graph("g", adj)
    sparse_h = (RNG.normal(size=(80, 12)) *
                (RNG.uniform(size=(80, 12)) < 0.03)).astype(np.float32)
    dense_h = RNG.normal(size=(80, 12)).astype(np.float32)
    outs = srv.serve([("g", sparse_h), ("g", sparse_h), ("g", dense_h)])
    assert cache.stats.replans > 0
    np.testing.assert_allclose(outs[2].numpy(),
                               _ref("GCN", adj, dense_h, params), **TOL)
    srv.close()


def test_no_drift_no_replan():
    adj = _rand_graph(seed=12)
    cache = SharedPlanCache(device=CPU)
    srv = _serving("GCN", _params("GCN", 12, 8, 5), max_batch=1, cache=cache)
    srv.register_graph("g", adj)
    h = RNG.normal(size=(80, 12)).astype(np.float32)
    srv.serve([("g", h), ("g", h), ("g", h)])
    assert cache.stats.replans == 0
    assert cache.stats.plan_hits > 0
    srv.close()


# ------------------------------------------------------- wrapper contract
def test_run_serving_wrapper_per_request_and_micro_batched():
    adj = _rand_graph(seed=21)
    params = _params("SGC", 10, 8, 8)
    batches = [RNG.normal(size=(80, 10)).astype(np.float32)
               for _ in range(4)]
    outs1, reports1 = gnn.run_serving(
        "SGC", DynasparseEngine(tile_m=16, tile_n=8, device=CPU), adj,
        batches, params, device=CPU)
    outs4, reports4 = gnn.run_serving(
        "SGC", DynasparseEngine(tile_m=16, tile_n=8, device=CPU), adj,
        batches, params, max_batch=4, device=CPU)
    assert len(outs1) == len(outs4) == len(reports1) == len(reports4) == 4
    for h, z1, z4 in zip(batches, outs1, outs4):
        ref = _ref("SGC", adj, h, params)
        np.testing.assert_allclose(z1.numpy(), ref, **TOL)
        np.testing.assert_allclose(z4.numpy(), ref, **TOL)
    assert reports4[0] is reports4[3]
    assert reports1[0] is not reports1[3]


@pytest.mark.parametrize("model", gnn.MODELS)
def test_run_inference_takes_numpy_features(model):
    """Features handed over as a numpy array (as serving requests arrive)
    give the tensor's logits bit for bit — GIN adds ``h`` itself to its
    aggregation, which failed on a numpy ``h``."""
    adj = _rand_graph(seed=43)
    params = _params(model, 12, 8, 5)
    h = RNG.normal(size=(80, 12)).astype(np.float32)
    eng = DynasparseEngine(tile_m=16, tile_n=8, literal=True, device=CPU)
    z_np, _ = gnn.run_inference(model, eng, adj, h, params, device=CPU)
    z_t, _ = gnn.run_inference(model, eng, adj, torch.as_tensor(h), params,
                               device=CPU)
    assert torch.equal(z_np, z_t)


def test_run_serving_refuses_another_device():
    with pytest.raises(ValueError, match="engine on cpu"):
        gnn.run_serving("SGC", DynasparseEngine(device=CPU),
                        _rand_graph(), [], _params("SGC", 10, 8, 8),
                        device="meta")
