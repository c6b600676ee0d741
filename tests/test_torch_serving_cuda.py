"""Calibration and serving of the port on the card: requests submitted
while the first compiled batch captures its CUDA graph all resolve and
agree with single-request inference, a poison request fails alone with its
neighbours bitwise equal to a fault-free run, a plan-cache snapshot loads
back onto the card and replays bitwise, and calibration times the CUDA
kernels.  Every case needs a card and skips without one; this file imports
no JAX::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_serving_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import DynasparseEngine, SparseCOO, calibrate
from repro_torch.core.perfmodel import runtime_fallback
from repro_torch.kernels import ops
from repro_torch.models import gnn
from repro_torch.serving import (FaultInjector, InjectedFault, ServingConfig,
                                 ServingEngine, SharedPlanCache)

pytestmark = pytest.mark.gpu
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _graph(dev, n=256, nnz=1500, seed=5):
    rng = np.random.default_rng(seed)
    flat = np.sort(rng.choice(n * n, size=nnz, replace=False))
    return SparseCOO((n, n),
                     torch.as_tensor((flat // n).astype(np.int32), device=dev),
                     torch.as_tensor((flat % n).astype(np.int32), device=dev),
                     torch.as_tensor(np.abs(rng.normal(size=nnz))
                                     .astype(np.float32), device=dev),
                     tag="adjacency")


def _feats(i, n=256, d=32, density=0.3):
    rng = np.random.default_rng(1000 + i)
    h = rng.normal(size=(n, d)) * (rng.uniform(size=(n, d)) < density)
    return h.astype(np.float32)


def _serving(dev, model="GCN", params=None, **cfg):
    eng = DynasparseEngine(tile_m=64, tile_n=16, literal=True,
                           cache=SharedPlanCache(device=dev), device=dev)
    return ServingEngine(model, params, engine=eng,
                         config=ServingConfig(**cfg))


def test_requests_submitted_during_the_first_capture_resolve(cuda):
    """Requests keep arriving on the event loop while the dispatch worker
    captures the first compiled batch: none breaks the capture (no batch
    degrades to the eager path), every result agrees with a single-request
    literal run, and CUDA kernels ran."""
    adj = _graph(cuda)
    for model in ("GCN", "GIN"):
        params = gnn.init_params(model, 32, 16, 8, device=cuda)
        srv = _serving(cuda, model, params, max_batch=4)
        srv.register_graph("g", adj)
        feats = [_feats(i) for i in range(24)]
        ops.reset_cuda_launch_counts()
        try:
            outs = srv.serve((("g", h) for h in feats),
                             arrival_delay_s=0.002)
        finally:
            srv.close()
        assert sum(ops.cuda_launch_counts().values()) > 0
        assert srv.stats.compiled_batches >= 2, srv.stats.as_dict()
        assert srv.stats.degraded_batches == 0 and srv.stats.errors == 0
        single = DynasparseEngine(tile_m=64, tile_n=16, literal=True,
                                  device=cuda)
        for h, z in zip(feats, outs):
            want, _ = gnn.run_inference(model, single, adj, h, params,
                                        device=cuda)
            torch.testing.assert_close(z, want, **TOL)


def test_poison_request_isolated_bitwise_on_the_card(cuda):
    adj = _graph(cuda, seed=7)
    params = gnn.init_params("GCN", 32, 16, 16, device=cuda)

    def run(faults):
        srv = _serving(cuda, "GCN", params, max_batch=4,
                       activation_skip=False, faults=faults)
        srv.register_graph("g", adj)
        try:
            srv.serve(("g", _feats(900 + j)) for j in range(4))   # warmup
            outs = srv.serve((("g", _feats(i)) for i in range(8)),
                             return_exceptions=True)
        finally:
            srv.close()
        return srv, outs

    _, ref = run(None)
    srv, outs = run(FaultInjector(seed=0).arm("request", match="req:9;"))
    assert isinstance(outs[5], InjectedFault)
    for i, z in enumerate(outs):
        if i != 5:
            assert torch.equal(z, ref[i]), i
    assert srv.stats.quarantined == 1 and srv.stats.errors == 1


def test_snapshot_reuploads_onto_the_card(cuda, tmp_path):
    adj = _graph(cuda, seed=9)
    params = gnn.init_params("GCN", 32, 16, 8, device=cuda)
    h = _feats(3)
    c1 = SharedPlanCache(device=cuda)
    e1 = DynasparseEngine(tile_m=64, tile_n=16, literal=True, cache=c1,
                          device=cuda)
    z1, _ = gnn.run_inference("GCN", e1, adj, h, params, device=cuda)
    path = str(tmp_path / "plans.pkl")
    c1.save(path)
    c2 = SharedPlanCache(device=cuda)
    assert c2.load(path)["cold_start"] is False
    for (kind, _k), v in c2.items():
        if kind == SharedPlanCache._DISPATCH:
            assert all(a.device == cuda for a in v.arrays.values())
        if kind == SharedPlanCache._STRUCT:
            assert all(b.blocks.device == cuda for b in v.stripes.values())
    e2 = DynasparseEngine(tile_m=64, tile_n=16, literal=True, cache=c2,
                          device=cuda)
    z2, _ = gnn.run_inference("GCN", e2, adj, h, params, device=cuda)
    assert c2.stats.packs == 0 and c2.stats.dispatch_builds == 0
    assert torch.equal(z1, z2)


def test_calibration_times_the_cuda_kernels(cuda):
    n0 = calibrate.measurement_count()
    ops.reset_cuda_launch_counts()
    m = calibrate.calibrate(runtime_fallback("cuda"), device=cuda)
    launches = ops.cuda_launch_counts()
    assert calibrate.measurement_count() - n0 == m.n_samples == 14
    assert m.backend == "cuda:" + torch.cuda.get_device_name(cuda)
    assert m.base == "cuda-fallback" and m.calibrated and not m.fallback
    for k in ("gemm_batch_scatter", "spdmm_fused", "spmm_fused", "gemm"):
        assert launches.get(k, 0) > 0, (k, launches)
    assert m.mem_bw > 0 and m.dispatch_overhead > 0
    cache = SharedPlanCache(device=cuda)
    eng = DynasparseEngine(runtime_fallback("cuda"), cache=cache,
                           device=cuda)
    cache.calibration(calibrate.calibration_key(
        runtime_fallback("cuda"), 8, "float32", device=cuda), lambda: m)
    assert eng.runtime_hw() is m and cache.stats.calib_hits == 1
