"""The port's slice end to end on the CPU: the stand-in graphs and the
initial parameters equal the JAX package's byte for byte, and all four
models give the reference's logits, kernel names and queue assignments
through the literal engine (Pallas interpret mode on the JAX side)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import DynasparseEngine as JEngine
from repro.data.graphs import load_graph as jload
from repro.models import gnn as jgnn
from repro_torch.core import DynasparseEngine as TEngine
from repro_torch.data.graphs import load_graph as tload
from repro_torch.models import gnn as tgnn

TOL = dict(rtol=1e-4, atol=1e-4)   # f32 end to end, another summation order


@pytest.mark.parametrize("name,scale", [("CO", 0.02), ("CI", 0.01),
                                        ("PU", 0.005)])
def test_graphs_byte_equal(name, scale):
    j, t = jload(name, scale=scale), tload(name, scale=scale, device="cpu")
    assert dataclasses.asdict(j.stats) == dataclasses.asdict(t.stats)
    for f in ("rows", "cols", "vals"):
        a, b = np.asarray(getattr(j.adj, f)), getattr(t.adj, f).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert t.adj.shape == j.adj.shape and t.adj.tag == j.adj.tag
    a, b = np.asarray(j.features_dense), t.features_dense.numpy()
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert t.feature_density == pytest.approx(j.feature_density)


@pytest.mark.parametrize("model", tgnn.MODELS)
def test_params_equal_reference(model):
    jp = jgnn.init_params(model, 37, 16, 5, seed=3)
    tp = tgnn.init_params(model, 37, 16, 5, seed=3, device="cpu")
    carried = tgnn.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                   "cpu")
    assert list(tp) == list(jp) == list(carried)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
        np.testing.assert_array_equal(carried[k].numpy(), np.asarray(jp[k]))


def _kernels(report):
    return [(name, dataclasses.asdict(rep)) for name, rep in report.kernels]


@pytest.mark.parametrize("model", tgnn.MODELS)
def test_literal_inference_matches_reference(model):
    jg = jload("CI", scale=0.01)
    tg = tload("CI", scale=0.01, device="cpu")
    jp = jgnn.init_params(model, jg.features_dense.shape[1], 8,
                          jg.stats.classes)
    tp = tgnn.params_from_jax(jp, "cpu")
    je = JEngine(tile_m=16, tile_n=8, literal=True)
    te = TEngine(tile_m=16, tile_n=8, literal=True, device="cpu")
    jl, jr = jgnn.run_inference(model, je, jg.adj, jg.features_dense, jp)
    tl, tr = tgnn.run_inference(model, te, tg.adj, tg.features_dense, tp,
                                device="cpu")
    assert tl.shape == jl.shape and torch.isfinite(tl).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert _kernels(tr) == _kernels(jr)           # names, queues, reports
    assert tr.hardware_time == jr.hardware_time
    # the plain dense reference of both packages agrees too
    ref = tgnn.run_reference(model, tg.adj, tg.features_dense, tp)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(jgnn.run_reference(model, jg.adj,
                                                   jg.features_dense, jp)),
        **TOL)
    np.testing.assert_allclose(tl.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("model", ["GCN", "GIN"])
def test_non_literal_inference_matches_reference(model):
    jg = jload("CO", scale=0.02)
    tg = tload("CO", scale=0.02, device="cpu")
    jp = jgnn.init_params(model, jg.features_dense.shape[1], 16,
                          jg.stats.classes)
    tp = tgnn.params_from_jax(jp, "cpu")
    jl, jr = jgnn.run_inference(model, JEngine(tile_m=32, tile_n=16),
                                jg.adj, jg.features_dense, jp)
    tl, tr = tgnn.run_inference(model,
                                TEngine(tile_m=32, tile_n=16, device="cpu"),
                                tg.adj, tg.features_dense, tp, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert _kernels(tr) == _kernels(jr)


def test_warm_inference_hits_every_cache_level():
    """The second call on one graph re-plans, re-packs and re-lowers
    nothing, and gives the same logits bit for bit."""
    tg = tload("CO", scale=0.02, device="cpu")
    tp = tgnn.init_params("GCN", tg.features_dense.shape[1], 16,
                          tg.stats.classes, device="cpu")
    te = TEngine(tile_m=32, tile_n=16, literal=True, device="cpu")
    cold, _ = tgnn.run_inference("GCN", te, tg.adj, tg.features_dense, tp,
                                 device="cpu")
    s = dict(te.cache.stats.as_dict())
    warm, _ = tgnn.run_inference("GCN", te, tg.adj, tg.features_dense, tp,
                                 device="cpu")
    s2 = te.cache.stats.as_dict()
    assert torch.equal(cold, warm)
    for k in ("packs", "analyzes", "dispatch_builds", "plan_misses"):
        assert s2[k] == s[k], k
    assert s2["dispatch_hits"] > s["dispatch_hits"]
    assert s2["plan_hits"] > s["plan_hits"]
