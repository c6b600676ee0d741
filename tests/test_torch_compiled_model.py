"""The port's whole-model compile on the CPU, against the JAX package: for
all four models the compiled program's logits agree with the reference's
compiled program within 1e-4 and are bitwise repeatable, and the call and
cache counters (calls, traces, trace_builds, trace_cache_hits, plan_hits,
act_hits, act_builds) equal the reference's exactly.  Ports the
``test_compile_model_*`` cases of ``tests/test_compiled_dispatch.py``."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import DynasparseEngine as JEngine, SparseCOO as JCOO
from repro.core import dispatch as jd
from repro.models import gnn as jgnn
from repro_torch.core import DynasparseEngine as TEngine, SparseCOO as TCOO
from repro_torch.core import dispatch as td
from repro_torch.models import gnn as tgnn
from test_torch_kernels_cuda import compile_small

TOL = dict(rtol=1e-4, atol=1e-4)   # f32, another summation order
COUNTERS = ("trace_builds", "trace_cache_hits", "plan_hits", "act_hits",
            "act_builds", "dispatch_builds", "dispatch_hits")


def _graph(seed, n, nnz):
    rng = np.random.default_rng(seed)
    flat = np.sort(rng.choice(n * n, size=nnz, replace=False))
    rows = (flat // n).astype(np.int32)
    cols = (flat % n).astype(np.int32)
    vals = np.abs(rng.normal(size=nnz)).astype(np.float32)
    return rng, (JCOO((n, n), jnp.asarray(rows), jnp.asarray(cols),
                      jnp.asarray(vals), tag="adjacency"),
                 TCOO((n, n), torch.as_tensor(rows), torch.as_tensor(cols),
                      torch.as_tensor(vals), tag="adjacency"))


@pytest.mark.parametrize("model", tgnn.MODELS)
def test_compile_model_single_program_matches_reference(model):
    rng, (jadj, tadj) = _graph(17, 80, 240)
    h = rng.normal(size=(80, 12)).astype(np.float32)
    jp = jgnn.init_params(model, 12, 8, 5)
    tp = tgnn.params_from_jax(jp, "cpu")
    je = JEngine(tile_m=16, tile_n=8, literal=True)
    te = TEngine(tile_m=16, tile_n=8, literal=True, device="cpu")
    jd.reset_trace_registry()
    td.reset_trace_registry()
    jwarm, jcm = jgnn.compile_model(model, je, jadj, jnp.asarray(h), jp)
    twarm, tcm = tgnn.compile_model(model, te, tadj, torch.as_tensor(h), tp)
    assert tcm is not None and jcm is not None
    for f in ("n_kernels", "n_sparse", "n_act", "sketch_tile"):
        assert getattr(tcm, f) == getattr(jcm, f), f
    np.testing.assert_array_equal(tcm.input_sketch, jcm.input_sketch)
    assert len(tcm.report.kernels) == tcm.n_kernels
    np.testing.assert_allclose(twarm.numpy(), np.asarray(jwarm), **TOL)
    z1 = tcm(torch.as_tensor(h))
    z2 = tcm(torch.as_tensor(h))
    jz = jcm(jnp.asarray(h))
    jcm(jnp.asarray(h))
    assert tcm.calls == jcm.calls == 2 and tcm.traces == jcm.traces == 1
    assert torch.equal(z1, z2)
    # every route of the program sums in the eager kernels' order
    assert torch.equal(z1, twarm)
    np.testing.assert_allclose(z1.numpy(), np.asarray(jz), **TOL)
    ref = tgnn.run_reference(model, tadj, torch.as_tensor(h), tp)
    np.testing.assert_allclose(z1.numpy(), ref.numpy(), **TOL)
    for k in COUNTERS:
        assert getattr(te.cache.stats, k) == getattr(je.cache.stats, k), k


def test_compile_model_new_signature_is_a_new_program():
    """Equal inputs in a fresh tensor reuse the program; another dtype is
    a second program (a new trace in the reference): traces and
    trace_builds move together."""
    rng, (_, tadj) = _graph(3, 48, 120)
    h = torch.as_tensor(rng.normal(size=(48, 10)).astype(np.float32))
    tp = tgnn.init_params("GCN", 10, 8, 4, device="cpu")
    te = TEngine(tile_m=16, tile_n=8, literal=True, device="cpu")
    _, cm = tgnn.compile_model("GCN", te, tadj, h, tp)
    builds, hits = te.cache.stats.trace_builds, te.cache.stats.trace_cache_hits
    cm(h)
    cm(h.clone())
    assert cm.traces == 1 and te.cache.stats.trace_builds == builds + 1
    assert te.cache.stats.trace_cache_hits == hits + 1
    z = cm(h.to(torch.bfloat16))
    assert cm.traces == 2 and te.cache.stats.trace_builds == builds + 2
    np.testing.assert_allclose(
        z.numpy(), tgnn.run_reference("GCN", tadj, h.to(torch.bfloat16)
                                      .float(), tp).numpy(), **TOL)


def test_compile_model_declines_on_nonliteral_engine():
    rng, (_, tadj) = _graph(19, 40, 80)
    h = torch.as_tensor(rng.normal(size=(40, 10)).astype(np.float32))
    tp = tgnn.init_params("SGC", 10, 8, 8, device="cpu")
    for eng in (TEngine(tile_m=16, tile_n=8, device="cpu"),
                TEngine(tile_m=16, tile_n=8, literal=True, batched=False,
                        device="cpu")):
        warm, cm = tgnn.compile_model("SGC", eng, tadj, h, tp)
        assert cm is None
        np.testing.assert_allclose(
            warm.numpy(), tgnn.run_reference("SGC", tadj, h, tp).numpy(),
            **TOL)


def test_drifted_and_fresh_report():
    rng, (jadj, tadj) = _graph(23, 64, 200)
    h = rng.normal(size=(64, 12)).astype(np.float32)
    h[:, :4] = 0.0
    jp = jgnn.init_params("GCN", 12, 8, 5)
    tp = tgnn.params_from_jax(jp, "cpu")
    je = JEngine(tile_m=16, tile_n=8, literal=True)
    te = TEngine(tile_m=16, tile_n=8, literal=True, device="cpu")
    _, jcm = jgnn.compile_model("GCN", je, jadj, jnp.asarray(h), jp)
    _, tcm = tgnn.compile_model("GCN", te, tadj, torch.as_tensor(h), tp)
    h_dense = rng.normal(size=(64, 12)).astype(np.float32)
    for hh in (h, h_dense):
        assert (tcm.drifted(torch.as_tensor(hh), 0.1)
                == jcm.drifted(jnp.asarray(hh), 0.1))
    assert tcm.drifted(torch.as_tensor(h_dense), 0.1)
    rep = tcm.fresh_report()
    assert rep is not tcm.report and rep.kernels == tcm.report.kernels
    assert [n for n, _ in rep.kernels] == [n for n, _ in
                                           jcm.fresh_report().kernels]


@pytest.mark.parametrize("model,dense", [("GCN", 0), ("GIN", 0),
                                         ("GCN", 32)])
def test_compiled_model_counts_inplace_adjacency_kernels(model, dense):
    """``n_inplace`` counts the adjacency kernels on the in-place sparse
    body: all of them where every task is SpDMM, none where a dense stripe
    puts GEMM tasks beside them; either way the program's logits are
    bitwise its warm-up's."""
    cm, h, warm = compile_small(model, "cpu", dense=dense)
    assert cm.n_sparse == 2
    assert cm.n_inplace == (0 if dense else 2)
    assert torch.equal(cm(h), warm)
