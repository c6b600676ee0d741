"""A microbatch's rows split over the data-parallel axes, and ``seq_shard``
as sequence parallelism over ``model``, in the port's sharded train and
prefill steps (``launch/steps.py::MeshCompute``,
``distributed/tensor_parallel.py``), on meshes of repeated CPU devices
against the port's own single-device step on the same numpy-seeded
inputs:

- the train step of reduced qwen2.5-3b, deepseek-v2-lite-16b (MoE),
  mamba2-780m (SSD) and seamless-m4t-medium (enc-dec) on ``(2, 2)`` and
  ``(4, 1)``, every microbatch's rows split: in bfloat16 within the
  reference's gates of one device's step (loss 1e-3, parameters 5e-3,
  step-0 gradient norm 3e-3 relative; ``tests/test_sharding_multidev.py:
  113-117``), in float32 within the float32 gates of
  ``tests/test_torch_sharding_multidev.py`` with every MoE routing's
  dropped choices equal one device's;
- a batch whose microbatch rows the data axes do not divide runs each
  microbatch whole on one group: bitwise the ``(1, T)`` step, and on
  ``(4, 1)`` the single-device step;
- the prefill on ``(2, 2)`` against one device's, its MoE drops equal;
- ``seq_shard`` on ``(1, 2)`` and ``(2, 2)``: the loss and the prefill
  logits bitwise the same mesh's without it, float32 gradients within
  1e-5 relative (the norm weights' gradients are summed over the
  slices);
- the dry-run on a ``(2, 2)`` meta mesh: the counted train FLOPs of every
  (data, model) rank sum to the whole step's count, also with
  ``moe_dispatch_shard``, which halves each rank's expert GEMMs.

The reference's sharded steps (rows split on ``(4, 2)``, and with
``seq_shard``) are compared in ``tests/test_torch_sharding_multidev.py``.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.distributed import sharding as ts
from repro_torch.launch import dryrun, steps
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import Mesh
from repro_torch.models import ffn
from repro_torch.models.registry import build_model, input_specs
from repro_torch.optim.adamw import AdamWConfig

CPU = torch.device("cpu")
OPT = AdamWConfig(lr=1e-3, warmup_steps=0)
LOSS_TOL, PARAM_TOL, NORM_TOL = 1e-3, 5e-3, 3e-3
F32_LOSS_TOL, F32_NORM_TOL, F32_CHANGE_TOL = 1e-5, 1e-5, 1e-4
# a prefill split over dp and model against one device's, in float32
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
# seq_shard's float32 gradients against the same mesh's without it
SEQ_GRAD_TOL = 1e-5
ARCHS4 = ("qwen2.5-3b", "deepseek-v2-lite-16b", "mamba2-780m",
          "seamless-m4t-medium")
MESHES = [(2, 2), (4, 1)]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: a tensor-parallel step of a reduced arch is
    thousands of small ops (see ``tests/test_torch_tensor_parallel.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduced(arch, dtype="float32", **over):
    over = {"microbatches": 2, **over}
    return dataclasses.replace(reduce_config(ARCHS[arch]), dtype=dtype,
                               **over)


def mesh_of(data, model):
    return Mesh.on(CPU, (data, model), ("data", "model"))


def arch_batch(cfg, rows=8, seq=8, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                  (rows, seq)))}
    if cfg.n_enc_layers:
        out["frames"] = torch.as_tensor(rng.normal(
            size=(rows, seq, cfg.d_model)).astype(np.float32))
    return out


@contextlib.contextmanager
def recording_drops():
    """Every MoE routing's dropped choices ([tokens, K] booleans), in the
    order the routings ran."""
    drops, route = [], ffn.moe_route

    def recording(m, xf):
        out = route(m, xf)
        drops.append(out.order == m.cfg.n_experts * out.cap)
        return out

    ffn.moe_route = recording
    try:
        yield drops
    finally:
        ffn.moe_route = route


def assert_drops_equal(single, mesh, per_layer):
    """Each of one device's routings equals the ``per_layer`` routings
    the mesh ran in its place (every group's ranks route the gathered
    whole microbatch)."""
    assert len(mesh) == len(single) * per_layer
    for k, want in enumerate(single):
        for got in mesh[k * per_layer:(k + 1) * per_layer]:
            assert torch.equal(got, want), k


def step_with_grads(bundle, batch, mesh=None):
    """One train step from ``init_state(bundle, 0)``: (state, metrics,
    {name: whole gradient}, the MoE drops of its forward)."""
    state = steps.init_state(bundle, 0, CPU, mesh=mesh)
    step = steps.make_train_step(bundle, OPT, mesh=mesh)
    grads = {}
    if mesh is not None:
        reduce = step.compute.loss_and_grads

        def keep(*args):
            loss, got = reduce(*args)
            grads.update({n: g.whole().clone() for n, g in got.items()
                          if g is not None})
            return loss, got
        step.compute.loss_and_grads = keep
    with recording_drops() as drops:
        _, metrics = step(state, batch)
    if mesh is None:
        grads = {n: p.grad.clone()
                 for n, p in state["params"].named_parameters()}
    return state, metrics, grads, drops


def params_of(state):
    p = state["params"]
    if isinstance(p, torch.nn.Module):
        return {n: t.detach() for n, t in p.named_parameters()}
    return {n: ts.unshard(leaf, CPU) for n, leaf in p.items()}


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "4x1"])
@pytest.mark.parametrize("arch", ARCHS4)
def test_rows_split_step_within_the_gates_of_one_device(arch, shape):
    """One step of reduced ``arch`` (two microbatches of 4 rows, each
    split over the data ranks) in bfloat16 within the reference's gates
    of one device's step, and in float32 within the float32 gates (loss,
    gradient norm, each parameter's change) with every MoE routing's
    dropped choices equal one device's."""
    mesh = mesh_of(*shape)
    for dtype in ("bfloat16", "float32"):
        bundle = build_model(reduced(arch, dtype))
        batch = arch_batch(bundle.cfg)
        assert steps.MeshCompute(bundle, mesh).owner_ranks(batch, 2) == [
            tuple(range(shape[0]))] * 2
        init = params_of(steps.init_state(bundle, 0, CPU))
        one, m1, _, d1 = step_with_grads(bundle, batch)
        many, m2, _, d2 = step_with_grads(bundle, batch, mesh)
        f32 = dtype == "float32"
        assert abs(m1["loss"].item() - m2["loss"].item()) < (
            F32_LOSS_TOL if f32 else LOSS_TOL)
        assert m2["grad_norm"].item() == pytest.approx(
            m1["grad_norm"].item(), rel=F32_NORM_TOL if f32 else NORM_TOL)
        want, got = params_of(one), params_of(many)
        for n, p in want.items():
            assert (got[n] - p).abs().max().item() < PARAM_TOL, n
            if f32:
                change = (got[n] - init[n]) - (p - init[n])
                assert change.abs().max().item() < F32_CHANGE_TOL, n
        if f32:
            assert_drops_equal(d1, d2, shape[0] * shape[1])


@pytest.mark.parametrize("model", [2, 1], ids=["4x2", "4x1"])
@pytest.mark.parametrize("arch", ARCHS4)
def test_undivided_microbatch_rows_run_whole_bitwise(arch, model):
    """Eight rows in four microbatches of 2 on ``(4, model)``: the data
    axes divide the batch but not a microbatch's rows, so each microbatch
    runs whole on the first rank holding its rows, and the step (loss,
    gradient norm, parameters) is bitwise the ``(1, 2)`` step, or on
    ``(4, 1)`` the single-device ``make_train_step``'s."""
    bundle = build_model(reduced(arch, "bfloat16", microbatches=4))
    batch = arch_batch(bundle.cfg)
    compute = steps.MeshCompute(bundle, mesh_of(4, model))
    assert compute.owner_ranks(batch, 4) == [(0,), (1,), (2,), (3,)]
    a, ma, _, _ = step_with_grads(
        bundle, batch, mesh_of(1, 2) if model == 2 else None)
    b, mb, _, _ = step_with_grads(bundle, batch, mesh_of(4, model))
    for k in ("loss", "grad_norm"):
        assert torch.equal(ma[k], mb[k]), k
    pa, pb = params_of(a), params_of(b)
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n


@pytest.mark.parametrize("arch", ARCHS4)
def test_prefill_rows_split_matches_one_device(arch):
    """The prefill of 8 rows on ``(2, 2)``: each data rank's 4 rows on its
    group, logits concatenated in rank order, within ``LOGIT_TOL`` of one
    device's, every MoE routing over the whole batch with one device's
    drops."""
    bundle = build_model(reduced(arch))
    batch = arch_batch(bundle.cfg)
    model = bundle.init(0, CPU)
    with recording_drops() as d1:
        want = steps.make_prefill_step(bundle)(model, batch)
    mesh = mesh_of(2, 2)
    specs = ts.params_shardings(model, mesh)
    params = {n: ts.shard(p, specs[n], mesh)
              for n, p in model.named_parameters()}
    step = steps.make_prefill_step(bundle, mesh)
    with recording_drops() as d2:
        got = step(params, batch)
    assert step.__self__.layout(batch, 8) == (2, False)
    assert got.shape == want.shape
    assert torch.allclose(got, want, **LOGIT_TOL), (
        (got - want).abs().max().item())
    assert_drops_equal(d1, d2, 4)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b",
                                  "mamba2-780m"])
def test_seq_shard_is_bitwise_the_mesh_without_it(arch, shape):
    """With ``seq_shard`` each model rank holds its slice of the residual
    stream between layers (all-gathered before each layer, the partials
    reduce-scattered after it): the float32 loss and the prefill logits
    bitwise the same mesh's without it, every gradient within
    ``SEQ_GRAD_TOL`` of it (relative), and the group's tally holds
    reduce-scatters in place of the layers' all-reduces."""
    mesh = mesh_of(*shape)
    out = []
    for seq in (False, True):
        bundle = build_model(reduced(arch, seq_shard=seq, remat="full"))
        batch = arch_batch(bundle.cfg)
        compute = steps.MeshCompute(bundle, mesh)
        assert compute.layout(batch, 4) == (shape[0], seq)
        state, m, grads, _ = step_with_grads(bundle, batch, mesh)
        model = bundle.init(0, CPU)
        specs = ts.params_shardings(model, mesh)
        params = {n: ts.shard(p, specs[n], mesh)
                  for n, p in model.named_parameters()}
        step = steps.make_prefill_step(bundle, mesh)
        logits = step(params, batch)
        out.append((m, grads, logits, step.__self__.tallies[0]))
    (m0, g0, l0, t0), (m1, g1, l1, t1) = out
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(l0, l1)
    for n, g in g0.items():
        rel = ((g1[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
        assert rel < SEQ_GRAD_TOL, (n, rel)
    assert t0.total("reduce-scatter") == 0 < t1.total("reduce-scatter")


class ExpertFlops(TorchDispatchMode):
    """The FLOPs of the expert GEMMs run inside it: every ``bmm`` with an
    operand or a result of shape [experts, D, moe_d_ff] or [experts,
    moe_d_ff, D] (the forward products and both gradients of each)."""

    def __init__(self, cfg):
        super().__init__()
        self.shapes = {(cfg.d_model, cfg.moe_d_ff),
                       (cfg.moe_d_ff, cfg.d_model)}
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket is torch.ops.aten.bmm and self.shapes & {
                tuple(t.shape[1:]) for t in (*args[:2], out)}:
            self.flops += flop_registry[torch.ops.aten.bmm](*args,
                                                            out_val=out)
        return out


@pytest.mark.parametrize("flag", [False, True], ids=["", "moe_shard"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b"])
def test_rank_counts_sum_to_the_whole_step(arch, flag):
    """On the ``(2, 2)`` meta mesh the dry-run's counted train FLOPs of
    the four (data, model) ranks, each on its data rank's rows of every
    microbatch, sum to the counted FLOPs of the whole step
    (``make_train_step(..., mesh=)``, every rank's ops); each rank counts
    its share of the rows and every data rank computes.  With
    ``moe_dispatch_shard`` (capacity 20 a microbatch, which the 2 data
    ranks divide) each rank's expert GEMMs count half the unflagged
    ones'."""
    mesh = Mesh.on("meta", (2, 2), ("data", "model"))
    shape = ShapeConfig("t", 8, 16, "train")
    experts = []
    for moe_shard in (False, flag) if flag else (False,):
        cfg = reduced(arch, "bfloat16", moe_dispatch_shard=moe_shard)
        bundle = build_model(cfg)
        specs = input_specs(cfg, shape)
        counts, per_rank = [], []
        for b in range(2):
            for m in range(2):
                with ExpertFlops(cfg) as ex:
                    counts.append(dryrun._train(bundle, shape, mesh, specs,
                                                m, b))
                per_rank.append(ex.flops)
        experts.append(per_rank)
    state = steps.abstract_state(bundle, mesh)
    whole = rl.step_cost(steps.make_train_step(bundle, OPT, mesh=mesh),
                         state, specs)
    assert whole["flops"] == sum(cost["flops"] for cost, *_ in counts)
    for *_, busiest, _ in counts:
        assert busiest["rows"] == 16 // 2 // 2
        assert busiest["compute_devices"] == 4
    if flag:
        assert cfg.ffn != "moe" or ffn.slots_split(cfg, 4 * 16, 2)
        assert [2 * x for x in experts[1]] == experts[0]
        assert (min(experts[1]) > 0) == (cfg.ffn == "moe")
