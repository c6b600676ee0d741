"""The port's dry-run layer against the JAX reference, on the CPU with no
device: the abstract members (``abstract_params``, ``abstract_cache``,
``steps.abstract_state``), ``input_specs``, ``cell_is_runnable`` and
``model_flops`` equal the reference's for every arch and shape (``==`` on
shapes, dtypes, verdicts, reason text and counts); ``roofline_terms`` is
the reference's formula at the H100 constants; ``step_cost``'s FLOPs
equal the reference's ``hlo_cost`` of the same reduced programs; its
byte count and peak on hand-worked cases; the microbatch scaling of the
train count; the report's tables; and the dry-run CLI on a reduced cell.

The reference stacks layers on a leading axis; the port's dotted names map
to its ``/``-paths by ``sharding.reference_path``.  Its abstract trees come
from ``jax.eval_shape`` (no memory), the port's live on the ``meta``
device.  Nothing here counts a full-size cell: those run only through
``python -m repro_torch.launch.dryrun``.

``tests/test_layers.py::test_hlo_cost_loop_awareness`` tests the
reference's HLO parsing (while-loop trip counts) and has no counterpart:
the port has no HLO, and its steps run their loops op by op."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs.base import ShapeConfig as RefShape
from repro.configs.reduced import reduce_config as ref_reduce
from repro.distributed import sharding as rs
from repro.launch import report as ref_report
from repro.launch import roofline as ref_rl
from repro.launch.steps import abstract_state as ref_abstract_state
from repro.models.registry import build_model as ref_build
from repro.models.registry import cell_is_runnable as ref_runnable
from repro.models.registry import input_specs as ref_input_specs
from repro_torch import configs
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.distributed import sharding as ts
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import dryrun, report
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models.layers import trainable
from repro_torch.models.registry import (build_model, cell_is_runnable,
                                         input_specs)
from repro_torch.optim.adamw import AdamWConfig

META = torch.device("meta")


def _ref_flat(tree) -> dict:
    return {rs._path_str(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(tree, prefix="") -> dict:
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree}
    if isinstance(tree, torch.nn.Module):
        return {f"{prefix}{n}": p for n, p in tree.named_parameters()}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {k: v for key, sub in items
            for k, v in _port_flat(sub, f"{prefix}{key}.").items()}


def _dtype(t) -> str:
    return str(np.dtype(t.dtype)) if not isinstance(t, torch.Tensor) else (
        str(t.dtype).removeprefix("torch."))


def assert_tree_matches(port: dict, ref, stacks=ts.PARAM_STACKS):
    """Every port leaf (dotted name -> meta tensor) is the reference leaf
    of its ``/``-path less the stacked axes, with its dtype, and the
    port's layers fill each stacked axis exactly."""
    want = {p: (tuple(l.shape), _dtype(l)) for p, l in _ref_flat(ref).items()}
    count: dict[str, int] = {}
    stacked: dict[str, int] = {}
    for name, t in port.items():
        assert t.device == META, name
        path, n = ts.reference_path(name, stacks)
        shape, dtype = want[path]
        assert (shape[n:], dtype) == (tuple(t.shape), _dtype(t)), name
        count[path] = count.get(path, 0) + 1
        stacked[path] = int(np.prod(shape[:n]))
    assert count == stacked and set(count) == set(want)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_abstract_params_match_the_reference(arch):
    """At the published widths, every leaf's shape and dtype."""
    model = build_model(ARCHS[arch]).abstract_params()
    ref = ref_build(REF_ARCHS[arch]).abstract_params()
    assert_tree_matches(dict(model.named_parameters()), ref)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_abstract_cache_matches_the_reference(arch):
    """The decode cache of ``decode_32k`` (128 x 32768), and of
    ``long_500k`` (1 x 524288) where that cell is runnable."""
    bundle, ref = build_model(ARCHS[arch]), ref_build(REF_ARCHS[arch])
    for name in ("decode_32k", "long_500k"):
        if not cell_is_runnable(ARCHS[arch], name)[0]:
            continue
        shape = SHAPES[name]
        got = bundle.abstract_cache(shape.global_batch, shape.seq_len)
        want = ref.abstract_cache(shape.global_batch, shape.seq_len)
        assert_tree_matches(_port_flat(got), want, ts.CACHE_STACKS)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_abstract_state_matches_the_reference(arch):
    """Parameters, both moments (``opt_dtype``) and the step counter."""
    cfg = ARCHS[arch]
    state = steps.abstract_state(build_model(cfg))
    ref = ref_abstract_state(ref_build(REF_ARCHS[arch]))
    assert_tree_matches(dict(state["params"].named_parameters()),
                        ref["params"])
    for k in ("mu", "nu"):
        assert_tree_matches(state["opt"][k], ref["opt"][k])
    step = state["opt"]["step"]
    assert (tuple(step.shape), _dtype(step)) == (
        tuple(ref["opt"]["step"].shape), _dtype(ref["opt"]["step"]))
    assert all(p.requires_grad for p in state["params"].parameters())


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b"])
def test_abstract_state_on_a_mesh_holds_the_spec_blocks(arch):
    """With a mesh of meta coordinates, each coordinate holds the block of
    every parameter and moment that ``param_spec`` gives it, in the
    state's dtypes, and no memory."""
    cfg = ARCHS[arch]
    mesh = Mesh.on("meta", (4, 2), ("data", "model"))
    state = steps.abstract_state(build_model(cfg), mesh)
    plain = steps.abstract_state(build_model(cfg))
    mdt = getattr(torch, cfg.opt_dtype)
    for name, p in plain["params"].named_parameters():
        spec = ts.param_spec(name, tuple(p.shape), mesh)
        block = ts.block_shape(spec, tuple(p.shape), mesh)
        for tree, dtype in ((state["params"], torch.float32),
                            (state["opt"]["mu"], mdt),
                            (state["opt"]["nu"], mdt)):
            leaf = tree[name]
            assert (leaf.spec, leaf.shape) == (spec, tuple(p.shape))
            for coord in mesh.coords():
                t = leaf.local(coord)
                assert (tuple(t.shape), t.dtype, t.device) == (block, dtype,
                                                               META)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_input_specs_and_verdicts_equal_the_reference(arch):
    """All four shapes: every input's shape and dtype, and the verdict
    with its reason text."""
    for name, shape in SHAPES.items():
        assert cell_is_runnable(ARCHS[arch], name) == ref_runnable(
            REF_ARCHS[arch], name)
        got = input_specs(ARCHS[arch], shape)
        want = ref_input_specs(REF_ARCHS[arch], REF_SHAPES[name])
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device == META
            assert (tuple(t.shape), _dtype(t)) == (tuple(want[k].shape),
                                                   _dtype(want[k])), (name, k)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_equal_the_reference(arch):
    for name, shape in SHAPES.items():
        assert rl.model_flops(ARCHS[arch], shape) == ref_rl.model_flops(
            REF_ARCHS[arch], REF_SHAPES[name])


@pytest.mark.parametrize("flops,nbytes,coll", [
    (1e15, 1e10, 1e8), (1e12, 1e13, 1e8), (1e12, 1e10, 1e13), (0, 0, 0)])
def test_roofline_terms_are_the_reference_formula(monkeypatch, flops,
                                                  nbytes, coll):
    """The reference's ``roofline_terms`` with its three constants set to
    the H100's: 989 TFLOP/s bfloat16, 3.35 TB/s HBM3, NVLink 4 450 GB/s a
    direction."""
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12,
                                                       450e9)
    monkeypatch.setattr(ref_rl, "PEAK_FLOPS", rl.PEAK_FLOPS)
    monkeypatch.setattr(ref_rl, "HBM_BW", rl.HBM_BW)
    monkeypatch.setattr(ref_rl, "ICI_BW", rl.LINK_BW)
    assert rl.roofline_terms(flops, nbytes, coll, 256) == (
        ref_rl.roofline_terms(flops, nbytes, coll, 256))


# ------------------------------------------------------------ step_cost
B, L = 4, 64


def _flops_pair(arch):
    """(reference forward, port forward, reference gradient, port
    gradient) FLOPs of reduced ``arch`` at batch 4 x 64."""
    rc = ref_reduce(REF_ARCHS[arch])
    rb = ref_build(rc)
    params = rb.abstract_params()
    rbatch = ref_input_specs(rc, RefShape("t", L, B, "train"))
    ref_fwd = ref_rl.lowered_cost(jax.jit(rb.forward), params, rbatch)
    ref_grad = ref_rl.lowered_cost(jax.jit(jax.grad(rb.loss)), params,
                                   rbatch)
    cfg = reduce_config(ARCHS[arch])
    bundle = build_model(cfg)
    model = bundle.abstract_params()
    batch = input_specs(cfg, ShapeConfig("t", L, B, "train"))
    with torch.no_grad():
        fwd = rl.step_cost(bundle.forward, model, batch)
    trainable(model)
    grad = rl.step_cost(lambda m, b: bundle.loss(m, b).backward(), model,
                        batch)
    return ref_fwd["flops"], fwd["flops"], ref_grad["flops"], grad["flops"]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b"])
def test_step_cost_flops_equal_hlo_cost(arch):
    """The forward and ``grad(loss)`` of the reduced arch: ``StepCounter``
    (``FlopCounterMode``'s formulas) on the port's meta run counts
    exactly the matrix-product FLOPs that
    the reference's loop-aware ``hlo_cost`` reads from its compiled
    program (54,525,952 / 163,577,856 for qwen2.5-3b; 60,817,408 /
    182,452,224 for deepseek-v2-lite-16b, whose MoE dispatch runs at its
    capacity on meta as on a card)."""
    ref_fwd, fwd, ref_grad, grad = _flops_pair(arch)
    assert (fwd, grad) == (ref_fwd, ref_grad)
    assert fwd > 0 and grad == 3 * fwd


def test_mamba2_gradient_gap_is_the_ssd_einsums_backward():
    """Reduced mamba2-780m: the forward equals the reference's exactly
    (41,549,824); the gradient has 327,680 fewer product FLOPs
    (124,649,472 against 124,977,152, 0.26 %), 163,840 in each of its two
    SSD layers.  The cause is the chunked scan's three multi-operand
    einsums (``mixers.ssd_scan``): in the forward both packages run the
    same products, but each of the three has a step with no summed axis
    (a broadcast product, ``Lmat`` or a decay against the others).
    ``torch.einsum`` runs that step as a ``mul``, whose backward is a
    multiply and a sum; JAX's VJP of the contraction path turns the
    cotangent of that step into a ``dot_general`` over the broadcast axis
    instead: 2·4·8·8·8·8 = 32,768 FLOPs in ``y_diag`` (over the heads)
    and 65,536 each in ``states`` and ``y_off`` (over the 16-wide head
    dim).  Same arithmetic, counted as products in one package and as
    elementwise work (which neither counter counts) in the other."""
    ref_fwd, fwd, ref_grad, grad = _flops_pair("mamba2-780m")
    assert fwd == ref_fwd == 41_549_824
    assert (ref_grad, grad) == (124_977_152, 124_649_472)
    layers = reduce_config(ARCHS["mamba2-780m"]).n_layers
    assert ref_grad - grad == layers * (2 * 4 * 8 * 8 * 8 * 8
                                        + 2 * (2 * 4 * 8 * 8 * 8 * 16))


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device=META, requires_grad=grad)


def test_byte_count_and_peak_on_hand_worked_cases():
    """One product (inputs read, output written), one slice copied (a view
    costs nothing, the copy twice its output), one fill (its output
    only), a gather (twice its output), an in-place slice update (twice
    the update), and a saved activation: ``exp`` keeps its output for the
    backward after the Python name is gone, so the peak holds it until
    the backward has used it."""
    a, b = _meta(64, 32), _meta(32, 16)
    got = rl.step_cost(lambda x, y: x @ y, a, b)
    assert got["flops"] == 2 * 64 * 32 * 16
    assert got["bytes"] == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert got["held_bytes"] == 4 * (64 * 32 + 32 * 16)
    assert got["peak_bytes"] == got["held_bytes"] + 4 * 64 * 16
    assert set(got["collectives"]) == set(rl.COLLECTIVES)
    assert not any(got["collectives"].values())
    got = rl.step_cost(lambda x: x[:8].t().clone(), a)
    assert (got["bytes"], got["peak_bytes"]) == (2 * 4 * 8 * 32,
                                                  4 * (64 * 32 + 8 * 32))
    got = rl.step_cost(lambda: torch.zeros(10, 10, device=META))
    assert (got["bytes"], got["peak_bytes"], got["held_bytes"]) == (400,
                                                                     400, 0)
    idx = _meta(5, dtype=torch.long)
    got = rl.step_cost(lambda x, i: x[i], a, idx)
    assert got["bytes"] == 2 * 4 * 5 * 32
    got = rl.step_cost(lambda x, y: x[:4].copy_(y), a, _meta(4, 32))
    assert (got["bytes"], got["peak_bytes"]) == (2 * 4 * 4 * 32,
                                                  got["held_bytes"])

    x = _meta(100, grad=True)

    def saved(x):
        y = torch.exp(x)                 # keeps y for its backward
        z = (y * 2).sum()
        del y
        z.backward()

    got = rl.step_cost(saved, x)
    # held x 400; exp 400 (saved); y * 2 400 (freed after the sum); sum 4;
    # backward: ones 4, grad * 2 400, exp's grad (into x.grad) 400
    assert got["held_bytes"] == 400
    assert got["peak_bytes"] == 400 + 400 + 4 + 4 + 400 + 400
    assert got["bytes"] == (800 + 800 + 404 + 4 + 800 + 1200)


def test_top_bytes_names_the_largest_ops():
    a, b = _meta(256, 256), _meta(256, 8)
    top = rl.top_bytes(lambda x, y: (x * 2) @ y, a, b, n=2)
    assert top == [(2 * 4 * 256 * 256, "x1 mul (256, 256) float32"),
                   (4 * (256 * 256 + 256 * 8 + 256 * 8),
                    "x1 mm (256, 8) float32")]


def test_step_collectives_from_the_rules():
    """On a (data 2, model 2) mesh: every parameter that is not one whole
    block is gathered whole, its gradient block reduce-scattered, a
    replicated one's gradient all-reduced; serving gathers only; a
    one-device mesh moves nothing."""
    cfg = reduce_config(ARCHS["qwen2.5-3b"])
    bundle = build_model(cfg)
    mesh = Mesh.on("meta", (2, 2), ("data", "model"))
    state = steps.abstract_state(bundle, mesh)
    got = rl.step_collectives(mesh, state)
    ag = rs_ = ar = 0
    for leaf in state["params"].values():
        whole = int(np.prod(leaf.shape)) * 4
        if leaf.block_shape != leaf.shape:
            ag += whole
            rs_ += int(np.prod(leaf.block_shape)) * 4
        else:
            ar += whole
    assert ag and rs_ and ar
    assert got == {"all-gather": ag, "all-reduce": ar, "reduce-scatter": rs_,
                   "all-to-all": 0, "collective-permute": 0}
    serve = rl.step_collectives(mesh, {"params": state["params"]})
    assert serve == dict(got, **{"all-reduce": 0, "reduce-scatter": 0})
    # a model rank's compute blocks: only those its coordinate does not
    # hold as its stored block are gathered (here everything split over
    # data, and nothing re-sliced), and the group's tally adds on
    plan = steps.MeshCompute(bundle, mesh).plan(0)
    tally = tp.Tally()
    tally.add("all-reduce", "forward", 7)
    tally.add("all-gather", "forward", 5)
    ranked = rl.step_collectives(mesh, state, plan.splits, (0, 0), tally)
    ag = sum(int(np.prod(plan.splits[n].local_shape(l.shape)
                         if n in plan.splits else l.shape)) * 4
             for n, l in state["params"].items()
             if not tp.held_block(l, plan.splits.get(n), (0, 0)))
    assert ranked == dict(got, **{"all-gather": ag + 5,
                                  "all-reduce": ar + 7})
    assert 0 < ag < got["all-gather"]
    one = Mesh.on("meta", (1, 1), ("data", "model"))
    assert not any(rl.step_collectives(
        one, steps.abstract_state(bundle, one)).values())


def test_train_count_scales_one_microbatch_to_the_unscaled_step():
    """On the (1, 1) mesh the device runs all of reduced qwen2.5-3b's four
    microbatches: the count runs three (the first makes the gradients,
    the second is the steady one) and adds the second once more; FLOPs,
    bytes and the peak equal those of the whole step
    (``make_train_step(..., mesh=)``, four microbatches) on the same
    state."""
    cfg = dataclasses.replace(reduce_config(ARCHS["qwen2.5-3b"]),
                              microbatches=4)
    mesh = Mesh.on("meta", (1, 1), ("data", "model"))
    shape = ShapeConfig("t", 16, 8, "train")
    counted = dryrun.count_cell(cfg, shape, mesh)
    assert counted["busiest"] == dict(coord=[0, 0], microbatches=4, rows=2,
                                      compute_devices=1, model_group=1,
                                      whole_layers=[])
    bundle = build_model(cfg)
    state = steps.abstract_state(bundle, mesh)
    step = steps.make_train_step(bundle, AdamWConfig(), mesh=mesh)
    batch = input_specs(cfg, shape)
    whole = rl.step_cost(step, state, batch)
    assert counted["cost"] == {"flops": whole["flops"],
                               "bytes_accessed": whole["bytes"]}
    assert counted["memory"]["peak_per_device_gb"] == round(
        whole["peak_bytes"] / 1e9, 3)
    mem = counted["memory"]
    assert mem["shard_bytes"] + mem["replica_bytes"] == whole["held_bytes"]
    assert mem["activation_bytes"] == whole["peak_bytes"] - whole[
        "held_bytes"]
    assert counted["collectives"] == dict.fromkeys(rl.COLLECTIVES, 0)
    assert counted["tp_collectives"] == {}


def test_serving_counts_gather_the_replica_and_cache():
    """Reduced deepseek-v2-lite-16b (MLA + MoE) on a (data 2, model 2)
    mesh: a decode cell counts model rank 0 of dp rank 0's group, on its
    rows against its own blocks of the placed cache (nothing of the cache
    gathered: the latent cache is replicated over ``model``), its layer
    all-reduces, the MoE layers' gathered rows of both dp ranks and the
    gathered logits tallied, and ``step_collectives``' all-reduce is the
    tally's; ``infer_tp`` keeps the parameters off the data axis; a
    prefill cell runs model rank 0's share of the tensor-parallel prefill
    step on its rows, its layer all-reduces and the gathered logits
    tallied."""
    cfg = reduce_config(ARCHS["deepseek-v2-lite-16b"])
    mesh = Mesh.on("meta", (2, 2), ("data", "model"))
    dec = dryrun.count_cell(cfg, ShapeConfig("d", 64, 4, "decode"), mesh)
    infer = dryrun.count_cell(cfg, ShapeConfig("d", 64, 4, "decode"), mesh,
                              ("infer_tp",))
    pre = dryrun.count_cell(cfg, ShapeConfig("p", 64, 4, "prefill"), mesh)
    assert dec["busiest"] == dict(coord=[0, 0], rows=2, compute_devices=4,
                                  model_group=2, whole_layers=[])
    assert pre["busiest"] == dict(coord=[0, 0], rows=2, compute_devices=4,
                                  model_group=2, whole_layers=[])
    assert set(pre["tp_collectives"]) == {"all-reduce", "all-gather"}
    assert set(dec["tp_collectives"]) == {"all-reduce", "all-gather"}
    assert all(set(v) == {"forward"} for v in dec["tp_collectives"].values())
    assert dec["collectives"]["all-reduce"] == sum(
        dec["tp_collectives"]["all-reduce"].values()) > 0
    # the all-gathers: the parameters' compute blocks and the tally, no
    # cache leaf
    bundle = build_model(cfg)
    model = bundle.abstract_params()
    specs = ts.params_shardings(model, mesh)
    params = {n: ts.shard(p, specs[n], mesh)
              for n, p in model.named_parameters()}
    splits = tp.local_model(bundle, mesh, 0).splits
    weights = rl.step_collectives(mesh, {"params": params}, splits, (0, 0))
    assert dec["collectives"]["all-gather"] == weights["all-gather"] + sum(
        dec["tp_collectives"]["all-gather"].values())
    assert dec["cost"]["flops"] > 0 and pre["cost"]["flops"] > dec["cost"][
        "flops"]
    assert infer["memory"]["shard_bytes"] > dec["memory"]["shard_bytes"]
    for r in (dec, infer, pre):
        assert r["collectives"]["reduce-scatter"] == 0
        assert r["memory"]["activation_bytes"] > 0
        assert r["roofline"]["dominant"] in ("compute_s", "memory_s",
                                             "collective_s")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_group_count_is_the_sum_of_rank_counts(arch):
    """On the ``(1, 2)`` meta mesh the counted FLOPs of the whole group's
    decode step (``make_serve_step(bundle, mesh)``, both ranks' ops)
    equal the sum of the dry-run's two per-rank decode counts, each rank
    below three quarters of the ``(1, 1)`` count; the counted rank's
    tally equals a CPU decode step's on the same mesh shape."""
    cfg = reduce_config(ARCHS[arch])
    mesh = Mesh.on("meta", (1, 2), ("data", "model"))
    shape = ShapeConfig("d", 64, 4, "decode")
    bundle = build_model(cfg)
    counts = [dryrun.count_cell(cfg, shape, mesh, model_rank=m)
              for m in range(2)]
    model = bundle.abstract_params()
    specs = ts.params_shardings(model, mesh)
    params = {n: ts.shard(p, specs[n], mesh)
              for n, p in model.named_parameters()}
    cache = ts.shard_cache(bundle.abstract_cache(4, 64), mesh)
    whole = rl.step_cost(steps.make_serve_step(bundle, mesh), params, cache,
                         input_specs(cfg, shape))
    assert whole["flops"] == sum(c["cost"]["flops"] for c in counts)
    assert all(c["busiest"]["model_group"] == 2 for c in counts)
    one = dryrun.count_cell(cfg, shape, Mesh.on("meta", (1, 1),
                                                ("data", "model")))
    assert counts[0]["cost"]["flops"] < 0.75 * one["cost"]["flops"]
    cpu = torch.device("cpu")
    mesh = Mesh.on(cpu, (1, 2), ("data", "model"))
    real = bundle.init(0, cpu)
    specs = ts.params_shardings(real, mesh)
    step = steps.make_serve_step(bundle, mesh)
    step({n: ts.shard(p, specs[n], mesh) for n, p in real.named_parameters()},
         ts.shard_cache(bundle.init_cache(4, 64, device=cpu), mesh),
         {"tokens": torch.zeros((4, 1), dtype=torch.long), "pos": 0})
    assert counts[0]["tp_collectives"] == step.compute.tallies[0].as_dict()


# ------------------------------------------------------------ report
def _row(arch, shape, mesh, status="ok", t=(1e-3, 2e-3, 3e-4), flops=5e12):
    if status != "ok":
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": status}
    terms = dict(compute_s=t[0], memory_s=t[1], collective_s=t[2])
    terms.update(dominant=max(terms, key=terms.get),
                 total_bound_s=max(t), n_chips=256)
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
            "compile_s": 12.3, "memory": {"peak_per_device_gb": 71.25},
            "cost": {"flops": flops},
            "collectives": {"all-gather": 2.5e9, "all-reduce": 1e7,
                            "reduce-scatter": 3e8, "all-to-all": 0,
                            "collective-permute": 0},
            "roofline": terms, "model_flops": 1.5e17,
            "useful_flops_ratio": 0.1234}


ROWS = [_row("deepseek-v2-236b", "train_4k", "single", t=(2.0, 1.0, 0.5)),
        _row("deepseek-v2-236b", "train_4k", "multi"),
        _row("qwen2.5-3b", "decode_32k", "single", t=(1e-5, 3e-3, 8e-2)),
        _row("qwen2.5-3b", "long_500k", "single", "skipped-by-design"),
        _row("mamba2-780m", "prefill_32k", "single", t=(0.2, 4.0, 1e-6)),
        _row("mamba2-780m", "train_4k", "multi", "failed")]


def test_report_tables_equal_the_reference(monkeypatch):
    """Given the same rows, the reference's tables, hillclimb picks and
    time format; the roofline note differs only where the compute term
    dominates (the H100's tensor cores, not the MXU)."""
    for mesh in ("single", "multi"):
        assert report.dryrun_table(ROWS, mesh) == ref_report.dryrun_table(
            ROWS, mesh)
    assert report.pick_hillclimb(ROWS) == ref_report.pick_hillclimb(ROWS)
    for x in (12.5, 1.0, 0.25, 1e-3, 4.2e-5):
        assert report.fmt_t(x) == ref_report.fmt_t(x)
    for r in ROWS:
        if r["status"] == "ok":
            same = report._note(r) == ref_report._note(r)
            assert same == (r["roofline"]["dominant"] != "compute_s")
    assert "H100 tensor-core" in report._note(ROWS[0])
    monkeypatch.setattr(ref_report, "_note", report._note)
    for mesh in ("single", "multi"):
        assert report.roofline_table(ROWS, mesh) == (
            ref_report.roofline_table(ROWS, mesh))


def test_report_main_names_each_mesh_by_its_shape(tmp_path, capsys):
    for r in ROWS:
        (tmp_path / f"{r['arch']}__{r['shape']}__{r['mesh']}.json").write_text(
            json.dumps(r))
    report.main(["--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "### Dry-run — 16 x 16 mesh over (data, model), 256 devices" in out
    assert ("### Dry-run — 2 x 16 x 16 mesh over (pod, data, model), 512 "
            "devices") in out
    assert "pod (" not in out and "- deepseek-v2-236b x train_4k" in out
    report.main(["--out", str(tmp_path), "--what", "cells"])
    lines = capsys.readouterr().out.splitlines()
    assert ("| deepseek-v2-236b | train_4k | ok / ok | 71.2 / 71.2 | 5.0 / "
            "5.0 | 2.5 / 2.5 | 0.01 / 0.01 | 0.30 / 0.30 | 0 / 0 | "
            "compute / memory |") in lines
    assert ("| mamba2-780m | train_4k | missing / failed | — / — | — / — | "
            "— / — | — / — | — / — | — / — | — / — |") in lines
    assert len([l for l in lines if l.startswith("| ") and "---" not in l
                and not l.startswith("| arch")]) == 5


# ------------------------------------------------------------ the CLI
@pytest.fixture
def reduced_cell(monkeypatch):
    """``qwen2.5-3b x train_4k`` made small: the reduced config at 32 x 64
    (the CLI reads ``ARCHS`` and ``SHAPES`` when it runs a cell)."""
    monkeypatch.setitem(configs.ARCHS, "qwen2.5-3b",
                        reduce_config(ARCHS["qwen2.5-3b"]))
    monkeypatch.setitem(configs.SHAPES, "train_4k",
                        ShapeConfig("train_4k", 64, 32, "train"))


def test_dryrun_cli_writes_the_reference_keys(reduced_cell, tmp_path,
                                              capsys):
    dryrun.main(["--arch", "qwen2.5-3b", "--shape", "train_4k", "--mesh",
                 "single", "--out", str(tmp_path), "--save-hlo"])
    out = capsys.readouterr().out
    assert "nothing written" in out and "-> " in out
    r = json.loads((tmp_path / "qwen2.5-3b__train_4k__single.json")
                   .read_text())
    assert r["status"] == "ok" and r["n_chips"] == 256
    for key in ("compile_s", "memory", "cost", "collectives", "roofline",
                "model_flops", "useful_flops_ratio", "params_b",
                "params_active_b"):
        assert key in r, key
    assert set(r["memory"]) == {"shard_bytes", "replica_bytes",
                                "activation_bytes", "peak_per_device_gb"}
    assert set(r["cost"]) == {"flops", "bytes_accessed"}
    assert set(r["collectives"]) == set(rl.COLLECTIVES)
    assert not {"xla_flops_once", "xla_bytes_once", "hlo_path"} & set(r)
    mem = r["memory"]
    assert mem["peak_per_device_gb"] == round(
        (mem["shard_bytes"] + mem["replica_bytes"] + mem["activation_bytes"])
        / 1e9, 3)
    # 32 rows in 4 microbatches over 16 data ranks: 4 model groups of 16
    # devices run one each; the reduced config's 4 heads do not divide
    # over 16 ranks, so its attention layers run whole
    assert r["busiest"]["microbatches"] == 1
    assert r["busiest"]["compute_devices"] == 64
    assert r["busiest"]["model_group"] == 16
    assert r["busiest"]["whole_layers"] == ["cycles.0.layer0.mixer",
                                            "cycles.1.layer0.mixer"]
    assert r["tp_collectives"]["all-reduce"]["forward"] > 0
    assert r["model_flops"] == rl.model_flops(configs.ARCHS["qwen2.5-3b"],
                                              configs.SHAPES["train_4k"])
    dryrun.main(["--arch", "qwen2.5-3b", "--shape", "long_500k", "--out",
                 str(tmp_path)])
    r = json.loads((tmp_path / "qwen2.5-3b__long_500k__single.json")
                   .read_text())
    assert r["status"] == "skipped-by-design" and "524k" in r["reason"]


def test_dryrun_all_skips_done_cells_and_records_a_timeout(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    """``--all`` runs no cell whose file exists, and a cell whose
    subprocess runs out of time is written as ``failed``."""
    import subprocess

    cells = list(dryrun.all_cells())
    assert len(cells) == 80
    missing = ("mamba2-780m", "long_500k", "multi")
    for arch, shape, mesh in cells:
        if (arch, shape, mesh) != missing:
            (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text("{}")
    ran, clock = [], [0.0]

    class Hung:
        """A cell subprocess that never ends until it is killed."""

        def __init__(self, cmd):
            ran.append(cmd)
            self.rc = None

        def poll(self):
            return self.rc

        def kill(self):
            self.rc = -9

        def wait(self):
            return self.rc

    def sleep(s):
        clock[0] += s

    monkeypatch.setattr(subprocess, "Popen", Hung)
    monkeypatch.setattr(dryrun.time, "sleep", sleep)
    monkeypatch.setattr(dryrun.time, "time", lambda: clock[0])
    dryrun.main(["--all", "--out", str(tmp_path), "--timeout", "7"])
    assert clock[0] > 7
    assert len(ran) == 1 and ran[0][3:9] == [
        "--arch", "mamba2-780m", "--shape", "long_500k", "--mesh", "multi"]
    r = json.loads((tmp_path / "mamba2-780m__long_500k__multi.json")
                   .read_text())
    assert r == {"arch": "mamba2-780m", "shape": "long_500k",
                 "mesh": "multi", "status": "failed", "returncode": -9}
    assert "complete: 79 ok/skipped, 1 failed of 80" in capsys.readouterr().out
    assert all((tmp_path / f"{a}__{s}__{m}.json").read_text() == "{}"
               for a, s, m in cells if (a, s, m) != missing)


def test_dryrun_all_jobs_counts_cells_side_by_side(tmp_path, monkeypatch,
                                                   capsys):
    """``--all --jobs 3`` keeps up to three cell subprocesses running,
    starts only the cells not yet written, and writes a cell whose
    subprocess fails as ``failed``."""
    import subprocess

    cells = list(dryrun.all_cells())
    todo = [c for c in cells if c[0] == "qwen2.5-3b"][:5]
    for arch, shape, mesh in [c for c in cells if c not in todo]:
        (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text("{}")
    started, live, most = [], [], [0]

    class Cell:
        def __init__(self, cmd):
            self.cell = (cmd[4], cmd[6], cmd[8])
            self.polls = 0
            started.append(self.cell)
            live.append(self)
            most[0] = max(most[0], len(live))

        def poll(self):
            self.polls += 1
            if self.polls < 3:
                return None
            live.remove(self)
            if self.cell == todo[0]:
                return 1
            (tmp_path / f"{'__'.join(self.cell)}.json").write_text(
                '{"status": "ok"}')
            return 0

    monkeypatch.setattr(subprocess, "Popen", Cell)
    monkeypatch.setattr(dryrun.time, "sleep", lambda s: None)
    dryrun.main(["--all", "--jobs", "3", "--out", str(tmp_path)])
    # the 32k prefills first, then the trains, decodes, long contexts
    assert started == sorted(todo, key=lambda c: [
        "prefill_32k", "train_4k", "decode_32k", "long_500k"].index(c[1]))
    assert most[0] == 3
    r = json.loads((tmp_path / f"{'__'.join(todo[0])}.json").read_text())
    assert r == dict(zip(("arch", "shape", "mesh"), todo[0]),
                     status="failed", returncode=1)
    assert "complete: 79 ok/skipped, 1 failed of 80" in capsys.readouterr().out
