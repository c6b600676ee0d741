"""``moe_dispatch_shard`` in the port's sharded train, prefill and decode
steps (``models/ffn.py::moe_dp``, ``distributed/tensor_parallel.py::
gather_slots``): where a step's rows are split over the data-parallel
ranks and those divide the capacity, each rank's group runs the expert
GEMMs of its share of the slots only, and the slot outputs are
all-gathered over the ranks.  On meshes of repeated CPU devices, reduced
deepseek-v2-lite-16b (8 experts, top-2; rows 8 x seq 8 in two
microbatches: capacity 10 per microbatch):

- on ``(2, 2)`` (experts split over ``model``) and ``(2, 1)`` (the layer
  whole on each group): in float32 the loss, every gradient and the
  prefill logits within 1e-5 relative of the same mesh without the flag,
  every MoE routing's dropped choices equal; in bfloat16 within the
  reference's gates of one device's step;
- where the flag does not split the slots (``(4, 1)``: 4 ranks do not
  divide capacity 10; ``(1, 2)``: rows not split; one device) the step
  is bitwise the unflagged one;
- a decode step on ``(2, 2)`` at batch 8 (capacity 2) within the gates of
  the decode on ``model`` against one device;
- the group's tally holds the slots' all-gather (and its reduce-scatter
  backward) only with the flag, at the bytes of each rank's slots;
- ``ffn.slots_split`` decides as ``sharding.resolve`` of the reference's
  ``("model", "dp", None)`` does;
- the flagged ``(2, 2)`` float32 step's loss and gradients against the
  JAX reference's single-device ones on the same weights, at the
  tolerances of ``tests/test_torch_train.py``.

The dry-run's per-rank counts with the flag are in
``tests/test_torch_dp_rows.py::test_rank_counts_sum_to_the_whole_step``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.distributed import sharding as ts
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import ffn
from repro_torch.models.registry import build_model
from test_torch_dp_rows import (LOSS_TOL, NORM_TOL, OPT, PARAM_TOL,
                                arch_batch, assert_drops_equal, mesh_of,
                                params_of, recording_drops, reduced,
                                step_with_grads)

ARCH = "deepseek-v2-lite-16b"
CPU = torch.device("cpu")
# flagged against the same mesh without the flag, in float32 (relative:
# the norm of the difference over the norm): only the expert weights'
# gradients reassociate, summed over the data ranks' slots
REL_TOL = 1e-5
SPLIT = [(2, 2), (2, 1)]
# decode on model (the card phase's gates): float32 within 1e-4 of one device;
# bfloat16 no further from one device's float32 logits than 1.5 times
# one device's own bfloat16 logits are
DECODE_F32_TOL, DECODE_BF16_SLACK = 1e-4, 1.5
DECODE_B = 8


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (see ``tests/test_torch_dp_rows.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b) -> float:
    return ((a.float() - b.float()).norm()
            / b.float().norm().clamp_min(1e-30)).item()


def placed(model, mesh):
    specs = ts.params_shardings(model, mesh)
    return {n: ts.shard(p, specs[n], mesh)
            for n, p in model.named_parameters()}


def flagged(dtype="float32", flag=True):
    return build_model(reduced(ARCH, dtype, moe_dispatch_shard=flag))


def prefill(bundle, mesh, batch):
    """The prefill step's logits on ``mesh`` (one device without it) and
    the MoE drops of its routings."""
    model = bundle.init(0, CPU)
    with recording_drops() as drops:
        if mesh is None:
            logits = steps.make_prefill_step(bundle)(model, batch)
        else:
            logits = steps.make_prefill_step(bundle, mesh)(
                placed(model, mesh), batch)
    return logits, drops


@pytest.mark.parametrize("shape", SPLIT, ids=["2x2", "2x1"])
def test_f32_step_and_prefill_within_1e5_of_the_unflagged_mesh(shape):
    """Float32: the flagged step's loss and every gradient, and the
    prefill logits, within ``REL_TOL`` (relative) of the same mesh's
    without the flag, every routing's dropped choices equal (and equal to
    one device's)."""
    mesh = mesh_of(*shape)
    batch = arch_batch(flagged().cfg)
    assert ffn.moe_capacity(flagged().cfg, 4 * 8) == 10
    runs = {}
    for flag in (False, True):
        bundle = flagged(flag=flag)
        _, m, grads, drops = step_with_grads(bundle, batch, mesh)
        runs[flag] = (m, grads, drops, *prefill(bundle, mesh, batch))
    (m0, g0, d0, l0, p0), (m1, g1, d1, l1, p1) = runs[False], runs[True]
    assert rel(m1["loss"], m0["loss"]) < REL_TOL
    for n, g in g0.items():
        assert rel(g1[n], g) < REL_TOL, n
    assert rel(l1, l0) < REL_TOL
    assert_drops_equal(d0, d1, 1)
    assert_drops_equal(p0, p1, 1)
    _, _, _, one = step_with_grads(flagged(), batch)
    assert_drops_equal(one, d1, shape[0] * shape[1])


@pytest.mark.parametrize("shape", SPLIT, ids=["2x2", "2x1"])
def test_bf16_step_within_the_gates_of_one_device(shape):
    """Bfloat16: the flagged step within the reference's gates of one
    device's step (loss 1e-3, step-0 gradient norm 3e-3 relative, every
    parameter 5e-3)."""
    bundle = flagged("bfloat16")
    batch = arch_batch(bundle.cfg)
    one, m1, _, _ = step_with_grads(bundle, batch)
    many, m2, _, _ = step_with_grads(bundle, batch, mesh_of(*shape))
    assert abs(m1["loss"].item() - m2["loss"].item()) < LOSS_TOL
    assert m2["grad_norm"].item() == pytest.approx(m1["grad_norm"].item(),
                                                   rel=NORM_TOL)
    want, got = params_of(one), params_of(many)
    for n, p in want.items():
        assert (got[n] - p).abs().max().item() < PARAM_TOL, n


@pytest.mark.parametrize("shape", [(4, 1), (1, 2), None],
                         ids=["4x1", "1x2", "one-device"])
def test_unsplit_slots_are_bitwise_the_unflagged_step(shape):
    """Where the flag splits nothing (4 data ranks do not divide capacity
    10; ``(1, 2)`` splits no rows; one device), the flagged step (loss,
    gradient norm, parameters) and prefill are bitwise the unflagged
    ones."""
    mesh = None if shape is None else mesh_of(*shape)
    out = []
    for flag in (False, True):
        bundle = flagged(flag=flag)
        batch = arch_batch(bundle.cfg)
        state, m, _, _ = step_with_grads(bundle, batch, mesh)
        logits, _ = prefill(bundle, mesh, batch)
        out.append((params_of(state), m, logits))
    (p0, m0, l0), (p1, m1, l1) = out
    for k in ("loss", "grad_norm"):
        assert torch.equal(m0[k], m1[k]), k
    assert torch.equal(l0, l1)
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


def slot_bytes(bundle, shape, tokens) -> int:
    """The bytes of one model rank's slot outputs [E / T, cap, D] of one
    MoE layer's routing of ``tokens`` tokens."""
    cfg = bundle.cfg
    return (cfg.n_experts // shape[1] * ffn.moe_capacity(cfg, tokens)
            * cfg.d_model * torch.finfo(getattr(torch, cfg.dtype)).bits // 8)


@pytest.mark.parametrize("shape", SPLIT, ids=["2x2", "2x1"])
def test_slot_gather_is_tallied_only_with_the_flag(shape):
    """Rank 0's tally of a train step: with the flag its all-gathers grow
    by each MoE layer's slot outputs, once a microbatch (the forward),
    and its reduce-scatters by their share (the backward); nothing else
    moves."""
    mesh = mesh_of(*shape)
    tallies = []
    for flag in (False, True):
        bundle = flagged(flag=flag)
        batch = arch_batch(bundle.cfg)
        state = steps.init_state(bundle, 0, CPU, mesh=mesh)
        step = steps.make_train_step(bundle, OPT, mesh=mesh)
        step(state, batch)
        tallies.append(step.compute.tallies[0].bytes)
    n_moe = sum(isinstance(layer.ffn, ffn.MoEFFN)
                for layer in bundle.init(0, CPU).layers())
    per = slot_bytes(bundle, shape, 4 * 8) * n_moe * 2
    want = dict(tallies[0])
    want[("all-gather", "forward")] += per
    want[("reduce-scatter", "backward")] += per // shape[0]
    assert n_moe and dict(tallies[1]) == want


@pytest.mark.parametrize("data,model", [(2, 2), (4, 1), (4, 2), (2, 1)])
@pytest.mark.parametrize("tokens", [32, 64, 128, 8])
def test_slots_split_is_where_resolve_keeps_dp(data, model, tokens):
    """``slots_split`` with rows split over every data rank is where the
    reference's ``("model", "dp", None)`` on [E, cap, D] resolves with dp
    on the slot axis; without the flag, never."""
    cfg = reduced(ARCH, moe_dispatch_shard=True)
    mesh = Mesh.on(CPU, (data, model), ("data", "model"))
    cap = ffn.moe_capacity(cfg, tokens)
    spec = ts.resolve((cfg.n_experts, cap, cfg.d_model),
                      ("model", "dp", None), mesh)
    assert ffn.slots_split(cfg, tokens, data) == (spec[1] is not None)
    assert not ffn.slots_split(dataclasses.replace(
        cfg, moe_dispatch_shard=False), tokens, data)


def decode_loop(bundle, model, mesh, tokens, n_len=8):
    """Teacher-forced decode of ``tokens``: each step's logits (on one
    device, or on ``mesh``), the MoE drops and the mesh step's tally."""
    B, n = tokens.shape
    cache = bundle.init_cache(B, n_len, device=CPU)
    params, step = model, bundle.decode_step
    if mesh is not None:
        cache = ts.shard_cache(cache, mesh)
        params, serve = placed(model, mesh), steps.make_serve_step(bundle,
                                                                   mesh)

        def step(p, c, tok, t):
            return serve(p, c, {"tokens": tok, "pos": t})
    out = []
    with recording_drops() as drops:
        for t in range(n):
            logits, cache = step(params, cache,
                                 torch.as_tensor(tokens[:, t:t + 1]), t)
            out.append(logits.float())
    return out, drops, (serve.compute.tallies[0] if mesh is not None
                        else None)


def test_decode_on_2x2_within_the_gates_of_one_device():
    """Batch 8 decodes with capacity 2, which the 2 data ranks divide: each
    group runs one slot of each of its experts.  Float32 within
    ``DECODE_F32_TOL`` of one device at every step, within ``REL_TOL`` of
    the unflagged mesh, its drops equal one device's; bfloat16 no further
    from one device's float32 logits than ``DECODE_BF16_SLACK`` times one
    device's bfloat16 logits; the tally holds the slots' all-gather."""
    assert ffn.moe_capacity(flagged().cfg, DECODE_B) == 2
    mesh = mesh_of(2, 2)
    tokens = np.random.default_rng(4).integers(0, flagged().cfg.vocab,
                                               (DECODE_B, 5))
    model = flagged().init(0, CPU)
    one32, d_one, _ = decode_loop(flagged(), model, None, tokens)
    got32, d_got, t1 = decode_loop(flagged(), model, mesh, tokens)
    base32, _, t0 = decode_loop(flagged(flag=False), model, mesh, tokens)
    for a, b, c in zip(one32, got32, base32):
        assert (a - b).abs().max().item() < DECODE_F32_TOL
        assert rel(b, c) < REL_TOL
    assert_drops_equal(d_one, d_got, 4)
    assert sum(int(d.sum()) for d in d_one) > 0
    assert (t1.bytes[("all-gather", "forward")]
            > t0.bytes[("all-gather", "forward")])
    b16 = flagged("bfloat16")
    model16 = b16.init(0, CPU)
    one16, _, _ = decode_loop(b16, model16, None, tokens)
    got16, _, _ = decode_loop(b16, model16, mesh, tokens)
    own = max((a - b).abs().max().item() for a, b in zip(one32, one16))
    err = max((a - b).abs().max().item() for a, b in zip(one32, got16))
    assert err <= DECODE_BF16_SLACK * own, (err, own)


def test_flagged_2x2_step_matches_the_reference_f32():
    """The flagged ``(2, 2)`` float32 step's loss and gradients (rows 2 x
    16, one microbatch: capacity 10, a slot share of 5 on each data rank)
    against the JAX reference's single-device loss and gradients on the
    same weights (``params_from_jax``), at the tolerances of
    ``tests/test_torch_train.py::test_loss_and_grads_match_the_reference_
    f32``; in the reference the flag is an annotation that changes no
    number."""
    from test_torch_train import (GRAD, LOSS_RTOL, assert_tree_close,
                                  configs, make_batch, port_batch,
                                  port_model, ref_params, ref_value_and_grad)

    cfg, _ = configs(ARCH, moe_dispatch_shard=True)
    bundle = build_model(cfg)
    batch = make_batch(cfg)
    want_loss, want_grads = ref_value_and_grad(ARCH, moe_dispatch_shard=True)
    model = port_model(bundle, ref_params(ARCH))
    mesh = mesh_of(2, 2)
    compute = steps.MeshCompute(bundle, mesh)
    tokens = batch["tokens"].size
    assert compute.owner_ranks(port_batch(batch), 1) == [(0, 1)]
    assert ffn.slots_split(cfg, tokens, 2)
    loss, grads = compute.loss_and_grads(placed(model, mesh),
                                         port_batch(batch), 1)
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               rtol=LOSS_RTOL)
    assert_tree_close(bundle, {n: None if g is None else g.whole()
                               for n, g in grads.items()},
                      want_grads, GRAD, "flagged (2, 2)")
