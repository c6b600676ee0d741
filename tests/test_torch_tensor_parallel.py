"""The port's tensor-parallel compute over the ``model`` axis
(``repro_torch/distributed/tensor_parallel.py``) on meshes of repeated CPU
devices, against the port's own whole layers and single-device step on the
same inputs (numpy-seeded batches, ``torch.Generator``-seeded weights):

- every layer family (GQA attention with and without biases, local and
  M-RoPE attention, MLA, RG-LRU, SSD, dense SwiGLU / GeGLU, MoE with
  shared experts, the encoder, decoder and cross-attention layers) and the
  vocabulary-parallel embedding, head and cross-entropy, forward and
  backward on ``(1, 2)`` and ``(1, 4)`` against the whole layer, in
  float32 within ``LAYER_TOL``;
- the train step of each reduced arch on ``(data 2, model 2)`` against the
  single-device step: loss within 1e-3 and parameters within 5e-3 (the
  reference's gates, ``tests/test_sharding_multidev.py:113-117``), and in
  float32 also the loss, gradient norm and parameter change within the
  float32 gates of ``tests/test_torch_sharding_multidev.py``;
- the bitwise invariants: ``(1, T)`` equals ``(4, T)`` for a batch whose
  microbatch rows 4 data ranks do not divide (within the gates for one
  they split), a repeated step equals itself;
- the dry-run: the whole group's counted FLOPs equal the sum of the
  per-rank counts, and ``step_collectives``' all-reduce bytes equal the
  group's tally of a CPU step;
- the prefill step on a mesh, the layer rule (layers whose heads do not
  divide run whole) and ``Grad``'s blocks.

The reference's sharded step itself is compared in
``tests/test_torch_sharding_multidev.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.distributed import sharding as ts
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import dryrun, steps
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import Mesh
from repro_torch.models import encdec, lm
from repro_torch.models.layers import trainable
from repro_torch.models.registry import build_model, input_specs
from repro_torch.optim.adamw import AdamWConfig

CPU = torch.device("cpu")
OPT = AdamWConfig(lr=1e-3, warmup_steps=0)
LOSS_TOL, PARAM_TOL = 1e-3, 5e-3
F32_LOSS_TOL, F32_NORM_TOL, F32_CHANGE_TOL = 1e-5, 1e-5, 1e-4
# a split layer against the whole one in float32: the row-parallel sums
# (and the split softmax and norm sums) reassociate
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: a tensor-parallel step of a reduced arch is
    thousands of small ops, and with the suite's parallel workers each
    spreading every op over all cores, they spent 40x longer waiting for
    each other than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduced(arch, dtype="float32", **over):
    return dataclasses.replace(reduce_config(ARCHS[arch]), microbatches=2,
                               dtype=dtype, **over)


def mesh_of(data, model):
    return Mesh.on(CPU, (data, model), ("data", "model"))


def arch_batch(cfg, rows=8, seq=8, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.n_enc_layers:
        return {"frames": torch.as_tensor(rng.normal(
                    size=(rows, seq, cfg.d_model)).astype(np.float32)),
                "tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                       (rows, seq)))}
    if cfg.frontend_prefix > 0:
        lp = int(seq * cfg.frontend_prefix)
        pos = np.broadcast_to(np.arange(seq)[None, :, None], (rows, seq, 3))
        return {"embeds": torch.as_tensor(rng.normal(
                    size=(rows, lp, cfg.d_model)).astype(np.float32)),
                "tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                       (rows, seq - lp))),
                "positions": torch.as_tensor(pos.copy())}
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                   (rows, seq)))}


def group_of(bundle, model, T):
    """The model's weights placed on ``(1, T)`` and every rank's bound
    local replica: (group, {rank: local model}, MeshCompute)."""
    mesh = mesh_of(1, T)
    specs = ts.params_shardings(model, mesh)
    params = {n: ts.shard(p, specs[n], mesh)
              for n, p in model.named_parameters()}
    compute = steps.MeshCompute(bundle, mesh)
    group = compute.group(0)
    return group, compute.bound({0: group}, params)[1][0], compute


def lm_layer(group, layers, x, positions):
    """``lm.layer_runs_tp`` on one group holding every row."""
    run = tp.Run(0, group, layers, {}, slice(None))
    return lm.layer_runs_tp([run], {0: layers}, {0: x}, {0: positions},
                            1)[0]


def whole_grads(compute, names, grads_by_rank):
    """Each named leaf's gradient assembled from the ranks' local ones."""
    shapes = {n: s for n, s in names.items()}
    pieces = tp.piece_grads(
        [(g, compute.plan(m).splits) for m, g in enumerate(grads_by_rank)],
        shapes)
    return {n: g.whole() if g is not None else None
            for n, g in pieces.items()}


def close(a, b, what):
    assert a.shape == b.shape, what
    assert torch.allclose(a, b, **LAYER_TOL), (
        what, (a - b).abs().max().item())


def layer_cases(model):
    """(prefix, kind) of every layer: "dec" layers take an encoder
    output."""
    if isinstance(model, encdec.EncDec):
        return ([(f"enc_layers.{i}", "enc")
                 for i in range(len(model.enc_layers))]
                + [(f"dec_layers.{i}", "dec")
                   for i in range(len(model.dec_layers))])
    n_cyc = len(model.cycles)
    names = [f"cycles.{c}.layer{j}" for c in range(n_cyc)
             for j in range(len(model.cfg.mixer_pattern))]
    return [(n, "lm") for n in names] + [(f"tail.{i}", "lm")
                                         for i in range(len(model.tail))]


@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_layers_match_the_whole_layer(arch, T):
    """Every layer of reduced ``arch`` split over a group of T ranks:
    output, input gradient and every weight's gradient (assembled from
    the ranks' blocks) equal the whole layer's within ``LAYER_TOL``; then
    the whole loss (the vocabulary-parallel embedding, head and
    cross-entropy) and every parameter's gradient."""
    cfg = reduced(arch)
    bundle = build_model(cfg)
    model = trainable(bundle.init(0, CPU))
    group, local, compute = group_of(bundle, model, T)
    assert compute.plan(0).whole == []
    gen = torch.Generator().manual_seed(1)
    B, L, D = 2, 8, cfg.d_model
    for prefix, kind in layer_cases(model):
        layer = model.get_submodule(prefix)
        ranks = {m: local[m].get_submodule(prefix) for m in local}
        x = torch.randn((B, L, D), generator=gen).requires_grad_()
        w = torch.randn((B, L, D), generator=gen)
        pos = torch.arange(L).expand(B, L)
        if cfg.mrope_sections:
            pos = pos[..., None].expand(B, L, 3)
        enc = torch.randn((B, 6, D), generator=gen).requires_grad_()
        dec = kind == "dec"
        y = layer(x, pos, enc) if dec else layer(x, pos)
        names = [n for n, _ in layer.named_parameters()]
        want = torch.autograd.grad((y * w).sum(), ([x, enc] if dec else [x])
                                   + [p for _, p in layer.named_parameters()])
        x2 = x.detach().clone().requires_grad_()
        enc2 = enc.detach().clone().requires_grad_()
        run = {"lm": lm_layer, "enc": encdec.enc_layer_tp,
               "dec": encdec.dec_layer_tp}[kind]
        extra = ({m: enc2 for m in local},) if dec else ()
        y2 = run(group, ranks, {CPU: x2}, {CPU: pos}, *extra)[CPU]
        close(y2, y, f"{prefix} output")
        inputs = [x2, enc2] if dec else [x2]
        local_params = [[p for _, p in ranks[m].named_parameters()]
                        for m in local]
        got = torch.autograd.grad((y2 * w).sum(), inputs + sum(
            local_params, []), allow_unused=True)
        for i, t in enumerate(inputs):
            close(got[i], want[i], f"{prefix} input {i} gradient")
        got = list(got[len(inputs):])
        by_rank = []
        for m in local:
            n_local = len(local_params[m])
            by_rank.append({f"{prefix}.{n}": g for n, g in zip(
                [n for n, _ in ranks[m].named_parameters()], got[:n_local])})
            got = got[n_local:]
        full = whole_grads(compute, {f"{prefix}.{n}": p.shape
                                     for n, p in layer.named_parameters()},
                           by_rank)
        for n, g in zip(names, want[len(inputs):]):
            close(full[f"{prefix}.{n}"], g, f"{prefix}.{n} gradient")
    # the whole loss: embedding, every layer, head and cross-entropy
    batch = arch_batch(cfg)
    loss = bundle.loss(model, batch)
    want = torch.autograd.grad(loss, list(model.parameters()))
    loss2 = tp.step_loss(bundle, compute.runs({0: group}, {0: local}, batch,
                                              (0,)), 1)
    assert abs(loss2.item() - loss.item()) < F32_LOSS_TOL
    named = [list(local[m].named_parameters()) for m in local]
    got = list(torch.autograd.grad(loss2, [p for ps in named for _, p in ps],
                                   allow_unused=True))
    by_rank = []
    for ps in named:
        by_rank.append({n: g for (n, _), g in zip(ps, got)})
        got = got[len(ps):]
    full = whole_grads(compute, {n: p.shape for n, p in
                                 model.named_parameters()}, by_rank)
    for (n, _), g in zip(model.named_parameters(), want):
        close(full[n], g, f"{n} gradient of the loss")


def one_step(bundle, batch, mesh=None, state=None):
    state = state or steps.init_state(bundle, 0, CPU, mesh=mesh)
    _, metrics = steps.make_train_step(bundle, OPT, mesh=mesh)(state, batch)
    return state, metrics


def params_of(state):
    p = state["params"]
    if isinstance(p, torch.nn.Module):
        return {n: t.detach() for n, t in p.named_parameters()}
    return {n: ts.unshard(leaf, CPU) for n, leaf in p.items()}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_tp_step_matches_the_single_device_step(arch, dtype):
    """One step of reduced ``arch`` (two microbatches of 4 rows) on
    ``(data 2, model 2)``: the loss within 1e-3 and every parameter
    within 5e-3 of the single-device step; in float32 the loss within
    ``F32_LOSS_TOL``, the gradient norm within ``F32_NORM_TOL`` (relative)
    and each parameter's change within ``F32_CHANGE_TOL``."""
    cfg = reduced(arch, dtype)
    bundle = build_model(cfg)
    batch = arch_batch(cfg)
    init = params_of(steps.init_state(bundle, 0, CPU))
    single, m1 = one_step(bundle, batch)
    sharded, m2 = one_step(bundle, batch, mesh_of(2, 2))
    f32 = dtype == "float32"
    assert abs(m1["loss"].item() - m2["loss"].item()) < (
        F32_LOSS_TOL if f32 else LOSS_TOL)
    if f32:
        assert m2["grad_norm"].item() == pytest.approx(
            m1["grad_norm"].item(), rel=F32_NORM_TOL)
    want, got = params_of(single), params_of(sharded)
    assert set(want) == set(got)
    for n, p in want.items():
        assert (got[n] - p).abs().max().item() < PARAM_TOL, n
        if f32:
            change = (got[n] - init[n]) - (p - init[n])
            assert change.abs().max().item() < F32_CHANGE_TOL, n


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b",
                                  "mamba2-780m", "seamless-m4t-medium"])
def test_step_is_bitwise_the_same_for_every_data_size(arch):
    """For T = 2 and a batch of 6 rows (microbatches of 3, which 4 data
    ranks do not divide: each runs whole on one model group) the step on
    ``(1, 2)`` and on ``(4, 2)`` is bitwise the same (loss, gradient
    norm, parameters, both moments), and a repeated step from the same
    state is bitwise itself.  A batch of 8 rows (microbatches of 4) splits
    its rows over the 4 data ranks: the ``(4, 2)`` step is within the
    reference's gates of the ``(1, 2)`` one (loss 1e-3, parameters
    5e-3)."""
    cfg = reduced(arch, "bfloat16")
    bundle = build_model(cfg)
    batch = arch_batch(cfg, rows=6)
    a, ma = one_step(bundle, batch, mesh_of(1, 2))
    b, mb = one_step(bundle, batch, mesh_of(4, 2))
    c, mc = one_step(bundle, batch, mesh_of(1, 2))
    for k in ("loss", "grad_norm", "lr"):
        assert torch.equal(ma[k], mb[k]) and torch.equal(ma[k], mc[k]), k
    for group in ("mu", "nu"):
        for n, leaf in a["opt"][group].items():
            assert torch.equal(ts.unshard(leaf, CPU),
                               ts.unshard(b["opt"][group][n], CPU)), n
    pa, pb, pc = params_of(a), params_of(b), params_of(c)
    for n in pa:
        assert torch.equal(pa[n], pb[n]) and torch.equal(pa[n], pc[n]), n
    batch = arch_batch(cfg)
    assert steps.MeshCompute(bundle, mesh_of(4, 2)).owner_ranks(
        batch, cfg.microbatches) == [(0, 1, 2, 3)] * 2
    a, ma = one_step(bundle, batch, mesh_of(1, 2))
    b, mb = one_step(bundle, batch, mesh_of(4, 2))
    assert abs(ma["loss"].item() - mb["loss"].item()) < LOSS_TOL
    pa, pb = params_of(a), params_of(b)
    for n in pa:
        assert (pa[n] - pb[n]).abs().max().item() < PARAM_TOL, n


@pytest.mark.parametrize("arch", list(ARCHS))
def test_whole_group_count_is_the_sum_of_rank_counts(arch):
    """On the ``(1, 2)`` meta mesh the counted FLOPs of the whole group's
    train step (``make_train_step(..., mesh=)``, both ranks' ops) equal
    the sum of the dry-run's two per-rank counts, and so does a prefill's;
    each rank's count is about half the whole model's."""
    cfg = reduced(arch, "bfloat16")
    mesh = Mesh.on("meta", (1, 2), ("data", "model"))
    bundle = build_model(cfg)
    for shape in (ShapeConfig("t", 16, 4, "train"),
                  ShapeConfig("p", 16, 4, "prefill")):
        counts = [dryrun.count_cell(cfg, shape, mesh, model_rank=m)
                  for m in range(2)]
        specs = input_specs(cfg, shape)
        if shape.kind == "train":
            state = steps.abstract_state(bundle, mesh)
            step = steps.make_train_step(bundle, OPT, mesh=mesh)
            whole = rl.step_cost(step, state, specs)
        else:
            model = bundle.abstract_params()
            specs_p = ts.params_shardings(model, mesh)
            params = {n: ts.shard(p, specs_p[n], mesh)
                      for n, p in model.named_parameters()}
            whole = rl.step_cost(steps.make_prefill_step(bundle, mesh),
                                 params, specs)
        assert whole["flops"] == sum(c["cost"]["flops"] for c in counts)
        assert all(c["busiest"]["model_group"] == 2
                   and c["busiest"]["whole_layers"] == [] for c in counts)
        one = dryrun.count_cell(cfg, shape, Mesh.on(
            "meta", (1, 1), ("data", "model")))
        assert counts[0]["cost"]["flops"] < 0.75 * one["cost"]["flops"]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b",
                                  "mamba2-780m", "seamless-m4t-medium"])
def test_step_collectives_all_reduce_is_the_group_tally(arch):
    """A CPU step on ``(1, 2)`` tallies its activation all-reduces per
    rank; the dry-run's counted rank tallies the same bytes (forward with
    the recomputes, backward), and ``step_collectives``' all-reduce is
    the gradient all-reduce of the replicated leaves plus that tally."""
    cfg = reduced(arch, "bfloat16", remat="full")
    bundle = build_model(cfg)
    shape = ShapeConfig("t", 8, 8, "train")
    rng = np.random.default_rng(0)
    # the dry-run's inputs (seamless: 8 frames, 128 target tokens), filled
    batch = {n: torch.as_tensor(rng.integers(0, cfg.vocab, tuple(t.shape))
                                if n == "tokens" else rng.normal(
                                    size=tuple(t.shape)).astype(np.float32))
             for n, t in input_specs(cfg, shape).items()}
    mesh = mesh_of(1, 2)
    state = steps.init_state(bundle, 0, CPU, mesh=mesh)
    compute = steps.MeshCompute(bundle, mesh)
    compute.loss_and_grads(state["params"], batch, cfg.microbatches)
    tally = compute.tallies[0]
    assert tally.total("all-reduce") > 0
    meta = Mesh.on("meta", (1, 2), ("data", "model"))
    counted = dryrun.count_cell(cfg, shape, meta)
    assert counted["tp_collectives"] == tally.as_dict()
    abstract = steps.abstract_state(bundle, meta)
    grad_ar = rl.step_collectives(meta, abstract, compute.plan(0).splits,
                                  (0, 0))["all-reduce"]
    assert counted["collectives"]["all-reduce"] == grad_ar + tally.total(
        "all-reduce")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-9b",
                                  "deepseek-v2-lite-16b",
                                  "seamless-m4t-medium"])
def test_prefill_on_a_mesh_matches_the_single_device_prefill(arch):
    cfg = reduced(arch)
    bundle = build_model(cfg)
    batch = arch_batch(cfg)
    model = bundle.init(0, CPU)
    want = steps.make_prefill_step(bundle)(model, batch)
    mesh = mesh_of(2, 4)
    specs = ts.params_shardings(model, mesh)
    params = {n: ts.shard(p, specs[n], mesh)
              for n, p in model.named_parameters()}
    got = steps.make_prefill_step(bundle, mesh)(params, batch)
    assert got.shape == want.shape == (8, cfg.padded_vocab)
    assert torch.allclose(got, want, **LAYER_TOL)


def test_layer_rule_runs_unsplittable_layers_whole():
    """On a ``model`` axis of 8 reduced phi3's 4 heads do not divide: its
    attention runs whole on the group's device (named by the plan and the
    dry-run), its FFN and vocabulary still split, and the step stays
    within the float32 gates of the single-device step."""
    cfg = reduced("phi3-mini-3.8b")
    bundle = build_model(cfg)
    mesh = mesh_of(1, 8)
    plan = tp.local_model(bundle, mesh, 3)
    assert plan.whole == ["cycles.0.layer0.mixer", "cycles.1.layer0.mixer"]
    assert plan.splits["cycles.0.layer0.ffn.w_up"] == tp.Split(
        1, ((48, 64),))
    assert plan.splits["embed"] == tp.Split(0, ((96, 128),))
    batch = arch_batch(cfg)
    _, m1 = one_step(bundle, batch)
    _, m2 = one_step(bundle, batch, mesh)
    assert abs(m1["loss"].item() - m2["loss"].item()) < F32_LOSS_TOL
    assert m2["grad_norm"].item() == pytest.approx(m1["grad_norm"].item(),
                                                   rel=F32_NORM_TOL)
    counted = dryrun.count_cell(cfg, ShapeConfig("t", 16, 4, "train"),
                                Mesh.on("meta", (1, 8), ("data", "model")))
    assert counted["busiest"]["whole_layers"] == plan.whole


@pytest.mark.parametrize("arch,leaf,want", [
    # qwen2.5-3b, 16 heads over 2 kv heads on 16 ranks: rank 9's one q
    # head reads kv head 1
    ("qwen2.5-3b", "cycles.0.layer0.mixer.wk", tp.Split(1, ((128, 256),))),
    ("qwen2.5-3b", "cycles.0.layer0.mixer.wq", tp.Split(1, ((1152, 1280),))),
    # mamba2-780m: rank 9's 3 of 48 heads: z, x, B and C, dt columns
    ("mamba2-780m", "cycles.9.layer0.mixer.w_in", tp.Split(1, (
        (1728, 1920), (4800, 4992), (6144, 6400), (6427, 6430)))),
    ("deepseek-v2-lite-16b", "cycles.1.layer0.ffn.w_down",
     tp.Split(0, ((36, 40),))),
    ("deepseek-v2-lite-16b", "cycles.1.layer0.ffn.shared.w_up",
     tp.Split(1, ((1584, 1760),))),
    ("recurrentgemma-9b", "cycles.0.layer0.mixer.lam",
     tp.Split(0, ((2304, 2560),))),
])
def test_production_plan_splits(arch, leaf, want):
    """Compute blocks of model rank 9 on the 16 x 16 mesh at the published
    widths (kv heads shared by a rank's queries; SSD's z, x, dt of its
    heads with B and C whole; 4 of 64 experts; the shared experts' and
    RG-LRU's columns); no layer of the ten archs runs whole there."""
    mesh = Mesh.on("meta", (16, 16), ("data", "model"))
    plan = tp.local_model(build_model(ARCHS[arch]), mesh, 9)
    assert plan.splits[leaf] == want
    assert plan.whole == []
    p = dict(plan.model.named_parameters())[leaf]
    full = dict(build_model(ARCHS[arch]).abstract_params()
                .named_parameters())[leaf]
    assert tuple(p.shape) == want.local_shape(full.shape)


def test_grad_blocks_cut_across_pieces():
    """``Grad.block`` of a region inside one piece is a view of it, one
    across pieces their concatenation, and a part no piece covers is
    zero."""
    a = torch.arange(12.).reshape(3, 4)
    b = torch.arange(12., 20.).reshape(2, 4)
    g = tp.Grad((6, 4), 0, [(0, 3, a), (4, 6, b)])
    assert g.block((slice(1, 3), slice(0, 4))).data_ptr() == a[1].data_ptr()
    got = g.block((slice(2, 6), slice(1, 3)))
    want = torch.cat([a[2:, 1:3], torch.zeros(1, 2), b[:, 1:3]])
    assert torch.equal(got, want)
    assert torch.equal(g.whole()[3], torch.zeros(4))


def test_compressed_step_takes_whole_gradients_on_a_model_group():
    """``launch/train.py``'s ``--compress-grads`` step on ``(1, 2)``: each
    leaf's gradient is assembled whole before its int8 error feedback
    (one scale a leaf, as the reference's), the error-feedback state
    keeps whole leaves, and the step stays within the float32 gates of
    the same step on ``(1, 1)``."""
    from repro_torch.launch.train import compressed_train_step
    from repro_torch.optim.compression import ef_init

    cfg = reduced("qwen2.5-3b")
    bundle = build_model(cfg)
    batch = arch_batch(cfg)
    out = []
    for mesh in (mesh_of(1, 1), mesh_of(1, 2)):
        state = steps.init_state(bundle, 0, CPU, mesh=mesh)
        state["ef"] = ef_init(state["params"])
        _, m = compressed_train_step(bundle, OPT, mesh)(state, batch)
        assert all(tuple(e.shape) == state["params"][n].shape
                   for n, e in state["ef"].items())
        out.append((m, params_of(state)))
    (m1, p1), (m2, p2) = out
    assert abs(m1["loss"].item() - m2["loss"].item()) < F32_LOSS_TOL
    assert m2["grad_norm"].item() == pytest.approx(m1["grad_norm"].item(),
                                                   rel=1e-3)
    for n in p1:
        assert (p1[n] - p2[n]).abs().max().item() < PARAM_TOL, n
