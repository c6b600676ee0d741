"""``chip_smoke.py``'s work counts of the dense GEMM calls it times, on
``meta`` tensors (shapes only, no data and no card): the bytes each call
must move (inputs read once, output written once), its FLOPs, and whether
the card's FP32 rate or its memory rate bounds it; the choice of the
scatter launch it times on compiled GIN-CO; and, on the CPU, the naming
of a profiled op by the line of the port that made it."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    """One intra-op thread for the LM rehearsals: their tensor-parallel
    steps are thousands of small ops, and with the suite's parallel
    workers each spreading every op over all cores, they spent 40x longer
    waiting for each other than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


# (kernel, x shape, y shape, bytes, FLOPs, bound_by, bound ms at the H100
# peaks): compiled GCN-FL's layer-1 update and logits layer (89,250
# vertices, 500 features, hidden 128, 7 classes), the dense queue's
# stacked batch (8 x 11264 x 500) through gemm_batch and through the
# scatter at the caller's k (the tile coordinates add 8 B a task), and
# compiled GIN-CO's largest scatter launch (one 384-row tile, K 2708)
CASES = [
    ("gemm", (89250, 500), (500, 128),
     4 * (89250 * 500 + 500 * 128 + 89250 * 128), 2.0 * 89250 * 500 * 128,
     "operations", 0.170507),
    ("gemm", (89250, 128), (128, 7),
     4 * (89250 * 128 + 128 * 7 + 89250 * 7), 2.0 * 89250 * 128 * 7,
     "bytes", 0.014388),
    ("gemm_batch", (8, 11264, 500), (8, 500, 128),
     4 * (8 * 11264 * 500 + 8 * 500 * 128 + 8 * 11264 * 128),
     2.0 * 8 * 11264 * 500 * 128, "operations", 0.172154),
    ("gemm_batch_scatter", (8, 11264, 500), (8, 500, 128),
     4 * (8 * 11264 * 500 + 8 * 500 * 128 + 8 * 11264 * 128) + 8 * 8,
     2.0 * 8 * 11264 * 500 * 128, "operations", 0.172154),
    ("gemm_batch_scatter", (1, 384, 2708), (1, 2708, 16),
     4 * (384 * 2708 + 2708 * 16 + 384 * 16) + 8, 2.0 * 384 * 2708 * 16,
     "bytes", 0.001301),
]


def _scatter_args(xs, ys, canvas_rows):
    t = xs[0]
    rows = torch.empty((t,), dtype=torch.int32, device="meta")
    return (_meta(*xs), _meta(*ys), rows, rows,
            _meta(canvas_rows, ys[2]))


@pytest.mark.parametrize("name,xs,ys,nbytes,flops,by,ms", CASES,
                         ids=["gemm-l1-update", "gemm-logits",
                              "gemm_batch-dense-queue",
                              "gemm_batch_scatter-dense-queue",
                              "gemm_batch_scatter-gin-co-l1-mlp1"])
def test_gemm_work_and_bound(smoke, name, xs, ys, nbytes, flops, by, ms):
    args = ((_meta(*xs), _meta(*ys)) if name != "gemm_batch_scatter"
            else _scatter_args(xs, ys, xs[0] * xs[1]))
    kw = {"out_dtype": torch.float32} if name == "gemm" else {}
    assert smoke.work_of(name, args, kw) == (nbytes, flops)
    bound = smoke.bound_of(name, args, kw)
    assert bound["bound_by"] == by
    assert (bound["bytes"], bound["flops"]) == (nbytes, flops)
    want_ms = 1e3 * max(nbytes / smoke.PEAK_HBM_BYTES,
                        flops / smoke.PEAK_FP32_FLOPS)
    assert bound["bound_ms"] == pytest.approx(want_ms, rel=1e-12)
    assert bound["bound_ms"] == pytest.approx(ms, abs=1e-6)


def test_bf16_output_halves_the_output_bytes(smoke):
    x, y = _meta(89250, 128), _meta(128, 7)
    f32, _ = smoke.work_of("gemm", (x, y), {"out_dtype": torch.float32})
    bf16, _ = smoke.work_of("gemm", (x, y), {"out_dtype": torch.bfloat16})
    assert f32 - bf16 == 2 * 89250 * 7


def test_scatter_timed_call_is_the_largest_block_skip_launch(smoke):
    """Compiled GIN-CO's timed scatter call is the predicated launch (the
    block-skip route's dense queue) with the most FLOPs, not a larger
    unpredicated one."""
    flag = torch.empty((1,), dtype=torch.int32, device="meta")
    call = lambda xs, ys, pred: (_scatter_args(xs, ys, 3072),
                                 {} if pred is None else {"pred": pred})
    calls = [call((1, 384, 9000), (1, 9000, 16), None),
             call((7, 384, 16), (7, 16, 16), (flag, 0)),
             call((1, 384, 2708), (1, 2708, 16), (flag, 0)),
             call((7, 384, 16), (7, 16, 8), (flag, 0))]
    assert smoke.largest_block_skip_call(calls) is calls[2]


def test_port_ranges_name_the_line_that_made_an_op(smoke):
    """Under :class:`PortRanges` the profiler's pad op of ``ops.spdmm``
    (the zero-pad of Y's rows) is named by the line of ``ops.py`` that
    calls ``F.pad``, and an op made outside the port by no line."""
    import inspect

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.kernels.formats import pack_blockcsr

    rng = np.random.default_rng(0)
    dense = rng.normal(size=(16, 12)) * (rng.uniform(size=(16, 12)) < 0.4)
    a = pack_blockcsr(torch.as_tensor(dense, dtype=torch.float32), 8)
    y = torch.as_tensor(rng.normal(size=(12, 5)).astype(np.float32))
    lines, first = inspect.getsourcelines(ops.spdmm)
    pad_line = first + next(i for i, text in enumerate(lines)
                            if "F.pad(" in text)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with smoke.PortRanges(torch):
            ops.spdmm(a, y)
            torch.nn.functional.pad(y, (0, 1))
    pads = [smoke.port_frame(e) for e in prof.events()
            if e.name == "aten::constant_pad_nd"]
    assert pads == [f"kernels/ops.py({pad_line}): spdmm",
                    "(no line of the port)"]


@pytest.mark.parametrize("gemm", [2, 1], ids=["whole", "gemm-missing"])
def test_profile_replay_fails_when_a_captured_kernel_is_missing(
        smoke, monkeypatch, gemm):
    """``profile_replay`` confirms the capture's launches by kernel name:
    a profile whose rows name every captured kernel as many times passes,
    one that lacks a captured ``gemm`` launch raises."""
    rows = ([(300.0, gemm, "void (anonymous namespace)::gemm_kernel<"
              "sgemm_sm90::Wide<128, 16>, true, float, float>(Args)")]
            + [(50.0, 8, "void (anonymous namespace)::spdmm_fused_kernel"
                "<8, 8>((anonymous namespace)::Walk)"),
               (20.0, 3, "void at::native::vectorized_elementwise_kernel")])
    monkeypatch.setattr(smoke, "replay_rows", lambda *a, **k: (rows, 1e-3))
    per_call = {"gemm": 2, "spdmm_fused": 8}
    assert smoke.launches_by_name(rows, per_call) == {"gemm": gemm,
                                                      "spdmm_fused": 8}
    if gemm == 2:
        smoke.profile_replay(torch, None, None, per_call)
    else:
        with pytest.raises(AssertionError, match="the replay ran"):
            smoke.profile_replay(torch, None, None, per_call)


def test_calibration_serving_and_chaos_phases_rehearse_on_the_cpu(
        smoke, monkeypatch):
    """``chip_smoke.py``'s calibration, serving and chaos phases on small
    stand-ins on the CPU (the kernels' plain versions; the calls that need
    the card stubbed): every check of each phase holds."""
    from repro_torch.core import DynasparseEngine
    from repro_torch.data.graphs import load_graph
    from repro_torch.kernels import gemm, ops, spdmm, spmm
    from repro_torch.models import gnn

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(smoke, "require_launched", lambda *a: None)
    monkeypatch.setattr(smoke, "profile_serving", lambda *a: None)
    dev = torch.device("cpu")

    def eager(model, g):
        params = gnn.init_params(model, g.features_dense.shape[1],
                                 g.stats.hidden, g.stats.classes, device=dev)
        eng = DynasparseEngine(literal=True, device=dev)
        gnn.run_inference(model, eng, g.adj, g.features_dense, params,
                          device=dev)
        ref = smoke.plain_logits(torch, gnn, DynasparseEngine, model, g,
                                 g.features_dense, params, dev)
        return dict(engine=eng, params=params, ref=ref)

    fl = load_graph("FL", scale=0.01, device=dev)
    co = load_graph("CO", scale=0.1, device=dev)
    fl_eager, co_eager = eager("GCN", fl), eager("GIN", co)
    mods = {"gemm": gemm, "spdmm": spdmm, "spmm": spmm}
    calib, fl_calib = smoke.drive_calibration(
        torch, gnn, ops, DynasparseEngine, fl, dev, fl_eager, mods)
    assert set(calib) == set(fl_calib) == {"launches", "calls"}
    served = smoke.drive_serving(
        torch, gnn, ops, DynasparseEngine, "GCN-FL serving", "GCN", fl, dev,
        fl_eager, n_requests=8, max_batch=2, min_compiled=3, mods=mods)
    chaos = smoke.drive_chaos(torch, ops, DynasparseEngine, co, dev,
                              co_eager, mods)
    # each new path hands its own operands to the kernel checks: the
    # sweep every kernel it times, the served batch its eager first batch
    # and its compiled body (gemm) at the stacked width, chaos its
    # fault-free batches
    for rec, names in ((calib, ("gemm_batch_scatter", "spdmm_fused",
                                "spmm_fused", "gemm")),
                       (served, ("gemm_batch_scatter", "spdmm_fused",
                                 "gemm")),
                       (chaos, ("spmm_fused", "spdmm_fused"))):
        assert all(rec["calls"][k] for k in names), (names, {
            k: len(v) for k, v in rec["calls"].items()})
    # the calibrated plan follows wall-clock samples of a shared CPU, so
    # which kernels GCN-FL runs under it varies between runs: the run
    # recorded calls, and holds calls of every kernel it launched (the
    # rule chip_smoke.py applies on the card)
    counts = {k: len(v) for k, v in fl_calib["calls"].items()}
    assert sum(counts.values()) > 0, counts
    assert all(counts[k] for k, n in fl_calib["launches"].items() if n), (
        counts, fl_calib["launches"])
    v, f = fl.features_dense.shape
    assert served["calls"]["spdmm_fused"][0][0][1].shape[1] == 2 * f
    assert served["calls"]["gemm"][0][0][0].shape[0] == 2 * v


def test_gnn_serve_restart_rehearses_on_the_cpu(smoke, tmp_path):
    """The restart phase through ``python -m repro_torch.launch.gnn_serve``
    on a small CO stand-in on the CPU: the second run restores the plan
    cache and neither packs nor analyzes."""
    first, second = smoke.drive_restart(str(tmp_path), "--scale", "0.05",
                                        "--device", "cpu")
    assert first["cache"]["packs"] > 0 and first["device"] == "cpu"
    assert second["cache"]["packs"] == second["cache"]["analyzes"] == 0
    assert second["requests"] == 16 and second["compiled_batches"] >= 1


def test_sharded_phase_rehearses_on_the_cpu(smoke, monkeypatch):
    """``chip_smoke.py``'s sharded phase and mesh serving on small
    stand-ins on the CPU (the kernels' plain versions; the four shards
    share the CPU; the calls that need the card stubbed): every check
    holds, and each path records the kernel calls the summary holds
    against the plain versions."""
    from repro_torch.core import DynasparseEngine
    from repro_torch.data.graphs import load_graph
    from repro_torch.kernels import gemm, ops, spdmm, spmm
    from repro_torch.models import gnn

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(smoke, "require_launched", lambda *a: None)
    monkeypatch.setattr(smoke, "profile_serving", lambda *a: None)
    for name in ("profile_exchange", "profile_replay", "copy_sources",
                 "time_shard_calls"):
        monkeypatch.setattr(smoke, name, lambda *a, **k: None)
    dev = torch.device("cpu")

    def eager(model, g):
        params = gnn.init_params(model, g.features_dense.shape[1],
                                 g.stats.hidden, g.stats.classes, device=dev)
        eng = DynasparseEngine(literal=True, device=dev)
        gnn.run_inference(model, eng, g.adj, g.features_dense, params,
                          device=dev)
        ref = smoke.plain_logits(torch, gnn, DynasparseEngine, model, g,
                                 g.features_dense, params, dev)
        return dict(engine=eng, params=params, ref=ref,
                    calls=smoke.no_calls())

    fl = load_graph("FL", scale=0.01, device=dev)
    co = load_graph("CO", scale=0.1, device=dev)
    fl_eager, co_eager = eager("GCN", fl), eager("GIN", co)
    mods = {"gemm": gemm, "spdmm": spdmm, "spmm": spmm}
    paths = smoke.drive_sharded(torch, gnn, ops, DynasparseEngine, fl, co,
                                dev, fl_eager, co_eager, mods)
    assert list(paths) == ["GCN-FL mesh 1", "GCN-FL mesh 4 halo",
                           "GCN-FL mesh 4 replicate",
                           "GCN-FL mesh 4 compiled", "GIN-CO mesh 4",
                           "pinned mesh 4"]
    for label, names in (("GCN-FL mesh 1", ("spdmm_fused",)),
                         ("GCN-FL mesh 4 halo", ("spdmm_fused",)),
                         ("GCN-FL mesh 4 replicate", ("spdmm_fused",)),
                         ("GCN-FL mesh 4 compiled", ("spdmm_fused",
                                                     "gemm")),
                         ("GIN-CO mesh 4", ("spmm_fused",)),
                         ("pinned mesh 4", ("gemm_batch_scatter",
                                            "spdmm_fused", "spmm_fused"))):
        rec = paths[label]
        assert set(rec) >= {"launches", "calls"}
        assert all(rec["calls"][k] for k in names), (label, {
            k: len(v) for k, v in rec["calls"].items()})
    # four co-resident shards: each sharded SpDMM call fills one shard's
    # canvas, so the halo path records four per adjacency kernel
    n_adj = 2
    assert len(paths["GCN-FL mesh 4 halo"]["calls"]["spdmm_fused"]) == (
        4 * n_adj)
    served = smoke.drive_serving(
        torch, gnn, ops, DynasparseEngine, "GIN-CO serving, mesh 1", "GIN",
        co, dev, co_eager, n_requests=8, max_batch=4, min_compiled=1,
        mods=mods, n_devices=1)
    assert served["calls"]["spmm_fused"] and served["calls"]["spdmm_fused"]


def test_lm_serving_phase_rehearses_on_the_cpu(smoke, monkeypatch):
    """``chip_smoke.py``'s LM serving phase on reduced configs of its three
    archs on the CPU (the decode step uncaptured; the calls that need the
    card stubbed): the serve loops agree, float32 decode == forward for
    the two archs without MoE, the serve CLI runs for each arch, and the
    MoE dispatch demonstration records its ``spdmm`` call."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.kernels import gemm, ops, spdmm, spmm

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(smoke, "profile_lm_step", lambda *a: None)
    dev = torch.device("cpu")
    assert [(a, c.n_layers, c.d_model, check)
            for a, c, check in smoke.lm_configs()] == [
        ("qwen2.5-3b", 36, 2048, True), ("mamba2-780m", 48, 1536, True),
        ("deepseek-v2-lite-16b", 4, 2048, False)]
    configs = [(arch, reduce_config(ARCHS[arch]), check)
               for arch, _, check in smoke.LM_ARCHS]
    mods = {"gemm": gemm, "spdmm": spdmm, "spmm": spmm}
    results, moe = smoke.drive_lm(torch, ops, dev, mods, configs,
                                  cli_extra=("--device", "cpu"))
    assert [r["arch"] for r in results] == [a for a, _, _ in configs]
    for r, (_, cfg, check) in zip(results, configs):
        assert r["weight_bytes"] == 2 * (
            r["params"] - cfg.padded_vocab * cfg.d_model
            + (cfg.padded_vocab if cfg.tie_embeddings else smoke.LM_BATCH)
            * cfg.d_model)
        assert ("decode_forward_max_abs" in r) == check
    assert len(moe["calls"]["spdmm"]) == 1
    args, _ = moe["calls"]["spdmm"][0]
    acts, w, block = smoke.moe_dispatch_operands()
    assert args[0].block_size == block and args[0].nnzb == 16
    np.testing.assert_allclose(args[0].todense().numpy(), acts)


def test_lm_training_phase_rehearses_on_the_cpu(smoke, monkeypatch):
    """``chip_smoke.py``'s LM training phase on the CPU at reduced size
    (the calls that need the card stubbed): six steps of reduced
    qwen2.5-3b and mamba2-780m with the loss falling, the flash VJP at a
    small shape in float32 and bfloat16, one step of four reduced archs
    (dense, MoE, enc-dec, VLM) against itself and its variants (the MoE
    arch's two microbatches against their halves), the in-process restart
    bitwise and the train CLI resumed from step 12 plus a
    ``--compress-grads`` run."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.reduced import reduce_config

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    assert [(a, c.n_layers, c.d_model, c.remat, c.microbatches)
            for a, c in smoke.train_configs()] == [
        ("qwen2.5-3b", 36, 2048, "full", 4),
        ("mamba2-780m", 48, 1536, "full", 4)]
    configs = [(arch, reduce_config(ARCHS[arch]))
               for arch in smoke.TRAIN_ARCHS]
    reduced = ["qwen2.5-3b", "deepseek-v2-lite-16b", "seamless-m4t-medium",
               "qwen2-vl-72b"]
    out = smoke.drive_train(torch, torch.device("cpu"), configs,
                            flash_shape=(1, 40, 4, 2, 16, 16),
                            reduced_archs=reduced,
                            cli_extra=("--device", "cpu"), batch=8, seq=32)
    for r in out["full"]:
        assert len(r["losses"]) == smoke.TRAIN_STEPS
        assert r["losses"][-1] < r["losses"][0]
        assert r["step_event_ms"] is None and r["profile"] is None
        assert r["bound_ms"] == r["flop_ms"] + r["adamw_ms"] > 0
    assert set(out["flash"]) == {"float32", "bfloat16"}
    assert list(out["reduced"]) == reduced
    moe = [a for a in ARCHS if ARCHS[a].ffn == "moe"]
    for arch, checks in out["reduced"].items():
        assert ("microbatches 2 == the halves" in checks) == (arch in moe)
        assert ("microbatches 2 == 1" in checks) == (arch not in moe)
    assert out["restart"]["lines"]["resumed"][0] == (
        "[train] resumed from step 12")
    assert any("compress" not in l for l in out["restart"]["lines"][
        "compressed"])


def test_train_work_counts_the_step(smoke):
    """The step's bound from shapes: full qwen2.5-3b on ``meta`` tensors
    (no memory), batch 8 x 512: products 2 FLOPs a weight a token (the
    tied head once, no lookup), causal attention over (L + 1) / 2 keys,
    times 3 for the backward plus one recomputed forward of the layers;
    AdamW 28 bytes a parameter with float32 moments."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.lm import LM

    cfg = ARCHS["qwen2.5-3b"]
    model = LM(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == pytest.approx(cfg.param_count(), rel=1e-3)   # padded vocab
    tokens, seq = 8 * 512, 512
    layer_mm = sum(p.numel() for name, p in model.named_parameters()
                   if p.ndim == 2 and name != "embed")
    head = cfg.padded_vocab * cfg.d_model
    attn = 36 * tokens * 4 * 16 * 128 * (seq + 1) / 2
    fwd = 2.0 * (layer_mm + head) * tokens + attn
    work = smoke.train_work(model, cfg, tokens, seq)
    assert work["flops"] == 4 * fwd - 2.0 * head * tokens
    assert work["adamw_bytes"] == 28 * n
    assert work["flops"] / 1e12 == pytest.approx(99.81, abs=0.01)
    assert work["bound_ms"] == pytest.approx(
        1e3 * (work["flops"] / 989e12 + 28 * n / 3.35e12), rel=1e-12)


def test_lm_distribution_phase_rehearses_on_the_cpu(smoke, monkeypatch,
                                                    one_thread):
    """``chip_smoke.py``'s LM distribution phase on reduced qwen2.5-3b on
    the CPU (the calls that need the card stubbed): the tensor-parallel
    steps on ``(2, 2)`` and ``(1, 4)`` with every shard's bytes as its
    spec predicts, the loss falling and the reference's gates against the
    single-device run's (the row-parallel sums reassociate: the first
    step's loss and gradient norm, the parameters after the last),
    ``psum8`` within its budget, the pipeline bitwise its serial run, the
    elastic restore bitwise onto ``(1, 2)`` and a finite step after it,
    the ``(1, 1)`` mesh bitwise, reduced deepseek-v2-lite-16b on one
    device and on ``(1, 4)`` and ``(2, 2)`` within the gates, one float32
    step of each on its tensor-parallel meshes within the float32 gates
    with the MoE drops equal, the rows split over ``(2, 1)`` within the
    gates, the float32 prefill on ``(2, 2)``, ``seq_shard`` on ``(1, 4)``
    (its first loss bitwise the ``(1, 4)`` run's, a float32 step's
    gradients within 1e-5 of it), ``moe_dispatch_shard`` (deepseek's
    steps on ``(2, 2)`` and ``(2, 1)`` within the gates, a float32 step
    and the prefill within 1e-5 of the unflagged mesh's, a decode whose
    capacity the data ranks divide), and the reversed-microbatch witness
    beside the tensor-parallel runs."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.models import ffn
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    cpu = torch.device("cpu")
    # four layers: one for each pipeline stage
    cfg = dataclasses.replace(reduce_config(ARCHS[smoke.DIST_ARCH]),
                              n_layers=smoke.PIPE_STAGES)
    batch, seq = 8, 32
    bundle = build_model(cfg)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=batch, seq_len=seq)
    try:
        feed = {"tokens": torch.as_tensor(next(pipe)["tokens"]).long()}
    finally:
        pipe.close()
    step = make_train_step(bundle, AdamWConfig(**smoke.TRAIN_OPT))
    state = init_state(bundle, 0, cpu)
    single = dict(losses=[], grad_norms=[], peak_gib=0.0, held_gib=0.0)
    for _ in range(smoke.DIST_STEPS):
        state, m = step(state, feed)
        single["losses"].append(m["loss"].item())
        single["grad_norms"].append(m["grad_norm"].item())
    single.update(params_steps=smoke.DIST_STEPS, params_host={
        n: p.detach().clone() for n, p in state["params"].named_parameters()})
    moe_cfg = reduce_config(ARCHS[smoke.TP_MOE_ARCH])
    out = smoke.drive_distributed(torch, cpu, cfg, single=single,
                                  batch=batch, seq=seq, moe_cfg=moe_cfg)
    train = out["train"]
    assert len(train["losses"]) == smoke.DIST_STEPS
    for run, mesh, split in ((train, smoke.DIST_MESH, 2),
                             (out["train_tp"], smoke.TP_MESH, 1),
                             (out["moe"]["sharded"], smoke.TP_MESH, 1),
                             (out["moe"]["also"][0], smoke.DIST_MESH, 2),
                             (out["train_dp"], smoke.DP_MESH, 2)):
        assert run["mesh"] == mesh and run["bitwise_single"] is not None
        assert run["rows_split"] == split
        gates = run["gates"]
        assert gates["first_loss_diff"] < smoke.TP_LOSS_TOL
        assert gates["first_norm_rel"] < smoke.TP_NORM_TOL
        assert gates["max_param_diff"] < smoke.TP_PARAM_TOL
        if mesh[1] > 1:
            assert run["tp_bytes"]["all-reduce"]["forward"] > 0
    assert out["moe"]["single"]["arch"] == moe_cfg.name
    f32 = out["f32_tp"]
    assert [r["arch"] for r in f32] == [cfg.name, moe_cfg.name]
    assert [[g["mesh"] for g in r["meshes"]] for r in f32] == [
        [smoke.DIST_MESH, smoke.TP_MESH], [smoke.TP_MESH, smoke.DIST_MESH]]
    for got in f32[0]["meshes"] + f32[1]["meshes"]:
        assert got["loss_diff"] < smoke.F32_LOSS_TOL
        assert got["norm_rel"] < smoke.F32_NORM_TOL
        assert 0 < got["grad_rel"] < smoke.F32_GRAD_TOL
        assert np.isfinite(got["change_diff"])
        assert got["routings_differing"] == 0
    assert f32[1]["meshes"][0]["drops"] > 0
    for got in out["prefill_dp"]:
        assert got["mesh"] == smoke.DIST_MESH and got["rows_split"] == 2
        assert got["max_abs_err"] <= smoke.TP_DECODE_F32_TOL
        assert got["routings_differing"] == 0
    seq_run = out["seq_shard"]
    assert seq_run["seq_split"] and seq_run["mesh"] == smoke.TP_MESH
    assert seq_run["losses"][0] == out["train_tp"]["losses"][0]
    assert seq_run["tp_bytes"]["reduce-scatter"]["forward"] > 0
    assert out["seq_f32"]["loss_bitwise"]
    assert out["seq_f32"]["grad_rel"] < smoke.SEQ_GRAD_TOL
    # moe_dispatch_shard: the bfloat16 steps within the gates, the float32
    # step and prefill within MOE_SHARD_REL of the unflagged mesh's, the
    # decode at a batch whose capacity the data ranks divide
    flagged = out["moe"]["flagged"]
    assert [r["mesh"] for r in flagged] == list(smoke.MOE_SHARD_MESHES)
    for run in flagged:
        assert run["moe_shard"] and run["rows_split"] == 2
        assert run["gates"]["first_loss_diff"] < smoke.TP_LOSS_TOL
        assert run["gates"]["max_param_diff"] < smoke.TP_PARAM_TOL
    assert out["moe"]["sharded"]["moe_shard"] is False
    moe_shard = out["moe_shard"]
    f32s = moe_shard["f32"]
    assert f32s["split"] and f32s["routings_differing"] == 0
    assert f32s["loss_rel"] < smoke.MOE_SHARD_REL
    assert f32s["grad_rel"] < smoke.SEQ_GRAD_TOL
    assert moe_shard["prefill_rel"] < smoke.MOE_SHARD_REL
    assert len(out["prefill_dp"]) == 3
    b = moe_shard["decode_batch"]
    assert b % 2 == 0 and ffn.moe_capacity(moe_cfg, b) % 2 == 0
    assert ffn.moe_capacity(moe_cfg, smoke.LM_BATCH) % 2
    (dec,) = moe_shard["decode"]["meshes"]
    assert dec["mesh"] == smoke.DIST_MESH
    assert dec["f32_max_abs_err"] < smoke.TP_DECODE_F32_TOL
    assert dec["f32_routings_differing"] == 0
    assert dec["err_vs_f32"] <= (smoke.TP_DECODE_BF16_SLACK
                                 * dec["single_err_vs_f32"])
    witness = out["witness"]
    assert list(witness) == ["reversed microbatches", str(smoke.DIST_MESH),
                             str(smoke.TP_MESH)]
    assert all(len(w["loss_diff"]) == smoke.DIST_STEPS
               for w in witness.values())
    assert out["mesh_1x1_full"]["bitwise_single"] is True
    assert out["mesh_1x1_full"]["mesh"] == (1, 1)
    assert train["losses"][-1] < train["losses"][0]
    assert train["profile"] is None and train["step_event_ms"] is None
    n = sum(p.numel() for p in bundle.init(0, cpu).parameters())
    # parameters and two moments, float32, spread over the four
    # coordinates of one device: once over the card in all
    assert train["shard_bytes"]["distinct"] >= 12 * n
    assert out["psum8"]["err_over_budget"] < 1.0
    assert out["pipeline"]["bitwise"]
    assert out["elastic"]["plan"] == {"n_devices": 2, "mesh_shape": (1, 2),
                                      "microbatch_scale": 2}
    assert np.isfinite(out["elastic"]["loss_after"])
    assert out["mesh_1x1"] is True


def test_lm_decode_on_model_phase_rehearses_on_the_cpu(smoke, monkeypatch,
                                                       one_thread):
    """``chip_smoke.py``'s decode-on-``model`` phase on the CPU at reduced
    widths (the calls that need the card stubbed): each arch's meshes of
    ``TP_DECODE_ARCHS`` teacher-forced from one device's greedy loop: the
    float32 mesh step within its gate of one device's with the same MoE
    drops, the bfloat16 step within its slack of one device's float32
    logits, the ``CapturedDecode`` body bitwise the eager mesh steps, the
    ``(1, 1)`` mesh bitwise, and the float32 step at the last position of
    a filled cache within its gate."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.reduced import reduce_config

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    assert [a for a, _, _ in smoke.TP_DECODE_ARCHS] == [
        "qwen2.5-3b", "mamba2-780m", "deepseek-v2-lite-16b"]
    configs = [(arch, reduce_config(ARCHS[arch]), meshes)
               for arch, _, meshes in smoke.TP_DECODE_ARCHS]
    out = smoke.drive_tp_decode(torch, torch.device("cpu"), configs=configs,
                                long_len=64, prompt_len=4, gen=4)
    assert [[m["mesh"] for m in r["meshes"]] for r in out["runs"]] == [
        [(1, 4), (2, 2)], [(1, 4)], [(1, 4), (2, 2)]]
    for run in out["runs"]:
        for m in run["meshes"]:
            assert m["f32_max_abs_err"] < smoke.TP_DECODE_F32_TOL
            assert m["f32_routings_differing"] == 0
            assert m["err_vs_f32"] <= (smoke.TP_DECODE_BF16_SLACK
                                       * m["single_err_vs_f32"])
            assert m["replay_bitwise"] and m["captures"] == 0
            assert m["tally"]["all-reduce"]["forward"] > 0
            assert 0 <= m["greedy_agree"] <= 1
    assert out["runs"][0]["mesh_1x1_bitwise"] is True
    assert all(m["f32_drops"] > 0 for m in out["runs"][2]["meshes"])
    # SSD: the conv window crosses the ranks' channels
    assert "cache" in out["runs"][1]["meshes"][0]["tally"]["all-gather"]
    long = out["long"]
    assert (long["arch"], long["mesh"], long["depth"]) == (
        "qwen2.5-3b", (1, 4), 64)
    assert long["max_abs_err"] < smoke.TP_DECODE_F32_TOL


def test_lm_dryrun_phase_rehearses_on_the_cpu(smoke, monkeypatch,
                                              one_thread):
    """``chip_smoke.py``'s LM dry-run phase on reduced qwen2.5-3b on the
    CPU (the calls that need the card stubbed): the meta count of the
    train step on the (1, 1) mesh, its FLOPs equal to ``FlopCounterMode``
    around the real step, ``train_work`` plus the two stated causes equal
    to the count, and the dry-run CLI run as a subprocess on a cell the
    registry skips by design (no full-size count in the tests)."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.reduced import reduce_config

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    assert smoke.DRYRUN_CELLS == (
        ("mamba2-780m", "train_4k", "single"),
        ("deepseek-v2-lite-16b", "decode_32k", "single"))
    cfg = reduce_config(ARCHS[smoke.DRYRUN_ARCH])
    assert cfg.microbatches == 4
    out = smoke.drive_dryrun(torch, torch.device("cpu"), cfg, batch=8,
                             seq=32,
                             cells=(("qwen2.5-3b", "long_500k", "single"),))
    flops = out["counted"]["cost"]["flops"]
    assert out["card"]["flops"] == flops > 0
    assert out["counted"]["busiest"]["microbatches"] == 4
    assert out["tp_card"]["flops"] == sum(r["flops"] for r in out[
        "tp_ranks"]) > 0
    assert [r["busiest"]["model_group"] for r in out["tp_ranks"]] == [2, 2]
    causes = out["causes"]
    assert causes["early_stop"] == 0 and causes["full_chunks"] > 0
    assert out["train_work"]["flops"] + causes["full_chunks"] == flops
    assert [r["status"] for r in out["cells"]] == ["skipped-by-design"]
    assert "peak_ratio" not in out


def test_train_flops_causes_explain_the_qwen_count(smoke):
    """qwen2.5-3b at the training phase's batch: the causes come to +1.23
    TFLOP (the flash attention's whole chunks) and -6.65 TFLOP (the
    checkpoint's early stop) over ``train_work``'s 99.81; at its widths
    with 2 of its 36 layers, the meta count of ``count_cell`` is
    ``train_work`` plus the first less the second, exactly."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.registry import build_model

    batch, seq = smoke.TRAIN_BATCH, smoke.TRAIN_SEQ
    causes = smoke.train_flops_causes(ARCHS["qwen2.5-3b"], batch * seq, seq)
    assert causes["full_chunks"] / 1e12 == pytest.approx(1.234, abs=1e-3)
    assert causes["early_stop"] / 1e12 == pytest.approx(6.648, abs=1e-3)
    cfg = dataclasses.replace(ARCHS["qwen2.5-3b"], n_layers=2)
    work = smoke.train_work(build_model(cfg).abstract_params(), cfg,
                            batch * seq, seq)
    causes = smoke.train_flops_causes(cfg, batch * seq, seq)
    shape = ShapeConfig("chip_smoke", seq, batch, "train")
    counted = dryrun.count_cell(cfg, shape,
                                Mesh.on("meta", (1, 1), ("data", "model")))
    assert counted["cost"]["flops"] == (work["flops"] + causes["full_chunks"]
                                        - causes["early_stop"])
