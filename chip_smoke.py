#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(``nvcc``, ``sm_90a``), then:

1. drives the main path — GCN on the Flickr stand-in (FL) at full size,
   hidden 128, ``DynasparseEngine(literal=True)`` with the VCK5000 model —
   through ``run_inference`` twice (cold: plan, pack, lower; warm: cache
   hits), with every kernel's launch count set to 0 just before and read
   just after, and holds the logits against the port's own ``literal=False``
   run (COO ``index_add_`` + ``torch.matmul``, TF32 off);
2. drives GIN on the Cora stand-in (CO) at full size the same way: its
   first aggregation is the path's SpMM kernel;
3. compiles GCN-FL into one CUDA graph (``gnn.compile_model``), replays it
   and profiles a replay: per call the dense ``gemm`` kernel twice (the
   layer-1 update on the wide tile, the logits layer on the narrow one)
   and the fused SpDMM twice;
4. compiles GIN-CO: its ``l1-mlp1`` kernel takes the activation block-skip
   route (device packer, run-time descriptors), also on a sparser input
   of the same support under the same graph, and a budget one slot short
   takes the dense ``gemm`` inside the route;
5. drives GIN-CO through the per-task path (``batched=False``): the
   ``gemm``, ``spdmm`` and SpMM kernels, one launch per task;
6. runs ``gemm_batch`` once at the shape of GCN-FL's dense queue;
7. shards: GCN on FL through a mesh engine of one card
   (``make_data_mesh(1)``), bitwise equal to the single-device engine with
   one sharded dispatch per adjacency kernel; through a 4-shard mesh
   whose shards share the card, in ``"halo"`` and ``"replicate"`` mode
   (bitwise equal to each other, every adjacency kernel bitwise equal to
   the eager executor of its placed plan, logits within 1e-4 of
   ``literal=False``; bands, exchange rounds and takes, per-shard operand
   bytes, each shard's kernel time and the exchange's device time
   logged); that halo engine through ``compile_model`` (one CUDA graph;
   replays bitwise equal to the eager mesh run); GIN on CO on 4 shards
   (the sharded ``spmm_fused``); the reference's eight pinned sharding
   cases and its block-diagonal case on 4 shards (ghost-tile pads through
   ``gemm_batch_scatter``; the block-diagonal case exchanges nothing);
8. serves LMs (``repro_torch.launch.serve``'s loop): ``qwen2.5-3b`` and
   ``mamba2-780m`` at their published widths and depths and
   ``deepseek-v2-lite-16b`` at its widths with 4 of its 27 layers, random
   weights from a seeded generator, batch 4 x (16 prompt + 16 generated)
   tokens in bfloat16: the serve loop eager, then through
   ``CapturedDecode`` (one CUDA graph per cache), replays bitwise equal
   to eager; per-step wall, tokens/s, the weight bytes a step reads and
   their bound, peak memory, a profiled replayed step; float32 decode ==
   ``forward`` (and ``make_prefill_step``) at 1e-3 for the two archs
   without MoE; ``python -m repro_torch.launch.serve`` for each arch as a
   subprocess, then ``examples_torch/serve_lm.py``; and the MoE
   block-sparse dispatch of
   ``examples/moe_sparse_dispatch.py`` through ``spdmm`` (path
   ``LM-MoE``);
9. trains LMs (``repro_torch.launch.steps``, ``launch/train.py``):
   ``qwen2.5-3b`` and ``mamba2-780m`` at their published widths and
   depths, bfloat16 compute with float32 parameters and moments, remat
   per cycle and 4 microbatches as configured, batch 8 x 512 tokens of
   the port's ``TokenPipeline``, six AdamW steps on one repeated batch:
   finite loss and gradient norm at every step and the last loss below
   the first; per step host wall, device ms (CUDA events), tokens/s and
   peak memory, the step's bound (products at the bfloat16 peak plus
   AdamW's bytes), a profiled step; the flash VJP at qwen2.5-3b's
   attention (L 2048, 16 / 2 heads) in float32 and bfloat16, forward
   bitwise ``flash_attention``'s, gradients against autograd through it,
   both backwards' peak memory; one float32 step of every reduced arch on
   the card against the same step on the CPU, two microbatches against
   one (MoE: against the two halves) and ``remat="full"`` against none;
   the restart: 2 steps + save + restore + 2 steps bitwise 4 straight
   steps, and ``examples_torch/train_lm.py`` (``python -m
   repro_torch.launch.train`` as ``examples/train_lm.py`` runs the
   reference's: 12 steps, then ``--steps 18 --resume``) beside a
   ``--compress-grads`` run; then the LM distribution layer:
   ``qwen2.5-3b`` at its published widths and 8 of its 36 layers
   (against a single-device run of that depth) on a (data 2, model
   2) mesh whose four coordinates share the card (``init_state`` /
   ``make_train_step`` with ``mesh=``, the state stored by the sharding
   rules): every shard's bytes as its spec predicts, four steps of the
   same batch as above (finite, falling, step 0 within 1e-3 of the
   single-device step 0), per step wall, events, tokens/s and peak
   memory, a profiled step; ``psum8`` over the embedding gradients of the
   batch's four microbatches against their float32 sum (the quantisation
   budget; both timed); ``pipeline_apply`` of four full-width layers
   over eight microbatches, bitwise the serial run; the elastic path
   (save, ``plan_remesh(2, model_parallel=2, original_data=2)``, restore
   onto (data 1, model 2) bitwise with every shard by the new spec, one
   finite step with the microbatches doubled); two steps of reduced
   qwen2.5-3b on the (1, 1) mesh bitwise ``make_train_step``'s; each
   microbatch's rows split over the data ranks wherever they divide
   them (qwen2.5-3b on (2, 2) and (data 2, model 1), deepseek-v2-lite-16b
   at 2 layers on (1, 4) and (2, 2), every MoE layer routing the gathered
   microbatch), held to the gates against one device, and in float32 at
   2 layers with the MoE dropped choices equal; the float32 prefill of
   both on (2, 2) against one device; qwen2.5-3b with ``seq_shard`` on
   (1, 4) (the residual stream cut over the sequence: all-gathered before
   each layer, reduce-scattered after it), its first loss bitwise the
   (1, 4) run's, and one float32 step's gradients within 1e-5 of the same
   mesh's without it; deepseek-v2-lite-16b with ``moe_dispatch_shard``
   (each data rank's group runs the expert GEMMs of its share of the
   slots, the slot outputs all-gathered) on (2, 2) and (2, 1) against
   one device at the gates, a float32 step and the float32 prefill on
   (2, 2) within 1e-5 of the same mesh's without it (drops equal), and
   its decode on (2, 2) at a batch whose capacity the data ranks divide;
   then the LM decode on a ``model`` axis
   (``make_serve_step(bundle, mesh)``, the cache placed by
   ``cache_shardings``): qwen2.5-3b whole on (data 1,
   model 4) and (data 2, model 2), mamba2-780m whole on (1, 4) and
   deepseek-v2-lite-16b at 4 layers on (1, 4) and (2, 2), each fed one
   device's greedy bfloat16 tokens (batch 4 x (16 + 16)): in float32
   within 1e-4 of one device's logits at every step with its MoE dropped
   choices; in bfloat16 no further from one device's float32 logits than
   1.5 times one device's bfloat16 logits (the distance to one device's
   bfloat16 logits and the greedy agreement logged),
   ``CapturedDecode(bundle, serve_step)`` replays bitwise the eager mesh
   steps, per-step wall, a profiled replay, one rank's tally; the (1, 1)
   mesh bitwise the single-device decode; qwen2.5-3b in float32, one step
   at position 32767 of a 32,768-deep cache filled from a seeded
   generator on (1, 4), within 1e-4 of one device's, both timed; then the
   LM dry-run: ``launch/dryrun.py::count_cell`` of qwen2.5-3b's
   train step (8 x 512, 4 microbatches, remat) on the (1, 1) mesh of meta
   coordinates against the same step on the card (FLOPs equal under
   ``FlopCounterMode``, the peak within 15 %, the roofline bound's share
   of the measured step, the ratio to ``train_work`` with its causes),
   and ``python -m repro_torch.launch.dryrun`` on two production cells
   (mamba2-780m train_4k, deepseek-v2-lite-16b decode_32k) as
   subprocesses beside it; and ``examples_torch/quickstart.py`` and
   ``gnn_inference.py`` at their defaults;
10. calibrates: the reference's sweep (block 8) through ``calibrate`` on the
   card's kernels, every sample and fit logged; ``get_calibrated`` twice on
   a fresh ``SharedPlanCache`` (one build, one hit), saved, loaded into a
   fresh cache and resolved again with no measurement; then GCN on FL
   planned with the fitted model (``runtime_fallback("cuda")``), held
   against the ``literal=False`` logits;
11. serves GCN on FL at full size (16 requests, ``max_batch`` 4) and GIN on
   CO (8 requests) through ``ServingEngine`` over a literal engine and a
   ``SharedPlanCache`` on the card: every result against that request's
   single-request literal ``run_inference``, at least one compiled batch
   after the first (GCN-FL: three) and none degraded; latency, requests/s,
   a profiled batch's device time and idle share, peak memory; GCN on FL
   once more with a cache budget that holds FL (the first burst has the
   default 256 MiB, which evicts FL's structures); GIN on CO once more
   through the mesh engine of ``ServingConfig(n_devices=1)``, whose
   ``dispatch_stats()`` carry the sharded keys;
12. chaos and restart on CO: a poison request (``FaultInjector(seed=0)`` at
   ``request``, ``req:5;``) fails alone with every other result bitwise
   equal to a fault-free run, and ``python -m
   repro_torch.launch.gnn_serve --literal --cache-file`` run twice, the
   second with no packing and no analysis;
13. holds every kernel against its plain PyTorch version on the operands the
   paths gave it (recorded in an extra, uncounted run of each path: a
   second sweep, a second calibrated inference, a served batch of its
   own with its compiled body run uncaptured; chaos records its
   fault-free run outside the capture; the second GCN-FL burst records
   nothing) and
   times kernel, plain version and one library call with CUDA events; the
   sparse kernels ``spdmm``, ``spdmm_fused`` and ``spmm_fused`` also in a
   CUDA graph, the fused SpDMM on compiled GIN-CO's ``l1-mlp1``
   block-skip launch (its long runs), beside ``torch.sparse.mm`` of that
   activation, ``gemm`` also on compiled GCN-FL's logits layer (n = 7,
   the narrow tile), beside ``torch.matmul``, and ``gemm_batch_scatter``
   also on compiled GIN-CO's largest block-skip launch, beside
   ``torch.bmm``; each dense GEMM call's TFLOP/s and share of its bound
   are logged, and the device copies and fills of the eager warm runs
   and of the compiled replays and bodies are named by the line of the
   port that makes them;
14. prints the kernel summary as one JSON line, the card's name and power
   limit, and, last, ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero.  Without a card, or
outside a checkout, it exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, and HBM3 bandwidth.  The kernels run FP32 FMA on the CUDA cores.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# kernel vs plain version: f32, the summation order differs
KERNEL_TOL = dict(rtol=2e-5, atol=2e-4)
# literal (fused kernels) vs literal=False logits: f32 end to end
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# SharedPlanCache's default byte budget, and one that holds GCN-FL served
# four wide (its packed stripes, dispatch pools and activation dispatch)
SERVING_CACHE_BYTES = 256 * 2**20
FL_CACHE_BYTES = 8 * 2**30

CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = {
    "gemm_batch_scatter": dict(
        module="gemm", source=CSRC + "gemm.cu",
        replaces="src/repro/kernels/gemm.py:94"),
    "spdmm_fused": dict(
        module="spdmm", source=CSRC + "spdmm_fused.cu",
        replaces="src/repro/kernels/spdmm.py:111"),
    "spmm_fused": dict(
        module="spmm", source=CSRC + "spmm_fused.cu",
        replaces="src/repro/kernels/spmm.py:56"),
    "gemm": dict(
        module="gemm", source=CSRC + "gemm.cu",
        replaces="src/repro/kernels/gemm.py:40"),
    "spdmm": dict(
        module="spdmm", source=CSRC + "spdmm_fused.cu",
        replaces="src/repro/kernels/spdmm.py:43"),
    "gemm_batch": dict(
        module="gemm", source=CSRC + "gemm.cu",
        replaces="src/repro/kernels/gemm.py:165"),
}
# kernels whose canvas z is updated in place (recorded as it was before)
IN_PLACE = ("gemm_batch_scatter", "spdmm_fused", "spmm_fused")
# extra fields of a kernel's summary, all measured in this run: the sparse
# kernels' times in a CUDA graph, spdmm_fused's long-run call, gemm's
# narrow call and gemm_batch_scatter's largest compiled GIN-CO launch
EXTRA = ("graph_ms", "library_graph_ms", "compiled_l1_mlp1", "narrow_call",
         "compiled_gin_co")


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def chain_of(items, runs) -> int:
    """The longest dependent fmaf chain of an order-keeping SpDMM walk: the
    most non-zero A columns any one run holds (``items`` per entry, ``runs``
    the run offsets)."""
    incl = items.long().cumsum(0)
    r = runs.long()
    starts, ends = r[:-1], r[1:]
    real = ends > starts
    per_run = incl[ends[real] - 1] - (incl - items.long())[starts[real]]
    return int(per_run.max()) if per_run.numel() else 0


def columns_of(blocks):
    """Non-zero columns of each B x B block."""
    return (blocks != 0).any(dim=1).sum(dim=1)


def device_ms(torch, fn, reps: int = 5, inner: int = 3) -> float:
    """Median device time of ``fn`` (CUDA events around ``inner``
    back-to-back calls, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(torch, fn, reps: int = 5, inner: int = 10) -> float:
    """Median device time of ``fn`` with no host time between calls:
    ``inner`` calls captured in one CUDA graph (after a warm-up call on a
    side stream), the replay timed with CUDA events.  For short kernels,
    whose back-to-back eager calls leave the card waiting on Python."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


class Recorder:
    """Wraps the kernel wrappers of ``repro_torch.kernels.{gemm,spdmm,spmm}``
    for one run and keeps each call's operands, with the canvas ``z`` as it
    was before the call (the kernels update it in place)."""

    def __init__(self, mods):
        self.mods = mods
        self.calls: dict[str, list] = {name: [] for name in KERNELS}
        self._orig = {}

    def __enter__(self):
        import torch
        for name, spec in KERNELS.items():
            mod = self.mods[spec["module"]]
            fn = getattr(mod, name)
            self._orig[name] = fn

            def rec(*args, _name=name, _fn=fn, **kw):
                if (torch.cuda.is_available()
                        and torch.cuda.is_current_stream_capturing()):
                    # a captured call's operands are the graph's own
                    # buffers, rewritten by every replay: not kept
                    return _fn(*args, **kw)
                if _name == "gemm_batch_scatter":
                    saved = (args[:4] + (args[4].clone(),), dict(kw))
                elif _name in IN_PLACE:
                    saved = (args, {**kw, "z": kw["z"].clone()})
                else:
                    saved = (args, dict(kw))
                self.calls[_name].append(saved)
                return _fn(*args, **kw)
            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for name, spec in KERNELS.items():
            setattr(self.mods[spec["module"]], name, self._orig[name])


def runs_of(name: str, args, kw):
    """Exact run offsets of a sparse call (made here: the kernels find
    their runs themselves)."""
    from repro_torch.kernels.formats import run_starts
    if name == "spdmm":
        a = args[0]
        return run_starts(a.row_ids, a.row_ids.new_zeros(a.row_ids.shape))
    return run_starts(args[4], args[5])


def nonzeros_walked(name: str, args) -> int:
    """Non-zero A elements the sparse call multiplies: of every stored
    block (``spdmm``), or of the pool block of every entry
    (``spdmm_fused``)."""
    if name == "spdmm":
        return int((args[0].blocks != 0).sum())
    per_block = (args[0] != 0).sum(dim=(1, 2))
    return int(per_block[args[2].long()].sum())


def spmm_items(args) -> dict:
    """Item counts of a fused SpMM call: its triples, the non-zero A
    columns of every triple (the Y rows an A-column-driven walk would
    fetch), the live items among them (whose Y row is non-zero too: the Y
    rows and A columns the kernel fetches), and the least FLOPs of the
    function: 2 x the sum over triples and k of the non-zero elements of A
    column k times those of Y row k."""
    a_pool, y_pool, a_ids, y_ids = args[:4]
    col_nnz = (a_pool != 0).sum(dim=1)[a_ids.long()]   # (E, B): column k
    row_nnz = (y_pool != 0).sum(dim=2)[y_ids.long()]   # (E, B): row k
    return dict(triples=int(a_ids.shape[0]),
                a_columns=int((col_nnz > 0).sum()),
                live_items=int(((col_nnz > 0) & (row_nnz > 0)).sum()),
                flops=2.0 * float((col_nnz * row_nnz).sum()))


def block_flops(name: str, args, kw) -> float:
    """The FLOPs of multiplying every stored B x B block in full: the
    bound of a walk that does not skip zero columns."""
    if name == "spdmm":
        a, y = args
        return 2.0 * a.stored_blocks * a.block_size ** 2 * y.shape[1]
    B = kw["block_size"]
    width = kw["bn"] if name == "spdmm_fused" else B
    return 2.0 * int(args[2].shape[0]) * B ** 2 * width


def run_stats(runs) -> dict:
    """Runs, and median and max entries per run, of a run offset array."""
    lens = np.diff(runs.long().cpu().numpy())
    return dict(runs=int(lens.size), median=float(np.median(lens)),
                max=int(lens.max()))


def work_of(name: str, args, kw) -> tuple[float, float]:
    """(bytes, FLOPs) the call needs, from this call's own operands and
    descriptors: each input read once (the pool blocks and operand slices
    the entries reference, the descriptors, the canvas blocks of runs that
    hold no ``first`` flag), each output written once.  The FLOPs of the
    sparse kernels are the least work of the same function: for the SpDMM
    pair 2 x width x the non-zero A elements walked
    (:func:`nonzeros_walked`), for ``spmm_fused`` the element-level
    products of every triple (:func:`spmm_items`)."""
    if name == "gemm":
        x, y = args
        m, k = x.shape
        n = y.shape[1]
        out = x.new_empty((), dtype=kw.get("out_dtype") or x.dtype)
        nbytes = (x.element_size() * m * k + y.element_size() * k * n
                  + out.element_size() * m * n)
        return nbytes, 2.0 * m * n * k
    if name in ("gemm_batch", "gemm_batch_scatter"):
        x, y = args[:2]
        t, m, k = x.shape
        n = y.shape[2]
        nbytes = 4 * (t * m * k + t * k * n + t * m * n)
        if name == "gemm_batch_scatter":
            nbytes += 8 * t
        return nbytes, 2.0 * t * m * n * k
    if name == "spdmm":
        a, y = args
        B, n = a.block_size, y.shape[1]
        nnzb = a.stored_blocks
        n_y = int(a.col_ids.unique().numel())
        nbytes = 4 * (nnzb * B * B + 3 * nnzb + n_y * B * n
                      + a.n_block_rows * B * n)
        return nbytes, 2.0 * n * nonzeros_walked(name, args)
    B = kw["block_size"]
    runs = runs_of(name, args, kw).cpu().numpy()
    n_runs = len(runs) - 1
    first = args[6].cpu().numpy()
    n_entries = len(first)
    no_first = int((np.add.reduceat(first, runs[:-1]) == 0).sum())
    n_a = int(args[2].unique().numel())
    if name == "spdmm_fused":
        bn = kw["bn"]
        ncs = args[1].shape[1] // bn
        y_keys = args[3].long() * ncs + args[5].long()
        n_y = int(y_keys.unique().numel())
        nbytes = 4 * (n_a * B * B + n_y * B * bn + 5 * n_entries
                      + (n_runs + no_first) * B * bn)
        return nbytes, 2.0 * bn * nonzeros_walked(name, args)
    n_y = int(args[3].unique().numel())
    nbytes = 4 * ((n_a + n_y) * B * B + 5 * n_entries
                  + (n_runs + no_first) * B * B)
    return nbytes, spmm_items(args)["flops"]


def shape_of(name: str, args, kw) -> str:
    if name == "gemm_batch_scatter":
        x, y, _r, _c, z = args
        return (f"x {tuple(x.shape)} y {tuple(y.shape)} "
                f"z {tuple(z.shape)}")
    if name in ("gemm", "gemm_batch"):
        x, y = args
        return f"x {tuple(x.shape)} {x.dtype} y {tuple(y.shape)}"
    if name == "spdmm":
        a, y = args
        return (f"BlockCSR {a.shape} stored {a.stored_blocks} "
                f"block {a.block_size} y {tuple(y.shape)}")
    n_runs = int(runs_of(name, args, kw).shape[0]) - 1
    return (f"pool {tuple(args[0].shape)} operand {tuple(args[1].shape)} "
            f"entries {int(args[2].shape[0])} runs {n_runs} "
            f"z {tuple(kw['z'].shape)}")


def drive(torch, tgnn, ops, engine_cls, name: str, model: str, g, hidden,
          dev, mods):
    """Cold + warm ``run_inference`` with launch counts, the
    ``literal=False`` comparison and an uncounted recording run."""
    h = g.features_dense
    params = tgnn.init_params(model, h.shape[1], hidden, g.stats.classes,
                              seed=0, device=dev)
    engine = engine_cls(literal=True, device=dev)
    log(f"== {name}: {model} on {g.stats.name} (V={g.stats.vertices}, "
        f"adjacency nnz={g.adj.nnz}, features {tuple(h.shape)}, "
        f"hidden {hidden}, classes {g.stats.classes})")
    ops.reset_cuda_launch_counts()
    for phase in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, report = tgnn.run_inference(model, engine, g.adj, h, params,
                                            device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = {k: v for k, v in engine.cache.stats.as_dict().items() if v}
        log(f"  {phase}: wall {wall:.4f} s  launches "
            f"{ops.cuda_launch_counts()}  cache {stats}")
    launches = ops.cuda_launch_counts()
    for (kname, rep), meta in zip(report.kernels, report.meta):
        M, K, N = meta["M"], meta["K"], meta["N"]
        log(f"  kernel {kname:10s} STQ {rep.n_stq:3d} (SpDMM {rep.n_spdmm}, "
            f"SpMM {rep.n_spmm})  DTQ {rep.n_dtq:3d}  M×K×N {M}×{K}×{N} "
            f"(unpadded dense 2MKN {2.0 * M * K * N:.4g} FLOP)")
    ref = plain_logits(torch, tgnn, engine_cls, model, g, h, params, dev)
    check_logits(torch, name, logits, ref, g)
    with Recorder(mods) as rec:
        again, _ = tgnn.run_inference(model, engine, g.adj, h, params,
                                      device=dev)
    torch.cuda.synchronize()
    if not torch.equal(again, logits):
        raise AssertionError(f"{name}: a repeated run is not bitwise equal")
    log(f"  repeated run bitwise equal; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_warm(torch, tgnn, model, engine, g.adj, h, params, dev)
    return dict(launches=launches, calls=rec.calls, engine=engine,
                params=params, ref=ref)


def plain_logits(torch, tgnn, engine_cls, model, g, h, params, dev):
    """The port's own ``literal=False`` logits (COO ``index_add_`` and
    ``torch.matmul``, TF32 off): the yardstick of every path."""
    ref, _ = tgnn.run_inference(model, engine_cls(literal=False, device=dev),
                                g.adj, h, params, device=dev)
    return ref


def check_logits(torch, name, logits, ref, g):
    """Finite logits of the graph's shape, within LOGIT_TOL of ``ref``."""
    if not (logits.shape == (g.stats.vertices, g.stats.classes)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{name}: logits {tuple(logits.shape)} not "
                             "finite / wrong shape")
    err = (logits - ref).abs()
    bound = LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * ref.abs()
    log(f"  logits vs literal=False: max abs {err.max().item():.3e}, "
        f"max |ref| {ref.abs().max().item():.3e}, tolerance {LOGIT_TOL}")
    if bool((err > bound).any()):
        raise AssertionError(f"{name}: logits disagree with the "
                             "literal=False run")


def synced_wall(torch, fn):
    """(result, seconds) of ``fn()`` between two device synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_rows(prof):
    """(device µs, count, name) of every device-side row of a profile."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():       # device-side rows only: no double count
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    return rows


PORT_RANGE = "port "


class PortRanges:
    """While active, every call made from a frame of the port into torch (a
    torch function written in Python, a builtin of ``torch`` or a tensor
    method) runs inside a profiler range ``port <file>(<line>):
    <function>`` named after the calling line, so the ops it launches, and
    their device rows, nest under the line that made them; each call of a
    port function runs inside a range ``port <file>(<line>): def
    <function>`` (its ``def`` line), which catches what the first kind
    cannot see (indexing and operators, which make no Python call)."""

    def __init__(self, torch):
        self.torch = torch
        self.open = []

    @staticmethod
    def _port(frame):
        name = frame.f_code.co_filename
        return name.split("repro_torch/", 1)[1] if "repro_torch/" in name \
            else None

    def _is_torch(self, fn) -> bool:
        return ((getattr(fn, "__module__", None) or "").startswith("torch")
                or isinstance(getattr(fn, "__self__", None),
                              self.torch.Tensor))

    def _enter(self, key, label):
        rng = self.torch.autograd.profiler.record_function(PORT_RANGE + label)
        rng.__enter__()
        self.open.append((key, rng))

    def hook(self, frame, event, arg):
        if event == "c_call":
            where = self._port(frame)
            if where and self._is_torch(arg):
                self._enter((frame, arg), f"{where}({frame.f_lineno}): "
                            f"{frame.f_code.co_name}")
        elif event == "call":
            code, caller = frame.f_code, frame.f_back
            where = self._port(frame)
            if where:
                self._enter((frame, None), f"{where}({code.co_firstlineno}): "
                            f"def {code.co_name}")
            elif caller is not None and "/torch/" in code.co_filename:
                at = self._port(caller)
                if at:
                    self._enter((frame, None), f"{at}({caller.f_lineno}): "
                                f"{caller.f_code.co_name}")
        elif self.open and self.open[-1][0] == (
                frame, None if event == "return" else arg):
            self.open.pop()[1].__exit__(None, None, None)

    def __enter__(self):
        sys.setprofile(self.hook)
        return self

    def __exit__(self, *exc):
        sys.setprofile(None)
        while self.open:
            self.open.pop()[1].__exit__(None, None, None)


def port_frame(event) -> str:
    """The port's line that made a profiler event: the innermost enclosing
    :class:`PortRanges` range."""
    parent = event.cpu_parent
    while parent is not None:
        if parent.name.startswith(PORT_RANGE):
            return parent.name[len(PORT_RANGE):]
        parent = parent.cpu_parent
    return "(no line of the port)"


def device_kind(name: str) -> str:
    """A short name of a device row that is not one of the port's
    kernels: the copy or memset as the profiler names it, a fill, or the
    start of the kernel's name."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    if "FillFunctor" in name:
        return "fill kernel"
    return name[:60]


def copy_sources(torch, label, fn):
    """One run of ``fn`` under ``torch.profiler`` and :class:`PortRanges`:
    the device time of every row that is not one of the port's kernels
    (the copies, fills and torch ops around them), summed by kind and by
    the line of the port (:func:`port_frame`) whose call launched it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with PortRanges(torch):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.events():
        for kern in e.kernels:
            if "(anonymous namespace)::" in kern.name:
                continue                       # the port's own kernels
            key = (device_kind(kern.name), port_frame(e))
            us, count = rows.get(key, (0.0, 0))
            rows[key] = (us + kern.duration, count + 1)
    if not rows:
        log(f"  {label}: the profiler recorded no device rows to attribute")
        return
    total = sum(us for us, _ in rows.values()) / 1e3
    log(f"  {label}: device rows other than the port's kernels, "
        f"{total:.3f} ms, by the line of the port that launched them:")
    for (kind, where), (us, count) in sorted(rows.items(),
                                             key=lambda kv: -kv[1][0])[:12]:
        log(f"    {us / 1e3:8.4f} ms  x{count:<3d} {kind:22s} {where}")


def drive_compiled(torch, tgnn, ops, name, model, g, dev, mods, eager):
    """``compile_model`` on the eager path's engine (its caches are warm),
    the capture (first call), three warm replays, one profiled replay and
    an uncounted, uncaptured run of the replay body that records each
    kernel call.  Returns the path's record and the compiled model."""
    h = g.features_dense
    log(f"== {name}: compile_model {model} on {g.stats.name}, then replays")
    ops.reset_cuda_launch_counts()
    (warm, cm), t_compile = synced_wall(torch, lambda: tgnn.compile_model(
        model, eager["engine"], g.adj, h, eager["params"]))
    if cm is None:
        raise AssertionError(f"{name}: compile_model declined")
    z1, t_capture = synced_wall(torch, lambda: cm(h))
    walls, outs = [], []
    for _ in range(3):
        z, t = synced_wall(torch, lambda: cm(h))
        walls.append(t)
        outs.append(z)
    launches = ops.cuda_launch_counts()
    per_call = cm.capture_launches[(tuple(h.shape), str(h.dtype))]
    log(f"  compile (eager warmup + lowering) {t_compile:.4f} s, first call "
        f"(capture) {t_capture:.4f} s, warm replays "
        + ", ".join(f"{1e3 * t:.3f}" for t in walls)
        + f" ms (median {1e3 * statistics.median(walls):.3f} ms)")
    log(f"  kernels {cm.n_kernels} (adjacency {cm.n_sparse}, block-skip "
        f"{cm.n_act}); launches per call (recorded at capture) {per_call}; "
        f"wrapper launches in this phase {launches}; calls {cm.calls}, "
        f"traces {cm.traces}")
    if cm.traces != 1:
        raise AssertionError(f"{name}: {cm.traces} captures for one input")
    if not all(torch.equal(z1, z) for z in outs):
        raise AssertionError(f"{name}: replays are not bitwise equal")
    check_logits(torch, name, z1, eager["ref"], g)
    check_logits(torch, name + " warmup", warm, eager["ref"], g)
    profile_replay(torch, cm, h, per_call)
    copy_sources(torch, f"{name} replay (the rows around the graph)",
                 lambda: cm(h))
    copy_sources(torch, f"{name} replay body, run uncaptured",
                 lambda: cm.run(cm.payload, h))
    with Recorder(mods) as rec:
        cm.run(cm.payload, h)
    torch.cuda.synchronize()
    return dict(launches=launches, calls=rec.calls, per_call=per_call,
                replay_ms=[1e3 * t for t in walls]), cm


# the host's idle time inside a profiler window before and after the
# profiled call: torch.profiler (CUPTI through kineto) dropped device
# records of kernels that ran at the edges of a window, the first kernel
# of a replay that started right at the window's start (the missed-record
# counts of scripts/profile_replay_misses.py)
PROFILE_EDGE_S = 0.05


def replay_rows(torch, fn):
    """One call of ``fn`` (a warm replay) under ``torch.profiler``, with
    ``PROFILE_EDGE_S`` of idle host time, the device synchronized, on
    either side of it inside the window: (its device rows, the call's
    wall s)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_EDGE_S)
        _, wall = synced_wall(torch, fn)
        time.sleep(PROFILE_EDGE_S)
    return device_rows(prof), wall


def launches_by_name(rows, names) -> dict:
    """The launches of each of the port's kernel ``names`` in a profile's
    device rows, by kernel name."""
    return {kname: sum(c for _, c, key in rows if re.search(
                rf"(?<![A-Za-z_]){kname}_kernel(?:<|I|\()", key))
            for kname in names}


def profile_replay(torch, cm, h, per_call):
    """One warm replay under ``torch.profiler`` (:func:`replay_rows`):
    device busy time and idle share, and the launches per call confirmed
    by kernel name: every kernel the capture recorded, as many times."""
    rows, wall = replay_rows(torch, lambda: cm(h))
    if not rows:
        log("  profiler recorded no device time in the replay: idle share "
            "and kernel names not measured")
        return
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"  profiled replay: device busy {busy_ms:.3f} ms of "
        f"{1e3 * wall:.3f} ms wall: idle share "
        f"{1 - busy_ms / (1e3 * wall):.4f}")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")
    port = {}
    for dev_us, _, key in rows:
        m = re.match(r"(?:void )?\(anonymous namespace\)::"
                     r"((?:gemm|spdmm|spmm)\w*_kernel(?:<[^(]*>)?)", key)
        if m:
            port[m.group(1)] = port.get(m.group(1), 0.0) + dev_us / 1e3
    log("  the port's kernels in the profiled replay (device ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(port.items())))
    seen = launches_by_name(rows, per_call)
    log(f"  launches by kernel name in the profiled replay {seen}, recorded "
        f"at capture {per_call}")
    if not any(seen.values()):
        log("  the profile names none of the port's kernels: per-call "
            "launches not confirmed by name")
    elif seen != per_call:
        raise AssertionError(f"the replay ran {seen}, the capture recorded "
                             f"{per_call}")


def act_kernel_names(cm):
    """Names of the kernels that took the block-skip route, in call order
    (dense X whose warmup plan sent tasks to the sparse queue)."""
    return [meta["name"] for (_, rep), meta in zip(cm.report.kernels,
                                                   cm.report.meta)
            if not meta["x_is_adj"] and rep.n_stq > 0]


def check_activation_route(torch, tgnn, ops, engine_cls, name, model, g,
                           dev, eager, cm):
    """GIN-CO's block-skip telemetry, a sparser input of the same support
    under the same graph, and a forced overflow on l1-mlp1's operand."""
    from repro_torch.core import dispatch as tdispatch

    h = g.features_dense
    acts = act_kernel_names(cm)
    if cm.n_act < 1 or "l1-mlp1" not in acts or len(acts) != cm.n_act:
        raise AssertionError(f"{name}: block-skip kernels {acts}, n_act "
                             f"{cm.n_act}: l1-mlp1 must take the route")
    for kname, d in zip(acts, cm.last_activation):
        log(f"  {kname}: stored {int(d['stored'])} of {d['logical']} logical "
            f"blocks, capacity {d['capacity']}, overflow "
            f"{bool(d['overflow'])}")
    d = cm.last_activation[acts.index("l1-mlp1")]
    if bool(d["overflow"]) or not int(d["stored"]) < d["logical"]:
        raise AssertionError(f"{name}: l1-mlp1 overflowed or skipped nothing")

    keep = torch.as_tensor(np.random.default_rng(0).uniform(
        size=tuple(h.shape)) < 0.7, device=dev)
    h2 = h * keep
    ref2 = plain_logits(torch, tgnn, engine_cls, model, g, h2,
                        eager["params"], dev)
    z2, wall = synced_wall(torch, lambda: cm(h2))
    log(f"  sparser input (70 % of entries kept): replay {1e3 * wall:.3f} "
        f"ms, traces {cm.traces}, l1-mlp1 stored "
        f"{int(cm.last_activation[acts.index('l1-mlp1')]['stored'])}")
    if cm.traces != 1 or any(bool(x["overflow"]) for x in cm.last_activation):
        raise AssertionError(f"{name}: the sparser input was recaptured or "
                             "overflowed")
    check_logits(torch, name + " sparser input", z2, ref2, g)

    # one dispatch of l1-mlp1's operand with a budget one slot short
    engine, w = eager["engine"], eager["params"]["M1a"]
    x = h + engine.matmul(g.adj, h, name="l1-agg")[0]
    plan = engine.plan(x, w, name="l1-mlp1")
    need = tdispatch.activation_capacity(x, plan.part, engine.block,
                                         slack=1.0)
    ad = engine.activation_dispatch_for(plan, x, capacity=need - 1)
    z_o, diag = tdispatch.execute_activation(ad, x, w)
    z_d = ops.gemm(x, w, out_dtype=torch.float32)
    torch.cuda.synchronize()
    log(f"  forced overflow on l1-mlp1's operand (capacity {need - 1}, need "
        f"{need}): overflow {bool(diag['overflow'])}, equal to the gemm "
        f"kernel bitwise {torch.equal(z_o, z_d)}")
    if not (bool(diag["overflow"]) and torch.equal(z_o, z_d)):
        raise AssertionError(f"{name}: the overflow fallback is not the "
                             "dense gemm result")


def drive_pertask(torch, tgnn, ops, engine_cls, name, model, g, dev, mods,
                  eager):
    """One ``batched=False`` inference, counted and recorded: every task is
    its own ``gemm`` / ``spdmm`` / SpMM launch."""
    h = g.features_dense
    log(f"== {name}: {model} on {g.stats.name}, batched=False")
    engine = engine_cls(literal=True, batched=False, device=dev)
    ops.reset_cuda_launch_counts()
    with Recorder(mods) as rec:
        (logits, report), wall = synced_wall(torch, lambda: tgnn.run_inference(
            model, engine, g.adj, h, eager["params"], device=dev))
    launches = ops.cuda_launch_counts()
    tasks = sum(r.n_stq + r.n_dtq for _, r in report.kernels)
    log(f"  cold wall {wall:.4f} s, {tasks} tasks, launches {launches}")
    check_logits(torch, name, logits, eager["ref"], g)
    for k in ("gemm", "spdmm", "spmm_fused"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"{name} launched no {k} kernel")
    return dict(launches=launches, calls=rec.calls)


def drive_gemm_batch(torch, ops, dev, mods):
    """One ``gemm_batch`` launch at the shape of GCN-FL's dense queue (8
    tasks of 11264 x 500 by 500 x 128), seeded operands on the card."""
    log("== gemm_batch at the dense-queue shape of GCN-FL")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((8, 11264, 500), generator=gen, device=dev)
    y = torch.randn((8, 500, 128), generator=gen, device=dev)
    ops.reset_cuda_launch_counts()
    with Recorder(mods) as rec:
        z, wall = synced_wall(torch, lambda: ops.gemm_batch(x, y))
    launches = ops.cuda_launch_counts()
    log(f"  wall {1e3 * wall:.3f} ms, launches {launches}")
    if (launches.get("gemm_batch", 0) != 1 or z.shape != (8, 11264, 128)
            or not bool(torch.isfinite(z).all())):
        raise AssertionError("gemm_batch did not run once to a finite "
                             "result")
    return dict(launches=launches, calls=rec.calls)


def profile_warm(torch, tgnn, model, engine, adj, h, params, dev):
    """One more warm run, uncounted: the synchronized host wall of each
    engine kernel's plan and execute phases, and under ``torch.profiler``
    the device time by CUDA kernel name, whose sum against the run's wall
    gives the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    walls = []

    def timed(phase, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            walls.append((phase, time.perf_counter() - t0))
            return out
        return run

    engine.plan = timed("plan", engine.plan)
    engine.execute = timed("execute", engine.execute)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, report = tgnn.run_inference(model, engine, adj, h, params,
                                           device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        del engine.plan, engine.execute
    names = [n for n, _ in report.kernels]
    log("  profiled warm run (profiler on), plan / execute per kernel: "
        + ", ".join(f"{n} {1e3 * walls[2 * i][1]:.2f} / "
                    f"{1e3 * walls[2 * i + 1][1]:.2f} ms"
                    for i, n in enumerate(names))
        + f"; whole run {1e3 * wall:.2f} ms")
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    if not rows:
        log("  profiler recorded no device time: idle share not measured")
        return
    log(f"  device busy {busy_ms:.3f} ms of {1e3 * wall:.2f} ms wall: idle "
        f"share {1 - busy_ms / (1e3 * wall):.4f}")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")
    copy_sources(torch, "warm run", lambda: tgnn.run_inference(
        model, engine, adj, h, params, device=dev))


def check_kernel(torch, mods, name, calls, library):
    """Every recorded call against the plain version; the first call is
    timed.  Returns the summary entry of this kernel."""
    mod = mods[KERNELS[name]["module"]]
    kernel, plain = getattr(mod, name), getattr(mod, name + "_plain")

    def run(fn, args, kw):
        # the comparison runs each call unpredicated: a predicated launch
        # that did not run left nothing to compare
        kw = {k: v for k, v in kw.items() if k != "pred"}
        if name == "gemm_batch_scatter":
            return fn(*args[:4], args[4].clone(), **kw)
        if name in IN_PLACE:
            return fn(*args, **{**kw, "z": kw["z"].clone()})
        return fn(*args, **kw)

    worst = 0.0
    for i, (args, kw) in enumerate(calls):
        got = run(kernel, args, kw)
        want = run(plain, args, kw)
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs()
        limit = KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * want.abs()
        rel = (err / want.abs().clamp_min(1e-30)).max().item()
        log(f"  {name} call {i}: {shape_of(name, args, kw)}  max abs "
            f"{err.max().item():.3e}  max rel {rel:.3e}  tolerance "
            f"{KERNEL_TOL}")
        if bool((err > limit).any()):
            raise AssertionError(f"{name} call {i} disagrees with its plain "
                                 "version")
        worst = max(worst, err.max().item())

    args, kw = calls[0]
    kw = {k: v for k, v in kw.items() if k != "pred"}
    if name == "gemm_batch_scatter":
        z = args[4].clone()
        k_fn = lambda: kernel(*args[:4], z)
        p_fn = lambda: plain(*args[:4], z)
    else:
        kw_t = {**kw, "z": kw["z"].clone()} if name in IN_PLACE else kw
        k_fn = lambda: kernel(*args, **kw_t)
        p_fn = lambda: plain(*args, **kw_t)
    ms = device_ms(torch, k_fn)
    plain_ms = device_ms(torch, p_fn)
    library_ms = device_ms(torch, library) if library is not None else None
    bound = bound_of(name, args, kw)
    log(f"  {name} timed on call 0: kernel {ms:.4f} ms  plain "
        f"{plain_ms:.4f} ms  library "
        f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}  "
        + bound["text"] + "; " + rate_text(bound, ms, library_ms))
    entry = {"name": name, "route": "cuda",
             "source": KERNELS[name]["source"],
             "replaces": KERNELS[name]["replaces"],
             "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
             "library_ms": library_ms}
    if name in ("spdmm", "spdmm_fused", "spmm_fused"):
        runs = runs_of(name, args, kw)
        entry.update(graph_ms=graph_ms(torch, k_fn),
                     library_graph_ms=(None if library is None
                                       else graph_ms(torch, library)))
        if name == "spmm_fused":
            items = spmm_items(args)
            detail = (f"triples {items['triples']}, non-zero A columns "
                      f"{items['a_columns']}, live items "
                      f"{items['live_items']}")
        else:
            cols = (columns_of(args[0].blocks) if name == "spdmm"
                    else columns_of(args[0])[args[2].long()])
            detail = f"longest fmaf chain {chain_of(cols, runs)}"
        log(f"  {name} call 0 runs: {run_stats(runs)}; {detail}; in a CUDA "
            f"graph: kernel {entry['graph_ms']:.4f} ms, library "
            f"{entry['library_graph_ms']} ms")
    return entry


def bound_of(name: str, args, kw) -> dict:
    """The least time of the call on the card (:func:`work_of`), and for
    the sparse kernels also the bound of multiplying every stored block in
    full, for comparison."""
    nbytes, flops = work_of(name, args, kw)
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS
    out = dict(bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    out["text"] = (f"bound {out['bound_ms']:.4f} ms ({nbytes:.4g} B, "
                   f"{flops:.4g} FLOP)")
    if name in ("spdmm", "spdmm_fused", "spmm_fused"):
        bf = block_flops(name, args, kw)
        out["block_bound_ms"] = 1e3 * max(t_bytes, bf / PEAK_FP32_FLOPS)
        out["text"] += (f"; multiplying every stored block: {bf:.4g} FLOP, "
                        f"bound {out['block_bound_ms']:.4f} ms")
    return out


def rate_text(bound, ms, library_ms=None) -> str:
    """Achieved rates of a timed call and its share of the bound (bound
    time over measured time), for the kernel and the library call."""
    def one(t):
        return (f"{bound['flops'] / t / 1e9:.2f} TFLOP/s, "
                f"{bound['bytes'] / t / 1e6:.1f} GB/s, "
                f"{bound['bound_ms'] / t:.1%} of the bound")
    text = "kernel " + one(ms)
    if library_ms is not None:
        text += "; library " + one(library_ms)
    return text


def time_narrow_gemm(torch, mods, calls):
    """The first recorded ``gemm`` call with n <= 16 (compiled GCN-FL's
    logits layer, the narrow tile; :func:`check_kernel` holds it against
    its plain version with every other call): the kernel beside
    ``torch.matmul`` of the same operands, eagerly and in a CUDA graph (the
    call is short enough for host time between eager calls to show), and
    its bound."""
    gemm = mods["gemm"]
    args, kw = next(c for c in calls if c[0][1].shape[1] <= 16)
    kw = {k: v for k, v in kw.items() if k != "pred"}
    x, y = args
    k_fn = lambda: gemm.gemm(x, y, **kw)
    library = lambda: torch.matmul(x, y)
    ms, ms_graph = device_ms(torch, k_fn), graph_ms(torch, k_fn)
    plain_ms = device_ms(torch, lambda: gemm.gemm_plain(x, y, **kw))
    library_ms, library_graph = device_ms(torch, library), graph_ms(torch,
                                                                    library)
    bound = bound_of("gemm", args, kw)
    log(f"  gemm, narrow call: {shape_of('gemm', args, kw)} n {y.shape[1]}; "
        f"kernel {ms:.4f} ms ({ms_graph:.4f} in a CUDA graph); plain "
        f"{plain_ms:.4f} ms; library {library_ms:.4f} ms "
        f"({library_graph:.4f}) (torch.matmul); "
        + bound["text"] + "; in a graph: "
        + rate_text(bound, ms_graph, library_graph))
    return {"call": shape_of("gemm", args, kw) + f" n {y.shape[1]}",
            "ms": ms, "graph_ms": ms_graph, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_graph_ms": library_graph, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"]}


def largest_block_skip_call(calls):
    """The recorded ``gemm_batch_scatter`` call of the activation
    block-skip route (the calls with a predicate) with the most FLOPs."""
    skip = [c for c in calls if c[1].get("pred") is not None]
    return max(skip, key=lambda c: work_of("gemm_batch_scatter", *c)[1])


def time_scatter_call(torch, mods, calls):
    """Compiled GIN-CO's largest block-skip launch of
    ``gemm_batch_scatter`` (:func:`largest_block_skip_call`), unpredicated,
    on its recorded operands: the kernel eagerly and in a CUDA graph,
    beside ``torch.bmm`` of its stacked operands, held against the plain
    version."""
    gemm = mods["gemm"]
    args, _kw = largest_block_skip_call(calls)
    x, y, rows, cols, canvas = args
    z = canvas.clone()
    k_fn = lambda: gemm.gemm_batch_scatter(x, y, rows, cols, z)
    library = lambda: torch.bmm(x, y)
    ms, ms_graph = device_ms(torch, k_fn), graph_ms(torch, k_fn)
    plain_ms = device_ms(torch, lambda: gemm.gemm_batch_scatter_plain(
        x, y, rows, cols, z))
    library_ms, library_graph = device_ms(torch, library), graph_ms(torch,
                                                                    library)
    got = gemm.gemm_batch_scatter(x, y, rows, cols, canvas.clone())
    want = gemm.gemm_batch_scatter_plain(x, y, rows, cols, canvas.clone())
    torch.cuda.synchronize()
    err = (got - want).abs()
    bound = bound_of("gemm_batch_scatter", args, {})
    log(f"  gemm_batch_scatter, compiled GIN-CO's largest block-skip launch: "
        f"{shape_of('gemm_batch_scatter', args, {})}; kernel {ms:.4f} ms "
        f"({ms_graph:.4f} in a CUDA graph); plain {plain_ms:.4f} ms; "
        f"library {library_ms:.4f} ms "
        f"({library_graph:.4f}) (torch.bmm); max abs vs plain "
        f"{err.max().item():.3e}; " + bound["text"] + "; in a graph: "
        + rate_text(bound, ms_graph, library_graph))
    if bool((err > KERNEL_TOL["atol"]
             + KERNEL_TOL["rtol"] * want.abs()).any()):
        raise AssertionError("compiled GIN-CO's scatter launch disagrees "
                             "with its plain version")
    return {"path": "GIN-CO compiled",
            "call": shape_of("gemm_batch_scatter", args, {}), "ms": ms,
            "graph_ms": ms_graph, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_graph_ms": library_graph,
            "max_abs_err": err.max().item(), "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"]}


def time_skip_call(torch, mods, calls):
    """The compiled GIN-CO ``l1-mlp1`` block-skip launch of ``spdmm_fused``
    (the first recorded call of the activation route, the one with a
    predicate): the kernel on its recorded arguments, unpredicated, beside
    ``torch.sparse.mm`` of the activation as CSR and ``torch.matmul`` of
    the dense activation."""
    spdmm = mods["spdmm"]
    args, kw = next(c for c in calls if c[1].get("pred") is not None)
    pool, y, a_ids, y_rows, out_rows, out_cols, _first = args
    B, bn = kw["block_size"], kw["bn"]
    runs = runs_of("spdmm_fused", args, kw)
    z = kw["z"].clone()
    launch = lambda: spdmm.spdmm_fused(*args, block_size=B, bn=bn, z=z)
    ms, ms_graph = device_ms(torch, launch), graph_ms(torch, launch)
    plain_ms = device_ms(torch, lambda: spdmm.spdmm_fused_plain(
        *args, block_size=B, bn=bn, z=z))
    # the activation the entries hold, as a dense matrix and as a CSR
    keep = out_cols == 0
    nrb, ncb = z.shape[0] // B, y.shape[0] // B
    dense4 = torch.zeros((nrb, ncb, B, B), device=y.device)
    dense4.index_put_((out_rows[keep].long(), y_rows[keep].long()),
                      pool[a_ids[keep].long()], accumulate=True)
    dense = dense4.permute(0, 2, 1, 3).reshape(nrb * B, ncb * B)
    csr = dense.to_sparse_csr()
    library = lambda: torch.sparse.mm(csr, y)
    library_ms, library_graph = device_ms(torch, library), graph_ms(torch,
                                                                    library)
    dense_ms = device_ms(torch, lambda: torch.matmul(dense, y))
    got = spdmm.spdmm_fused(*args, block_size=B, bn=bn,
                            z=torch.zeros_like(z))
    err = (got - torch.sparse.mm(csr, y)).abs().max().item()
    bound = bound_of("spdmm_fused", args, kw)
    stats = run_stats(runs) | dict(
        chain=chain_of(columns_of(pool)[a_ids.long()], runs))
    log(f"  spdmm_fused, compiled GIN-CO l1-mlp1 launch: "
        f"{shape_of('spdmm_fused', args, kw)}, activation nnz "
        f"{csr.values().numel()}; kernel {ms:.4f} ms ({ms_graph:.4f} in a "
        f"CUDA graph); plain {plain_ms:.4f} ms; library {library_ms:.4f} ms ({library_graph:.4f}) "
        f"(torch.sparse.mm, CSR), dense matmul "
        f"{dense_ms:.4f} ms; max abs vs torch.sparse.mm {err:.3e}; "
        + bound["text"])
    log(f"  spdmm_fused l1-mlp1 runs: {stats}")
    if err > KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * got.abs().max().item():
        raise AssertionError("the l1-mlp1 launch disagrees with "
                             "torch.sparse.mm of its activation")
    return {"path": "GIN-CO compiled", "call": "l1-mlp1", "ms": ms,
            "graph_ms": ms_graph, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_graph_ms": library_graph,
            "dense_matmul_ms": dense_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"]}


def adjacency_csr(torch, adj):
    idx = torch.stack([adj.rows.long(), adj.cols.long()])
    coo = torch.sparse_coo_tensor(idx, adj.vals, adj.shape).coalesce()
    return coo.to_sparse_csr()


def library_call(torch, name, g, args):
    """One PyTorch call computing the same function as the timed kernel
    call (never used by the port), or None."""
    if name in ("gemm_batch_scatter", "gemm_batch"):
        return lambda: torch.bmm(args[0], args[1])
    if name == "gemm":
        return lambda: torch.matmul(args[0], args[1])
    if name == "spdmm":
        # the row-stripe as an element-level CSR times the dense operand
        a, y = args
        csr = a.todense().float().to_sparse_csr()
        return lambda: torch.sparse.mm(csr, y[: csr.shape[1]])
    # the adjacency aggregation as one sparse-times-dense call
    csr = adjacency_csr(torch, g.adj)
    y = args[1] if name == "spdmm_fused" else g.features_dense
    if y.shape[0] < csr.shape[1]:
        return None
    return lambda: torch.sparse.mm(csr, y[: csr.shape[1]])


def no_calls() -> dict:
    """The ``calls`` of a path that records none (its kernels are checked
    on the operands of the earlier paths)."""
    return {name: [] for name in KERNELS}


def planned_kernels(report) -> list[str]:
    """The fused kernels a run's plans send work to (its report's SpDMM,
    SpMM and dense-queue task counts)."""
    reps = [rep for _, rep in report.kernels]
    return [k for k, n in (("spdmm_fused", sum(r.n_spdmm for r in reps)),
                           ("spmm_fused", sum(r.n_spmm for r in reps)),
                           ("gemm_batch_scatter", sum(r.n_dtq for r in reps)))
            if n]


def require_launched(label: str, launches: dict, names) -> None:
    for k in names:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"{label} launched no {k} kernel: "
                                 f"{launches}")


class LogLines(logging.Handler):
    """For the length of a ``with`` block: prints every INFO record of one
    logger and keeps its messages."""

    def __init__(self, name: str):
        super().__init__(logging.INFO)
        self.logger = logging.getLogger(name)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())
        log("    " + record.getMessage())

    def __enter__(self):
        self._level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self._level)


def drive_calibration(torch, tgnn, ops, engine_cls, g, dev, eager, mods):
    """The reference's sweep on the card's kernels, the calibration level
    of a ``SharedPlanCache`` through save and load, and GCN on ``g``
    planned with the fitted model.  Returns the records of the sweep and
    of the calibrated inference, each with the calls of one more,
    uncounted run (a second sweep, a second inference)."""
    from repro_torch.core import calibrate
    from repro_torch.core.perfmodel import runtime_fallback
    from repro_torch.serving import SharedPlanCache

    log("== calibration: the reference's sweep (block 8) on the card's "
        "kernels")
    base = runtime_fallback("cuda")
    n0 = calibrate.measurement_count()
    ops.reset_cuda_launch_counts()
    with LogLines(calibrate.__name__) as lines:
        model, wall = synced_wall(torch, lambda: calibrate.calibrate(
            base, block=8, device=dev))
    launches = ops.cuda_launch_counts()
    clamped = sum("clamped" in line for line in lines.lines)
    log(f"  sweep {wall:.3f} s, {model.n_samples} timed samples, launches "
        f"{launches}; slope clamp fired in {clamped} of 4 fits")
    log("  fitted model " + json.dumps(dataclasses.asdict(model)))
    if not (model.calibrated and model.backend == calibrate.device_kind(dev)
            and model.n_samples == calibrate.measurement_count() - n0 == 14):
        raise AssertionError(f"calibration produced {model}")
    require_launched("calibration", launches, ("gemm_batch_scatter",
                                               "spdmm_fused", "spmm_fused",
                                               "gemm"))
    with Recorder(mods) as sweep:      # uncounted: the sweep's operands
        calibrate.calibrate(base, block=8, device=dev)

    cache = SharedPlanCache(device=dev)
    first = calibrate.get_calibrated(cache, base, device=dev)
    again = calibrate.get_calibrated(cache, base, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plans.pkl")
        cache.save(path)
        fresh = SharedPlanCache(device=dev)
        manifest = fresh.load(path)
    n1 = calibrate.measurement_count()
    restored = calibrate.get_calibrated(fresh, base, device=dev)
    log(f"  get_calibrated x2: builds {cache.stats.calib_builds}, hits "
        f"{cache.stats.calib_hits}; after save and load ({manifest}): "
        f"builds {fresh.stats.calib_builds}, hits {fresh.stats.calib_hits}, "
        f"measurements {calibrate.measurement_count() - n1}")
    if not ((cache.stats.calib_builds, cache.stats.calib_hits) == (1, 1)
            and again is first and restored == first
            and calibrate.measurement_count() == n1
            and (fresh.stats.calib_builds, fresh.stats.calib_hits)
            == (0, 1)):
        raise AssertionError("the calibration did not replay from the "
                             "cache without measuring")

    log(f"== GCN on {g.stats.name} planned with {first.name}")
    engine = engine_cls(base, literal=True, cache=fresh, device=dev)
    h = g.features_dense
    ops.reset_cuda_launch_counts()
    (logits, report), wall = synced_wall(torch, lambda: tgnn.run_inference(
        "GCN", engine, g.adj, h, eager["params"], device=dev))
    fl_launches = ops.cuda_launch_counts()
    if engine.runtime_hw() != first or fresh.stats.calib_builds:
        raise AssertionError("the engine did not plan with the restored "
                             "calibration")
    log(f"  cold wall {wall:.4f} s, launches {fl_launches}")
    check_logits(torch, "GCN-FL calibrated", logits, eager["ref"], g)
    require_launched("GCN-FL calibrated", fl_launches,
                     planned_kernels(report))
    for (name, rep), (_, vck) in zip(report.kernels,
                                     eager["engine"].report.kernels):
        log(f"  kernel {name:10s} STQ {rep.n_stq:3d} (SpDMM {rep.n_spdmm}, "
            f"SpMM {rep.n_spmm}) DTQ {rep.n_dtq:3d}; VCK5000: STQ "
            f"{vck.n_stq:3d} DTQ {vck.n_dtq:3d}")
    with Recorder(mods) as rec:        # uncounted: the planned operands
        tgnn.run_inference("GCN", engine, g.adj, h, eager["params"],
                           device=dev)
    torch.cuda.synchronize()
    return (dict(launches=launches, calls=sweep.calls),
            dict(launches=fl_launches, calls=rec.calls))


def profile_serving(torch, srv, reqs):
    """One more served batch under ``torch.profiler``: its device time,
    wall and the device's idle share, the device rows by kind, and,
    unprofiled, the host wall of uploading its requests' features alone
    (what the dispatch worker does before stacking)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import as_tensor

    dev = srv.engine.device
    _, upload = synced_wall(torch, lambda: [as_tensor(h, dev)
                                            for _, h in reqs])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = synced_wall(torch, lambda: srv.serve(reqs))
    rows = device_rows(prof)
    log(f"  upload of the {len(reqs)} requests' features alone: "
        f"{1e3 * upload:.3f} ms wall")
    if not rows:
        log("  profiler recorded no device time in the served batch: idle "
            "share not measured")
        return
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"  profiled batch of {len(reqs)} (a replay): device busy "
        f"{busy_ms:.3f} ms of {1e3 * wall:.3f} ms wall: idle share "
        f"{1 - busy_ms / (1e3 * wall):.4f}")
    kinds = {}
    for dev_us, count, key in rows:
        kind = ("the port's kernels" if "(anonymous namespace)::" in key
                else device_kind(key))
        us, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (us + dev_us, n + count)
    log("  device ms by kind: " + ", ".join(
        f"{kind} {us / 1e3:.3f} (x{n})" for kind, (us, n)
        in sorted(kinds.items(), key=lambda kv: -kv[1][0])[:8]))
    for dev_us, count, key in sorted(rows, reverse=True)[:6]:
        log(f"    {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")


def drive_serving(torch, tgnn, ops, engine_cls, label, model, g, dev, eager,
                  n_requests, max_batch, min_compiled, mods=None,
                  max_bytes=SERVING_CACHE_BYTES, n_devices=None):
    """``n_requests`` requests built as ``gnn_serve`` builds them, served by
    a ``ServingEngine`` over a literal engine (with ``n_devices``, the mesh
    engine ``ServingConfig(n_devices=...)`` builds) and a
    ``SharedPlanCache`` of ``max_bytes`` on the card; each result held
    against the request's single-request literal ``run_inference``.  With ``mods``, one more,
    uncounted burst of ``max_batch`` requests on a second ``ServingEngine``
    over the same cache records the kernel calls of its eager first batch,
    and of its compiled program's body run uncaptured at the stacked
    shape."""
    from repro_torch.device import as_tensor, host
    from repro_torch.launch.gnn_serve import synthetic_requests
    from repro_torch.serving import (ServingConfig, ServingEngine,
                                     SharedPlanCache)

    log(f"== {label}: ServingEngine {model} on {g.stats.name}, "
        f"{n_requests} requests, max_batch {max_batch}, cache budget "
        f"{max_bytes / 2**20:.0f} MiB")
    t0 = time.perf_counter()
    reqs = synthetic_requests(g.stats.name, host(g.features_dense),
                              n_requests)
    log(f"  requests built in {time.perf_counter() - t0:.2f} s")
    cache = SharedPlanCache(device=dev, max_bytes=max_bytes)

    def server(**config):
        if n_devices is None:
            srv = ServingEngine(model, eager["params"],
                                engine=engine_cls(literal=True, cache=cache,
                                                  device=dev),
                                config=ServingConfig(max_batch=max_batch,
                                                     **config))
        else:
            srv = ServingEngine(model, eager["params"], cache=cache,
                                config=ServingConfig(max_batch=max_batch,
                                                     n_devices=n_devices,
                                                     **config))
        srv.register_graph(g.stats.name, g.adj)
        return srv

    srv = server()
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        ops.reset_cuda_launch_counts()
        outs, wall = synced_wall(torch, lambda: srv.serve(reqs))
        launches = ops.cuda_launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        st = srv.stats
        lat = np.array([r.latency for r in st.requests])
        ds = srv.dispatch_stats()
        log(f"  wall {wall:.4f} s, {n_requests / wall:.2f} requests/s, "
            f"latency p50 {1e3 * np.percentile(lat, 50):.3f} ms, p99 "
            f"{1e3 * np.percentile(lat, 99):.3f} ms, mean batch "
            f"{st.mean_batch_size:.2f}; peak memory {peak / 2**30:.3f} GiB "
            f"({held / 2**30:.3f} GiB held before the burst)")
        log(f"  stats {json.dumps(st.as_dict())}")
        log(f"  dispatch {json.dumps({k: v for k, v in ds.items() if k != 'health'})}; "
            f"cache {cache.stats.as_dict()}, {cache.bytes_used} B; "
            f"launches {launches}; per-step "
            + ", ".join(f"{1e3 * r.t_execute:.3f}" for r in st.requests[
                ::max_batch]) + " ms")
        if (st.errors or st.degraded_batches
                or st.compiled_batches < min_compiled):
            raise AssertionError(f"{label}: {st.as_dict()}")
        if n_devices is not None and not (
                ds["n_devices"] == n_devices and ds["sharded_dispatches"] >= 1
                and ds["operand_sharding"] == "halo"
                and ds["operand_bytes"]["entries"] >= 1):
            raise AssertionError(f"{label}: dispatch stats {ds}")
        profile_serving(torch, srv, reqs[:max_batch])
    finally:
        srv.close()
    worst = 0.0
    for (_, h), z in zip(reqs, outs):
        want, _ = tgnn.run_inference(model, eager["engine"], g.adj, h,
                                     eager["params"], device=dev)
        err = (z - want).abs()
        if bool((err > LOGIT_TOL["atol"]
                 + LOGIT_TOL["rtol"] * want.abs()).any()):
            raise AssertionError(f"{label}: a served result disagrees with "
                                 "its single-request run")
        worst = max(worst, err.max().item())
    log(f"  every result vs its single-request literal run: max abs "
        f"{worst:.3e}, tolerance {LOGIT_TOL}")
    del srv, outs
    torch.cuda.empty_cache()
    calls = no_calls()
    if mods is not None:
        rec_srv = server()
        try:
            with Recorder(mods) as rec:
                rec_srv.serve(reqs[:max_batch])
                cm = next(iter(rec_srv._compiled.values()))
                cm.run(cm.payload, torch.cat(
                    [as_tensor(h, dev) for _, h in reqs[:max_batch]], dim=1))
            torch.cuda.synchronize()
        finally:
            rec_srv.close()
        calls = rec.calls
        log("  recorded (uncounted burst of one batch): " + ", ".join(
            f"{k} {len(v)}" for k, v in calls.items() if v))
    return dict(launches=launches, calls=calls)


def drive_chaos(torch, ops, engine_cls, g, dev, eager, mods):
    """GIN on ``g``: request 5 poisoned at the ``request`` site fails alone;
    every other result is bitwise equal to a fault-free run's.  The
    fault-free run records its kernel calls outside the capture (its eager
    batch and the capture's uncaptured warm-up run)."""
    from repro_torch.device import host
    from repro_torch.launch.gnn_serve import synthetic_requests
    from repro_torch.serving import (FaultInjector, InjectedFault,
                                     ServingConfig, ServingEngine,
                                     SharedPlanCache)

    log(f"== chaos: GIN on {g.stats.name}, request 5 poisoned")
    reqs = synthetic_requests(g.stats.name, host(g.features_dense), 8,
                              seed=1)

    def run(faults):
        srv = ServingEngine(
            "GIN", eager["params"],
            engine=engine_cls(literal=True,
                              cache=SharedPlanCache(device=dev), device=dev),
            config=ServingConfig(max_batch=4, activation_skip=False,
                                 request_timeout=300.0, faults=faults))
        srv.register_graph(g.stats.name, g.adj)
        try:
            return srv.serve(reqs, return_exceptions=True), srv.stats
        finally:
            srv.close()

    ops.reset_cuda_launch_counts()
    with Recorder(mods) as rec:
        ref, _ = run(None)
    out, st = run(FaultInjector(seed=0).arm("request", match="req:5;"))
    launches = ops.cuda_launch_counts()
    equal = [i for i, z in enumerate(out) if i != 5
             and not isinstance(z, Exception) and torch.equal(z, ref[i])]
    log(f"  request 5: {type(out[5]).__name__}; bitwise equal to the "
        f"fault-free run: {equal}; bisections {st.bisections}, retries "
        f"{st.retries}, quarantined {st.quarantined}; launches {launches}")
    if not (isinstance(out[5], InjectedFault) and len(equal) == 7
            and st.quarantined == 1 and st.errors == 1
            and not any(isinstance(z, Exception) for z in ref)):
        raise AssertionError("the poison request was not isolated")
    return dict(launches=launches, calls=rec.calls)


def drive_restart(tmp_dir: str, *extra: str) -> list[dict]:
    """``python -m repro_torch.launch.gnn_serve --literal --cache-file`` on
    CO at full size (``extra`` flags appended, the last of a flag wins),
    twice: the second run restores the plan cache and neither packs nor
    analyzes.  Returns the stats line of each run."""
    log("== restart: gnn_serve on CO twice with one --cache-file")
    path = os.path.join(tmp_dir, "gnn_serve_plans.pkl")
    cmd = [sys.executable, "-m", "repro_torch.launch.gnn_serve",
           "--dataset", "CO", "--scale", "1", "--literal", "--requests",
           "16", "--max-batch", "4", "--cache-file", path, *extra]
    env = cli_env()
    runs = []
    for i in range(2):
        t0 = time.perf_counter()
        out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=600, cwd=ROOT)
        if out.returncode != 0:
            raise AssertionError(f"gnn_serve run {i + 1} exited "
                                 f"{out.returncode}:\n{out.stderr[-4000:]}")
        line = next(l for l in out.stdout.splitlines()
                    if l.startswith("[gnn_serve] {"))
        stats = json.loads(line[len("[gnn_serve] "):])
        runs.append(stats)
        log(f"  run {i + 1}: {time.perf_counter() - t0:.2f} s; packs "
            f"{stats['cache']['packs']}, analyzes "
            f"{stats['cache']['analyzes']}, errors {stats['errors']}, "
            f"compiled batches {stats['compiled_batches']}, latency "
            f"{stats['latency']}, kernel launches per request "
            f"{stats['kernel_launches_per_request']}")
        log(f"    host wall by phase (s): {json.dumps(stats['phases'])}")
        for l in out.stdout.splitlines():
            if "cache:" in l:
                log("    " + l)
    first, second = runs
    if (first["errors"] or second["errors"]
            or second["cache"]["packs"] or second["cache"]["analyzes"]
            or not first["cache"]["packs"]):
        raise AssertionError("the restarted gnn_serve re-planned or "
                             "failed")
    return runs


# the reference's pinned sharding cases (its multi-device tests): (n,
# tile_m, tile_n, width, nnz, mode, strategy, eps, Y zero share, seed)
PINNED = [
    (100, 16, 8, 12, 400, "dynamic", "balanced", 0.0, 0.0, 1),
    (100, 16, 8, 12, 400, "dynamic", "greedy", 0.0, 0.0, 2),
    (64, 8, 8, 4, 2000, "dynamic", "balanced", 0.0, 0.0, 3),
    (64, 8, 8, 4, 2000, "dynamic", "greedy", 0.5, 0.8, 4),
    (40, 8, 16, 20, 60, "sparse_only", "balanced", 0.0, 0.8, 5),
    (129, 16, 8, 8, 800, "dense_only", "balanced", 0.0, 0.0, 6),
    (17, 8, 8, 8, 40, "dynamic", "balanced", 0.5, 0.5, 7),
    (56, 8, 8, 8, 900, "sparse_only", "balanced", 0.5, 0.8, 8),
]
# its block-diagonal case: every edge stays in its row block (nnz unused)
BLOCK_DIAGONAL = (64, 8, 8, 8, 0, "sparse_only", "greedy", 0.0, 0.0, 42)
# shards of the co-resident mesh: all on the one card
MESH_SHARDS = 4


def log_sharded(engine) -> None:
    """Bands, exchange rounds and takes, and the per-shard operand bytes
    of every sharded dispatch in the engine's cache."""
    for sd in [v for (kind, _k), v in engine.cache.items()
               if kind == "sharddispatch"]:
        ob = sd.operand_bytes
        hg = sd.halo
        log(f"  sharded {sd.geom.K}x{sd.geom.N} ({sd.operand_sharding}): "
            f"bands {[b1 - b0 for b0, b1 in zip(sd.band_starts, sd.band_starts[1:])]} "
            f"stripes, rows {list(sd.band_rows)}, "
            + ("no exchange schedule" if hg is None else
               f"n_rounds {hg.n_rounds}, max_take {hg.max_take}, "
               f"L {hg.L}, max_own {hg.max_own}"))
        log("    per shard (owned / halo / replicated-fallback bytes): "
            + "; ".join(f"{p['owned_bytes']} / {p['halo_bytes']} / "
                        f"{p['fallback_bytes']}" for p in ob["per_device"])
            + f"; resident a shard {ob['halo_per_device_bytes']} B, "
            f"replicated {ob['replicated_per_device_bytes']} B")


def eager_checked_mm(torch, engine, label):
    """``engine_mm`` of a mesh engine that also holds every adjacency
    kernel against the single-device eager executor of the SAME placed
    plan, bitwise."""
    from repro_torch.core import scheduler
    from repro_torch.core.primitives import SparseCOO

    def mm(x, y, name="kernel"):
        z, _ = engine.matmul(x, y, name=name)
        if isinstance(x, SparseCOO):
            plan = engine.last_plan
            key, entry = engine._packed_structure(plan, x)
            xd = engine._ensure_dense(key, entry, x) if plan.dtq else None
            want = scheduler.execute_plan(
                plan.part, plan.stq, plan.dtq, xd, y, block=engine.block,
                batched=True, packed=entry.stripes, eps=engine.eps)
            if not torch.equal(z, want):
                raise AssertionError(f"{label} {name}: the sharded kernel "
                                     "is not bitwise equal to the eager "
                                     "executor of its placed plan")
        return z
    return mm


def drive_mesh(torch, tgnn, ops, engine_cls, label, model, g, dev, eager,
               mesh, mods, operand_sharding="halo"):
    """Cold + warm ``run_inference`` through a mesh engine with launch
    counts, the ``literal=False`` comparison, then (uncounted) the model
    once more with every adjacency kernel held against the eager executor
    of its placed plan, and a recording run."""
    h = g.features_dense
    engine = engine_cls(literal=True, device=dev, mesh=mesh,
                        operand_sharding=operand_sharding)
    log(f"== {label}: {model} on {g.stats.name}, {mesh.size} shard(s) on "
        f"{sorted({str(d) for d in mesh.devices})}, {operand_sharding}")
    ops.reset_cuda_launch_counts()
    walls = []
    for _ in ("cold", "warm"):
        (logits, report), wall = synced_wall(torch, lambda: tgnn.run_inference(
            model, engine, g.adj, h, eager["params"], device=dev))
        walls.append(wall)
    launches = ops.cuda_launch_counts()
    log(f"  cold wall {walls[0]:.4f} s, warm {walls[1]:.4f} s; launches "
        f"{launches}; sharded dispatches {engine.cache.sharded_count()}")
    for d, rep in enumerate(report.by_device):
        log(f"  device {d}: modelled {1e3 * rep.makespan:.4f} ms, STQ "
            f"{rep.n_stq} DTQ {rep.n_dtq}")
    log_sharded(engine)
    check_logits(torch, label, logits, eager["ref"], g)
    checked = tgnn.APPLY[model](eager_checked_mm(torch, engine, label),
                                g.adj, h, eager["params"])
    with Recorder(mods) as rec:
        again, _ = tgnn.run_inference(model, engine, g.adj, h,
                                      eager["params"], device=dev)
    torch.cuda.synchronize()
    if not (torch.equal(again, logits) and torch.equal(checked, logits)):
        raise AssertionError(f"{label}: a repeated run is not bitwise equal")
    log("  every adjacency kernel bitwise equal to the eager executor of "
        "its placed plan; a repeated run bitwise equal")
    require_launched(label, launches, planned_kernels(report))
    return dict(launches=launches, calls=rec.calls, engine=engine,
                logits=logits, walls=walls)


def profile_exchange(torch, tgnn, model, engine, g, params, dev):
    """One warm mesh run under ``torch.profiler`` and :class:`PortRanges`:
    the device time of the ops the halo exchange launched (those made by
    lines of ``core/halo.py``) beside the run's whole device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with PortRanges(torch):
            _, wall = synced_wall(torch, lambda: tgnn.run_inference(
                model, engine, g.adj, g.features_dense, params, device=dev))
    by_file, total = {}, 0.0
    for e in prof.events():
        for kern in e.kernels:
            where = port_frame(e).split("(")[0]
            by_file[where] = by_file.get(where, 0.0) + kern.duration
            total += kern.duration
    if not total:
        log("  profiler recorded no device rows: exchange time not measured")
        return None
    ex = by_file.get("core/halo.py", 0.0) / 1e3
    log(f"  profiled warm run: wall {1e3 * wall:.2f} ms, device "
        f"{total / 1e3:.3f} ms, of it the halo exchange (core/halo.py) "
        f"{ex:.4f} ms; by port file: " + ", ".join(
            f"{k} {v / 1e3:.3f}" for k, v in sorted(
                by_file.items(), key=lambda kv: -kv[1])[:6]))
    return ex


def time_shard_calls(torch, mods, label, name, calls):
    """Device time (CUDA events) of each recorded call of the sparse kernel
    ``name``, with its entries and its longest run: where a shard's band is
    short, its ghost-tile pads form one long run.  Returns the sum."""
    kernel = getattr(mods[KERNELS[name]["module"]], name)
    total = 0.0
    for i, (args, kw) in enumerate(calls):
        kw_t = {**kw, "z": kw["z"].clone()}
        ms = device_ms(torch, lambda: kernel(*args, **kw_t))
        lens = np.diff(runs_of(name, args, kw).long().cpu().numpy())
        total += ms
        log(f"  {label} {name} call {i}: entries {int(args[2].shape[0])}, "
            f"runs {lens.size}, longest run {int(lens.max())}: {ms:.4f} ms")
    log(f"  {label} {name}: {total:.4f} ms over {len(calls)} calls")
    return total


def drive_mesh_compiled(torch, tgnn, ops, label, model, g, dev, mods, run):
    """``compile_model`` on a mesh engine (its caches warm): one CUDA graph
    holds the exchange and every shard's kernels; the capture, three warm
    replays bitwise equal to the eager mesh run, and an uncounted,
    uncaptured body run that records each kernel call."""
    h = g.features_dense
    log(f"== {label}: compile_model {model} on {g.stats.name}, "
        f"{run['engine'].n_devices} shards")
    ops.reset_cuda_launch_counts()
    (warm, cm), t_compile = synced_wall(torch, lambda: tgnn.compile_model(
        model, run["engine"], g.adj, h, run["params"]))
    if cm is None or cm.n_sparse < 1 or len(set(cm.mesh_devices)) != 1:
        raise AssertionError(f"{label}: compile_model declined")
    z1, t_capture = synced_wall(torch, lambda: cm(h))
    walls, outs = [], []
    for _ in range(3):
        z, t = synced_wall(torch, lambda: cm(h))
        walls.append(t)
        outs.append(z)
    launches = ops.cuda_launch_counts()
    per_call = cm.capture_launches.get((tuple(h.shape), str(h.dtype)))
    log(f"  compile {t_compile:.4f} s, capture {t_capture:.4f} s, warm "
        "replays " + ", ".join(f"{1e3 * t:.3f}" for t in walls)
        + f" ms (median {1e3 * statistics.median(walls):.3f} ms); launches "
        f"per call (recorded at capture) {per_call}; wrapper launches "
        f"{launches}")
    if not all(torch.equal(z, run["logits"]) for z in [z1, warm] + outs):
        raise AssertionError(f"{label}: the replay is not bitwise equal to "
                             "the eager mesh run")
    require_launched(label + " (per call)", per_call or {}, ("spdmm_fused",))
    log("  warmup and every replay bitwise equal to the eager mesh run")
    profile_replay(torch, cm, h, per_call)
    copy_sources(torch, f"{label} replay body, run uncaptured",
                 lambda: cm.run(cm.payload, h))
    with Recorder(mods) as rec:
        cm.run(cm.payload, h)
    torch.cuda.synchronize()
    return dict(launches=launches, calls=rec.calls, per_call=per_call,
                replay_ms=[1e3 * t for t in walls])


def pinned_case(torch, engine_cls, dev, case, mesh, **kw):
    """One of the reference's pinned sharding cases (or
    ``BLOCK_DIAGONAL``) on ``mesh``: returns (adjacency, Y, engine,
    result)."""
    from repro_torch.core.primitives import SparseCOO

    n, tm, tn, w, nnz, mode, strategy, eps, y_zero, seed = case
    r = np.random.default_rng(seed)
    if case is BLOCK_DIAGONAL:
        rows = np.sort(r.integers(0, n, n * 6)).astype(np.int32)
        offs = r.integers(0, tm, n * 6).astype(np.int32)
        cols = np.minimum((rows // tm) * tm + offs, n - 1).astype(np.int32)
    else:
        rows = np.sort(r.integers(0, n, nnz)).astype(np.int32)
        cols = r.integers(0, n, nnz).astype(np.int32)
    vals = r.standard_normal(rows.shape[0]).astype(np.float32)
    adj = SparseCOO((n, n), *(torch.as_tensor(a, device=dev)
                              for a in (rows, cols, vals)), tag="adjacency")
    ry = np.random.default_rng(seed + 1)
    y = ry.standard_normal((n, w)).astype(np.float32)
    if y_zero:
        y = np.where(ry.random((n, w)) < y_zero, 0.0, y).astype(np.float32)
    y = torch.as_tensor(y, device=dev)
    engine = engine_cls(tile_m=tm, tile_n=tn, literal=True, mode=mode,
                        strategy=strategy, eps=eps, device=dev, mesh=mesh,
                        **kw)
    return adj, y, engine, engine.matmul(adj, y)[0]


def drive_pinned(torch, engine_cls, ops, dev, mods):
    """The reference's eight pinned sharding cases and its block-diagonal
    case on a co-resident 4-shard mesh, halo mode, counted; then,
    uncounted, each against the replicated oracle and the eager executor
    of its placed plan (bitwise), and a recording run.  The dense queue's
    ghost-tile pads reach ``gemm_batch_scatter`` here."""
    from repro_torch.launch.mesh import DataMesh

    mesh = DataMesh((dev,) * MESH_SHARDS)
    cases = PINNED + [BLOCK_DIAGONAL]
    log(f"== pinned sharding cases: {len(cases)} on {MESH_SHARDS} shards")
    ops.reset_cuda_launch_counts()
    runs = [pinned_case(torch, engine_cls, dev, c, mesh) for c in cases]
    torch.cuda.synchronize()
    launches = ops.cuda_launch_counts()
    takes = []
    for case, (adj, y, engine, z) in zip(cases, runs):
        _, _, _, z_r = pinned_case(torch, engine_cls, dev, case, mesh,
                                   operand_sharding="replicate")
        plan = engine.last_plan
        eager = eager_checked_mm(torch, engine, f"pinned seed {case[-1]}")
        if not (torch.equal(z, z_r) and torch.equal(eager(adj, y), z)):
            raise AssertionError(f"pinned seed {case[-1]}: halo, replicate "
                                 "and eager disagree")
        sd = engine.sharded_dispatch_for(plan, adj)
        takes.append((case[-1], plan.placement.band_sizes(),
                      sd.halo.max_take, len(plan.dtq)))
    log(f"  launches {launches}; (seed, bands, max_take, DTQ tasks): "
        f"{takes}; halo == replicate == eager executor, bitwise, in every "
        "case")
    if takes[-1][2] != 0:
        raise AssertionError("the block-diagonal case exchanged blocks")
    with Recorder(mods) as rec:
        for c in cases:
            pinned_case(torch, engine_cls, dev, c, mesh)
    torch.cuda.synchronize()
    return dict(launches=launches, calls=rec.calls)


def drive_sharded(torch, tgnn, ops, engine_cls, fl, co, dev, fl_eager,
                  co_eager, mods):
    """GCN-FL on a mesh of one device (bitwise equal to the single-device
    engine) and on a co-resident 4-shard mesh in halo and replicate mode
    (bitwise equal to each other), the exchange's device time, the 4-shard
    halo engine compiled, GIN-CO on 4 shards (its aggregation the sharded
    ``spmm_fused``) and the pinned cases.  Returns the records by path."""
    from repro_torch.launch.mesh import DataMesh, make_data_mesh

    single, _ = tgnn.run_inference("GCN", fl_eager["engine"], fl.adj,
                                   fl.features_dense, fl_eager["params"],
                                   device=dev)
    m1 = drive_mesh(torch, tgnn, ops, engine_cls, "GCN-FL mesh 1", "GCN",
                    fl, dev, fl_eager, make_data_mesh(1, device=dev), mods)
    n_adj = sum(m["x_is_adj"] for m in m1["engine"].report.meta)
    if not (torch.equal(m1["logits"], single)
            and m1["engine"].cache.sharded_count() == n_adj):
        raise AssertionError("GCN-FL on a mesh of one device is not the "
                             "single-device engine's result, or lowered "
                             f"{m1['engine'].cache.sharded_count()} sharded "
                             f"dispatches for {n_adj} adjacency kernels")
    log(f"  mesh 1 bitwise equal to the single-device engine; one sharded "
        f"dispatch per adjacency kernel ({n_adj})")
    del m1["engine"]

    mesh = DataMesh((dev,) * MESH_SHARDS)
    m4 = drive_mesh(torch, tgnn, ops, engine_cls, "GCN-FL mesh 4 halo",
                    "GCN", fl, dev, fl_eager, mesh, mods)
    m4r = drive_mesh(torch, tgnn, ops, engine_cls, "GCN-FL mesh 4 replicate",
                     "GCN", fl, dev, fl_eager, mesh, mods,
                     operand_sharding="replicate")
    if not torch.equal(m4["logits"], m4r["logits"]):
        raise AssertionError("GCN-FL halo and replicate disagree")
    log("  halo bitwise equal to replicate")
    del m4r["engine"]
    m4["exchange_ms"] = profile_exchange(torch, tgnn, "GCN", m4["engine"],
                                         fl, fl_eager["params"], dev)
    for label, rec in (("GCN-FL", fl_eager), ("GCN-FL mesh 4 halo", m4)):
        time_shard_calls(torch, mods, label, "spdmm_fused",
                         rec["calls"]["spdmm_fused"])
    m4["params"] = fl_eager["params"]
    m4c = drive_mesh_compiled(torch, tgnn, ops, "GCN-FL mesh 4 compiled",
                              "GCN", fl, dev, mods, m4)
    del m4["engine"]
    co4 = drive_mesh(torch, tgnn, ops, engine_cls, "GIN-CO mesh 4", "GIN",
                     co, dev, co_eager, mesh, mods)
    require_launched("GIN-CO mesh 4", co4["launches"], ("spmm_fused",))
    for label, rec in (("GIN-CO", co_eager), ("GIN-CO mesh 4", co4)):
        time_shard_calls(torch, mods, label, "spmm_fused",
                         rec["calls"]["spmm_fused"])
    del co4["engine"]
    pinned = drive_pinned(torch, engine_cls, ops, dev, mods)
    return {"GCN-FL mesh 1": m1, "GCN-FL mesh 4 halo": m4,
            "GCN-FL mesh 4 replicate": m4r, "GCN-FL mesh 4 compiled": m4c,
            "GIN-CO mesh 4": co4, "pinned mesh 4": pinned}


def summarize(torch, mods, paths):
    """One summary entry per kernel: its worst error against the plain
    version over every recorded call, and the times of its first recorded
    call on the first path (in ``paths`` order) that launched it, beside
    the library call and the bound.  ``launches`` is that path's count;
    ``launches_by_path`` gives every path's."""
    log("== kernels against their plain versions")
    summary = []
    for name in KERNELS:
        calls = [(label, g, c) for label, g, rec in paths
                 if rec["launches"].get(name, 0) > 0
                 for c in rec["calls"][name]]
        if not calls:
            raise AssertionError(f"no recorded call of {name}")
        label, g, (args, _kw) = calls[0]
        entry = check_kernel(torch, mods, name, [c for *_, c in calls],
                             library_call(torch, name, g, args))
        by_path = {p_label: rec["launches"].get(name, 0)
                   for p_label, _, rec in paths}
        entry.update(path=label, launches=by_path[label],
                     launches_by_path=by_path)
        if name == "gemm":
            entry["narrow_call"] = time_narrow_gemm(
                torch, mods, [c for p_label, _, c in calls
                              if p_label == label])
        if name == "gemm_batch_scatter":
            entry["compiled_gin_co"] = time_scatter_call(
                torch, mods, next(rec["calls"][name] for p_label, _, rec
                                  in paths if p_label == "GIN-CO compiled"))
        if name == "spdmm_fused":
            entry["compiled_l1_mlp1"] = time_skip_call(
                torch, mods, next(rec["calls"][name] for p_label, _, rec
                                  in paths if p_label == "GIN-CO compiled"))
        summary.append(entry)
        torch.cuda.empty_cache()
    return summary



# ------------------------------------------------------------ LM serving
# the three archs examples/serve_lm.py serves, at their published widths:
# (arch, layers kept (None: all), decode == forward checked in float32).
# deepseek-v2-lite-16b keeps 4 of its 27 layers: all 27 are ~63 GB in
# float32, too close to 80 GB beside a bfloat16 copy.
LM_ARCHS = (("qwen2.5-3b", None, True), ("mamba2-780m", None, True),
            ("deepseek-v2-lite-16b", 4, False))
LM_BATCH, LM_PROMPT, LM_GEN = 4, 16, 16          # the serve CLI's defaults
# decode against forward, both float32 with TF32 off
DECODE_FORWARD_TOL = dict(rtol=1e-3, atol=1e-3)


def lm_configs():
    """(arch, config, check decode == forward) of the LM phase."""
    from repro_torch.configs import ARCHS
    return [(arch, ARCHS[arch] if n is None
             else dataclasses.replace(ARCHS[arch], n_layers=n), check)
            for arch, n, check in LM_ARCHS]


def serve_loop(torch, bundle, model, decode, prompts, gen, cache):
    """``launch/serve.py``'s loop: the prompt token by token through the
    decode step, then greedy generation.  Returns each step's logits and
    the generated tokens; ``cache`` is written in place."""
    plen = prompts.shape[1]
    logits, steps, toks = None, [], []
    for t in range(plen + gen):
        tok = prompts[:, t:t + 1] if t < plen else logits.argmax(-1)[:, None]
        if t >= plen:
            toks.append(tok)
        logits, cache = decode(model, cache, tok, t)
        steps.append(logits)
    return steps, torch.cat(toks, dim=1)


def step_weight_bytes(torch, model, batch: int) -> int:
    """The bytes of weights one decode step must read: every parameter
    once in the compute dtype, except the embedding table, of which the
    step reads ``batch`` rows (all of it when it is also the head)."""
    item = getattr(torch, model.cfg.dtype).itemsize
    total = sum(p.numel() for n, p in model.named_parameters()
                if n != "embed")
    emb = model.embed
    rows = emb.shape[0] if model.cfg.tie_embeddings else batch
    return item * (total + rows * emb.shape[1])


def profile_lm_step(torch, decode, model, cache, tok, pos):
    """One replayed decode step: its time by CUDA events (back-to-back
    calls), and under ``torch.profiler`` its device busy time, the top
    device ops and the idle share (of the event-timed step)."""
    from torch.profiler import ProfilerActivity, profile

    step = lambda: decode(model, cache, tok, pos)
    event_ms = device_ms(torch, step)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = synced_wall(torch, step)
    rows = device_rows(prof)
    log(f"  replayed step by CUDA events: {event_ms:.3f} ms")
    if not rows:
        log("  profiler recorded no device time: idle share not measured")
        return dict(event_ms=event_ms)
    busy_ms = sum(r[0] for r in rows) / 1e3
    idle = 1 - busy_ms / event_ms
    log(f"  profiled replayed step: device busy {busy_ms:.3f} ms in "
        f"{len(rows)} kernel names, {sum(r[1] for r in rows)} launches "
        f"({1e3 * wall:.3f} ms wall under the profiler): idle share "
        f"{idle:.4f} of the event-timed step")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")
    return dict(event_ms=event_ms, busy_ms=busy_ms,
                launches=sum(r[1] for r in rows), idle=idle)


def check_decode_forward(torch, bundle, tokens, plen, dev):
    """Float32 decode logits at every position against ``forward`` over the
    same tokens, and ``make_prefill_step``'s last-position logits against
    the decode logits at the last prompt token."""
    from repro_torch.launch.steps import make_prefill_step

    cfg = bundle.cfg
    model = bundle.init(0, dev)
    full = bundle.forward(model, {"tokens": tokens})[..., :cfg.vocab]
    prefill = make_prefill_step(bundle)(
        model, {"tokens": tokens[:, :plen]})[:, :cfg.vocab]
    cache = bundle.init_cache(tokens.shape[0], tokens.shape[1], dev)
    worst = 0.0
    for t in range(tokens.shape[1]):
        logits, cache = bundle.decode_step(model, cache, tokens[:, t:t + 1],
                                           t)
        for what, want in ((f"forward position {t}", full[:, t]),
                           ("prefill", prefill if t == plen - 1 else None)):
            if want is None:
                continue
            err = (logits - want).abs()
            limit = (DECODE_FORWARD_TOL["atol"]
                     + DECODE_FORWARD_TOL["rtol"] * want.abs())
            if bool((err > limit).any()):
                raise AssertionError(f"{cfg.name}: float32 decode disagrees "
                                     f"with {what}: max abs "
                                     f"{err.max().item():.3e}")
            worst = max(worst, err.max().item())
    log(f"  float32 decode == forward at all {tokens.shape[1]} positions "
        f"and == make_prefill_step at position {plen - 1}: max abs "
        f"{worst:.3e}, tolerance {DECODE_FORWARD_TOL}")
    return worst


def drive_lm_arch(torch, arch, cfg, dev, check_forward, batch=LM_BATCH,
                  prompt_len=LM_PROMPT, gen=LM_GEN):
    """One arch of the LM phase: the serve loop eager (twice, the second
    timed) and through ``CapturedDecode`` (capture, then a timed run of
    replays on the same cache), replays bitwise equal to eager, per-step
    wall, tokens/s, the weight-byte bound, peak memory and a profiled
    replayed step; then, where asked, decode == forward in float32."""
    import gc

    from repro_torch.configs import ARCHS
    from repro_torch.launch.steps import CapturedDecode, cache_leaves
    from repro_torch.models.registry import build_model

    bundle = build_model(cfg)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = synced_wall(torch, lambda: bundle.init(0, dev))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"== LM serving: {arch} ({cfg.n_layers} of "
        f"{ARCHS[arch].n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}, {cfg.dtype} compute): {n_params / 1e9:.3f} B float32 "
        f"parameters, init {init_s:.2f} s, {held / 2**30:.2f} GiB held "
        "before")
    max_len = prompt_len + gen
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, prompt_len)), device=dev)

    def loop(decode, cache=None):
        cache = cache if cache is not None else bundle.init_cache(
            batch, max_len, dev)
        steps, toks = serve_loop(torch, bundle, model, decode, prompts, gen,
                                 cache)
        return steps, toks, cache

    eager, toks, _ = loop(bundle.decode_step)
    (eager2, toks2, _), eager_s = synced_wall(
        torch, lambda: loop(bundle.decode_step))
    decode = CapturedDecode(bundle)
    (replay, rtoks, cache), first_s = synced_wall(torch, lambda: loop(decode))
    for t in cache_leaves(cache):
        t.zero_()
    (replay2, rtoks2, _), replay_s = synced_wall(
        torch, lambda: loop(decode, cache))
    if decode.captures != (dev.type == "cuda"):    # the CPU runs uncaptured
        raise AssertionError(f"{arch}: {decode.captures} captures")
    for label, steps, tk in (("eager again", eager2, toks2),
                             ("replayed", replay, rtoks),
                             ("replayed again", replay2, rtoks2)):
        if not (all(torch.equal(a, b) for a, b in zip(eager, steps))
                and torch.equal(tk, toks)):
            raise AssertionError(f"{arch}: {label} logits or tokens are not "
                                 "bitwise the eager run's")
    if not bool(torch.isfinite(eager[-1].float()).all()):
        raise AssertionError(f"{arch}: non-finite logits")
    n_steps = max_len
    wbytes = step_weight_bytes(torch, model, batch)
    bound_ms = 1e3 * wbytes / PEAK_HBM_BYTES
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = dict(arch=arch, layers=cfg.n_layers, params=n_params,
               held_gib=held / 2**30,
               eager_step_ms=1e3 * eager_s / n_steps,
               replay_step_ms=1e3 * replay_s / n_steps,
               capture_run_s=first_s,
               tokens_per_s=batch * n_steps / replay_s,
               eager_tokens_per_s=batch * n_steps / eager_s,
               weight_bytes=wbytes, bound_ms=bound_ms, peak_gib=peak)
    log(f"  {batch} x ({prompt_len} + {gen}) tokens: replays and the second "
        f"eager run bitwise equal to the eager run (logits at every step, "
        f"tokens {toks[0, :8].tolist()}...)")
    log(f"  per decode step: eager {out['eager_step_ms']:.3f} ms, replayed "
        f"{out['replay_step_ms']:.3f} ms (host wall over {n_steps} steps); "
        f"capture run {first_s:.3f} s; {out['tokens_per_s']:.1f} tokens/s "
        f"replayed, {out['eager_tokens_per_s']:.1f} eager (prefill "
        f"included); weights read per step {wbytes / 1e9:.3f} GB, bound "
        f"{bound_ms:.3f} ms at {PEAK_HBM_BYTES / 1e12:.2f} TB/s "
        f"({bound_ms / out['replay_step_ms']:.1%} of the replayed step); "
        f"peak memory {peak:.2f} GiB")
    out["profile"] = profile_lm_step(torch, decode, model, cache,
                                     prompts[:, :1], max_len - 1)
    del model, decode, cache, eager, eager2, replay, replay2
    gc.collect()
    torch.cuda.empty_cache()
    if check_forward:
        tokens = torch.cat([prompts, toks], dim=1)
        out["decode_forward_max_abs"] = check_decode_forward(
            torch, build_model(dataclasses.replace(cfg, dtype="float32")),
            tokens, prompt_len, dev)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def drive_serve_cli(archs, *extra: str) -> None:
    """``python -m repro_torch.launch.serve --arch <a> --batch 2
    --prompt-len 8 --gen 8`` for each arch as a subprocess (as
    ``examples/serve_lm.py`` runs the reference's), all at once; each must
    exit 0."""
    env = cli_env()
    procs = {arch: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--batch", "2", "--prompt-len", "8", "--gen", "8", *extra],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for arch in archs}
    failed = []
    for arch, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        for line in stdout.splitlines():
            log(f"  {line}")
        if proc.returncode != 0:
            failed.append(f"{arch} exited {proc.returncode}:\n"
                          f"{stderr[-3000:]}")
    if failed:
        raise AssertionError("serve CLI failed: " + "\n".join(failed))


def moe_dispatch_operands():
    """``examples/moe_sparse_dispatch.py``'s numbers: a block-sparse expert
    activation (64 tokens, 8 experts, block 8, each token block on its top
    2 experts) and a dense weight, from seed 0."""
    rng = np.random.default_rng(0)
    T, E, B = 64, 8, 8
    mask = np.zeros((T // B, E), np.float32)
    for i in range(T // B):
        mask[i, rng.choice(E, 2, replace=False)] = 1.0
    acts = (rng.normal(size=(T, E * B)).astype(np.float32)
            * np.kron(mask, np.ones((B, B))))      # float64, as the example's
    w = rng.normal(size=(E * B, 32)).astype(np.float32)
    return acts.astype(np.float32), w, B


def drive_moe_dispatch(torch, ops, dev, mods):
    """The MoE sparse-dispatch demonstration on the card: the activation
    packed by ``pack_blockcsr`` times the weight through ``ops.spdmm`` (the
    CUDA kernel) against the dense product; its call recorded for the
    kernel check."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.formats import pack_blockcsr
    from repro_torch.models.ffn import moe_dispatch_report

    log("== LM-MoE: block-sparse expert dispatch through spdmm")
    rep = moe_dispatch_report(ARCHS["deepseek-v2-lite-16b"], tokens=4096)
    log(f"  analyzer decision for deepseek-v2-lite dispatch (density "
        f"{rep['density']:.3f}): {rep['primitive']} (TPU-model seconds, "
        "not measured here)")
    acts, w, B = moe_dispatch_operands()
    x = torch.as_tensor(acts, device=dev)
    a = pack_blockcsr(x, B)
    y = torch.as_tensor(w, device=dev)
    ops.reset_cuda_launch_counts()
    z = ops.spdmm(a, y)
    torch.cuda.synchronize()
    launches = ops.cuda_launch_counts()
    err = (z - x @ y).abs().max().item()
    log(f"  block density {a.block_density():.3f} (stored {a.nnzb}/"
        f"{a.n_block_rows * a.n_block_cols} blocks); sparse vs dense max abs "
        f"{err:.3e}; launches {launches}")
    if err > 1e-3:
        raise AssertionError("the block-sparse MoE product disagrees with "
                             "the dense one")
    with Recorder(mods) as rec:
        ops.spdmm(a, y)
    return dict(launches=launches, calls=rec.calls)


def drive_serve_example(cli_extra=()) -> None:
    """``examples_torch/serve_lm.py`` (its three archs through the serve
    CLI, one after another) as a subprocess; it must exit 0."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / "serve_lm.py"),
         *cli_extra], env=cli_env(), cwd=ROOT, capture_output=True,
        text=True, timeout=900)
    log("== LM serving: examples_torch/serve_lm.py")
    for line in proc.stdout.splitlines():
        log(f"  {line}")
    if proc.returncode != 0:
        raise AssertionError(f"examples_torch/serve_lm.py exited "
                             f"{proc.returncode}:\n{proc.stderr[-3000:]}")


def cli_env() -> dict:
    """The environment of a launcher subprocess: ``src`` on its path."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))


def drive_lm(torch, ops, dev, mods, configs, card="", cli_extra=()):
    """The LM serving phase: each config's serve loop, the serve CLI for
    each arch, and the MoE sparse-dispatch demonstration.  ``card`` (name
    and power limit) goes on the phase's summary line."""
    t0 = time.perf_counter()
    results = [drive_lm_arch(torch, arch, cfg, dev, check)
               for arch, cfg, check in configs]
    log("== LM serving: the serve CLI (reduced configs) for each arch")
    drive_serve_cli([arch for arch, _, _ in configs], *cli_extra)
    drive_serve_example(cli_extra)
    moe = drive_moe_dispatch(torch, ops, dev, mods)
    wall = time.perf_counter() - t0
    log(f"LM serving phase: {wall:.1f} s on {card or 'no card'}; summary "
        + json.dumps([{k: v for k, v in r.items() if k != "profile"}
                      | (r["profile"] or {}) for r in results]))
    return results, moe


# ------------------------------------------------------------ LM training
# the two archs of the LM phase that train at full width and depth on one
# card (qwen2.5-3b's state is ~49.4 GB: float32 parameters, gradients and
# two moments), batch 8 x 512 tokens from the port's TokenPipeline, six
# steps on one repeated batch with a six-step cosine from lr 3e-4
TRAIN_ARCHS = ("qwen2.5-3b", "mamba2-780m")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 6
TRAIN_OPT = dict(lr=3e-4, warmup_steps=0, total_steps=TRAIN_STEPS)
# H100 SXM dense bfloat16 tensor-core peak (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
# the flash VJP at qwen2.5-3b's attention: (B, L, Hq, Hkv, Dh, chunk)
FLASH_VJP_SHAPE = (1, 2048, 16, 2, 128, 512)
# the VJP against autograd through flash_attention, |vjp - autograd| <=
# atol + rtol |autograd| + of_max max|autograd|: float32 as the CPU tests
# hold it; in bfloat16 the VJP (as the reference's) saves the output in
# bfloat16, so its delta = rowsum(do * out) carries the output's rounding
# where autograd differentiates the float32 normalization: the two then
# differ by up to 0.41 % of the largest gradient on the CPU at this shape
# (each is 0.3-0.6 % from float32 autograd), held at one bfloat16 ulp of
# the largest, 2^-7
FLASH_VJP_TOL = {"float32": dict(rtol=1e-5, atol=1e-5, of_max=0.0),
                 "bfloat16": dict(rtol=0.0, atol=0.0, of_max=2 ** -7)}
# one float32 train step of a reduced arch: card against CPU, two
# microbatches against one, remat full against none
TRAIN_STEP_TOL = dict(rtol=1e-4, atol=1e-5)
REDUCED_ROWS, REDUCED_SEQ = 16, 16     # 16 rows: every arch's microbatches


def train_configs():
    """(arch, config) of the full-size training runs."""
    from repro_torch.configs import ARCHS
    return [(arch, ARCHS[arch]) for arch in TRAIN_ARCHS]


def train_work(model, cfg, tokens: int, seq: int) -> dict:
    """The least work of one train step: the products' FLOPs (forward 2
    FLOPs a weight a token for every matrix, the head included and the
    embedding lookup not; causal attention scores and values over (L+1)/2
    keys on average; backward twice the forward; ``remat="full"`` one more
    forward of the layers; the SSD scan's own FLOPs are not counted), and
    AdamW's bytes (read p, g, mu, nu, write p, mu, nu).  Their bounds at
    the bfloat16 peak and the HBM rate, and the step's bound, their sum
    (the update cannot start before the last gradient)."""
    head = "embed" if cfg.tie_embeddings else "lm_head"
    layer_mm = sum(p.numel() for n, p in model.named_parameters()
                   if p.ndim >= 2 and n not in ("embed", "lm_head"))
    head_mm = getattr(model, head).numel()
    attn_layers = sum(layer.mixer_type in ("attn", "mla")
                      for layer in model.layers())
    attn = (attn_layers * tokens * 4 * cfg.n_heads * cfg.resolved_head_dim
            * (seq + 1) / 2)
    fwd = 2.0 * (layer_mm + head_mm) * tokens + attn
    flops = 3 * fwd + (fwd - 2.0 * head_mm * tokens
                       if cfg.remat == "full" else 0.0)
    m_item = {"float32": 4, "bfloat16": 2}[cfg.opt_dtype]
    adamw_bytes = sum(p.numel() for p in model.parameters()) * (12 + 4 * m_item)
    flop_ms = 1e3 * flops / PEAK_BF16_FLOPS
    adamw_ms = 1e3 * adamw_bytes / PEAK_HBM_BYTES
    return dict(flops=flops, flop_ms=flop_ms, adamw_bytes=adamw_bytes,
                adamw_ms=adamw_ms, bound_ms=flop_ms + adamw_ms)


def train_tokens(torch, cfg, batch, seq, dev) -> dict:
    """One ``TokenPipeline`` batch of ``cfg``'s vocabulary on ``dev``."""
    from repro_torch.data.lm import TokenPipeline

    pipe = TokenPipeline(vocab=cfg.vocab, batch=batch, seq_len=seq)
    try:
        tokens = next(pipe)["tokens"]
    finally:
        pipe.close()
    return {"tokens": torch.as_tensor(tokens, device=dev).long()}


def timed_step(torch, step, state, batch, dev):
    """One train step between two synchronizations: (state, metrics, host
    seconds, device ms by CUDA events or None off the card)."""
    events = None
    if dev.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if events:
        events[0].record()
    state, metrics = step(state, batch)
    if events:
        events[1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (state, metrics, wall,
            events[0].elapsed_time(events[1]) if events else None)


def profile_train_step(torch, step, state, batch, event_ms):
    """One more step under ``torch.profiler``, device activity only (a
    step is ~70-90 k launches; recording the host's ops as well made the
    profile's processing take most of a minute a step): device busy time,
    launches, the idle share of an event-timed step and the top device
    ops."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = synced_wall(torch, lambda: step(state, batch))
    rows = device_rows(prof)
    profile_s = time.perf_counter() - t0
    if not rows:
        log("  profiler recorded no device time: idle share not measured")
        return None
    busy_ms = sum(r[0] for r in rows) / 1e3
    launches = sum(r[1] for r in rows)
    idle = 1 - busy_ms / event_ms
    log(f"  profiled step: device busy {busy_ms:.3f} ms in {len(rows)} "
        f"kernel names, {launches} launches ({1e3 * wall:.1f} ms wall under "
        f"the profiler, {profile_s:.1f} s with its processing): idle share "
        f"{idle:.4f} of the event-timed step ({event_ms:.3f} ms)")
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"    {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    return dict(busy_ms=busy_ms, launches=launches, idle=idle)


def drive_train_arch(torch, arch, cfg, dev, batch=TRAIN_BATCH,
                     seq=TRAIN_SEQ, steps=TRAIN_STEPS, keep_after=None,
                     profile=True, reverse=False):
    """One arch of the training phase: ``init_state`` from seed 0, then
    ``steps`` steps of ``make_train_step`` on one repeated batch of the
    port's ``TokenPipeline``: finite loss and gradient norm at every
    step, the last loss below the first; per step host wall, device ms,
    tokens/s and peak memory; the step's bound; a profiled step (with
    ``profile``).  With ``keep_after`` the parameters after that many
    steps are kept in host memory (``params_host``), for the sharded
    phase's gates.  With ``reverse`` the batch's microbatches run last to
    first (each the same rows)."""
    import gc

    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig

    t_arch = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bundle = build_model(cfg)
    state, init_s = synced_wall(torch, lambda: init_state(bundle, 0, dev))
    model = state["params"]
    n_params = sum(p.numel() for p in model.parameters())
    feed = train_tokens(torch, cfg, batch, seq, dev)
    if reverse:
        mb = max(1, cfg.microbatches)
        feed = {k: torch.cat(v.chunk(mb)[::-1]) for k, v in feed.items()}
    work = train_work(model, cfg, batch * seq, seq)
    log(f"== LM training: {arch} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype} compute, float32 "
        f"parameters, {cfg.opt_dtype} moments, {cfg.microbatches} "
        f"microbatches{', run in reverse order' if reverse else ''}, "
        f"remat {cfg.remat}): {n_params / 1e9:.3f} B "
        f"parameters, init {init_s:.2f} s, {held / 2**30:.2f} GiB held "
        f"before; batch {batch} x {seq} tokens, repeated")
    log(f"  step bound {work['bound_ms']:.3f} ms = products "
        f"{work['flops'] / 1e12:.2f} TFLOP at {PEAK_BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s ({work['flop_ms']:.3f} ms) + AdamW "
        f"{work['adamw_bytes'] / 1e9:.2f} GB at {PEAK_HBM_BYTES / 1e12:.2f} "
        f"TB/s ({work['adamw_ms']:.3f} ms)")
    step = make_train_step(bundle, AdamWConfig(**TRAIN_OPT))
    rows, kept = [], None
    for i in range(steps):
        state, m, wall, event_ms = timed_step(torch, step, state, feed, dev)
        if keep_after == i + 1:
            kept = {n: p.detach().to("cpu", copy=True)
                    for n, p in model.named_parameters()}
        row = dict(step=i, loss=m["loss"].item(),
                   grad_norm=m["grad_norm"].item(), lr=m["lr"].item(),
                   wall_s=wall, event_ms=event_ms,
                   tokens_per_s=batch * seq / wall,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        rows.append(row)
        ev = f"{event_ms:.1f} ms" if event_ms is not None else "not measured"
        log(f"  step {i}: loss {row['loss']:.4f} gnorm "
            f"{row['grad_norm']:.4f} lr {row['lr']:.3e}; wall "
            f"{1e3 * wall:.1f} ms, device (events) {ev}, "
            f"{row['tokens_per_s']:.1f} tokens/s, peak "
            f"{row['peak_gib']:.2f} GiB")
        if not (np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])):
            raise AssertionError(f"{arch}: step {i} loss {row['loss']} "
                                 f"gnorm {row['grad_norm']}")
    if not rows[-1]["loss"] < rows[0]["loss"]:
        raise AssertionError(f"{arch}: the loss did not fall on the repeated "
                             f"batch: {[r['loss'] for r in rows]}")
    steady = rows[1:] if len(rows) > 1 else rows
    wall = statistics.median(r["wall_s"] for r in steady)
    event_ms = (statistics.median(r["event_ms"] for r in steady)
                if rows[0]["event_ms"] is not None else None)
    out = dict(arch=arch, layers=cfg.n_layers, params=n_params,
               held_gib=held / 2**30, init_s=init_s,
               losses=[r["loss"] for r in rows],
               grad_norms=[r["grad_norm"] for r in rows],
               step_wall_ms=1e3 * wall, step_event_ms=event_ms,
               tokens_per_s=batch * seq / wall,
               peak_gib=max(r["peak_gib"] for r in rows), **work)
    if kept is not None:
        out.update(params_host=kept, params_steps=keep_after)
    log(f"  loss {rows[0]['loss']:.4f} -> {rows[-1]['loss']:.4f}; median "
        f"step (steps 1..{steps - 1}): wall {1e3 * wall:.1f} ms, "
        f"{out['tokens_per_s']:.1f} tokens/s, device "
        f"{event_ms if event_ms is None else round(event_ms, 3)} ms; bound "
        f"{work['bound_ms']:.3f} ms"
        + (f" ({work['bound_ms'] / event_ms:.1%} of the device time, "
           f"{work['bound_ms'] / (1e3 * wall):.1%} of the wall)"
           if event_ms else ""))
    out["profile"] = (profile_train_step(torch, step, state, feed, event_ms)
                      if event_ms and profile else None)
    del state, model, step
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_arch
    log(f"  {arch}: {out['wall_s']:.1f} s for this arch")
    return out


def drive_flash_vjp(torch, dev, shape=FLASH_VJP_SHAPE):
    """``flash_attention_vjp`` against autograd through ``flash_attention``
    on random inputs at ``shape``, causal, in float32 and bfloat16: the
    forward bitwise, dq / dk / dv within ``FLASH_VJP_TOL``; each backward's
    peak memory above the inputs and its device time."""
    from repro_torch.models.layers import flash_attention, flash_attention_vjp

    B, L, Hq, Hkv, Dh, chunk = shape
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(*s):
        return torch.randn(s, generator=gen, device=dev)

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        q, k, v = (draw(B, L, Hq, Dh).to(dtype), draw(B, L, Hkv, Dh).to(dtype),
                   draw(B, L, Hkv, Dh).to(dtype))
        w = draw(B, L, Hq, Dh)

        def run(fn):
            """Forward and backward twice (the first warms up): the
            second's output, gradients and host walls, the first's peak
            memory above the inputs."""
            peak = None
            for _ in range(2):
                ts = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                y, fwd_s = synced_wall(torch, lambda: fn(
                    *ts, causal=True, q_chunk=chunk, kv_chunk=chunk))
                _, bwd_s = synced_wall(
                    torch, lambda: (y.float() * w).sum().backward())
                if peak is None:
                    peak = torch.cuda.max_memory_allocated() - base
            return y.detach(), [t.grad for t in ts], peak, fwd_s, bwd_s

        y, grads, peak, fwd_s, bwd_s = run(flash_attention_vjp)
        ya, agrads, apeak, afwd_s, abwd_s = run(flash_attention)
        if not torch.equal(y, ya):
            raise AssertionError(f"flash VJP {name}: the forward is not "
                                 "flash_attention's")
        tol = FLASH_VJP_TOL[name]
        errs = {}
        for g_name, g, a in zip(("dq", "dk", "dv"), grads, agrads):
            g, a = g.float(), a.float()
            err = (g - a).abs()
            limit = (tol["atol"] + tol["rtol"] * a.abs()
                     + tol["of_max"] * a.abs().max())
            if bool((err > limit).any()):
                raise AssertionError(f"flash VJP {name}: {g_name} differs "
                                     f"from autograd by {err.max().item()}")
            errs[g_name] = err.max().item()
        out[name] = dict(max_abs=errs, vjp_peak_gib=peak / 2**30,
                         autograd_peak_gib=apeak / 2**30,
                         vjp_s=(fwd_s, bwd_s), autograd_s=(afwd_s, abwd_s))
        log(f"== flash VJP, {name}, B {B} L {L} Hq {Hq} Hkv {Hkv} Dh {Dh} "
            f"chunks {chunk}, causal: forward bitwise flash_attention's; "
            f"max abs against autograd {errs} (tolerance {tol}); peak "
            f"memory of forward + backward above the inputs: VJP "
            f"{peak / 2**30:.3f} GiB, autograd {apeak / 2**30:.3f} GiB; "
            f"host wall forward / backward (a second run, each ending in a "
            f"synchronization): VJP {1e3 * fwd_s:.1f} / "
            f"{1e3 * bwd_s:.1f} ms, autograd {1e3 * afwd_s:.1f} / "
            f"{1e3 * abwd_s:.1f} ms")
    return out


def reduced_batch(cfg, rows=REDUCED_ROWS, seq=REDUCED_SEQ, seed=0):
    """numpy inputs of a reduced arch (as the CPU tests make them): frames
    for the enc-dec arch, a frontend-stub prefix and M-RoPE positions for
    the VLM."""
    rng = np.random.default_rng(seed)
    if cfg.n_enc_layers:
        return {"frames": rng.normal(size=(rows, seq, cfg.d_model))
                .astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (rows, seq))}
    if cfg.frontend_prefix > 0:
        lp = int(seq * cfg.frontend_prefix)
        pos = np.broadcast_to(np.arange(seq)[None, :, None], (rows, seq, 3))
        return {"embeds": rng.normal(size=(rows, lp, cfg.d_model))
                .astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (rows, seq - lp)),
                "positions": pos.copy()}
    return {"tokens": rng.integers(0, cfg.vocab, (rows, seq))}


def step_diff(x, y) -> tuple[float, bool]:
    """(max abs of x - y, whether every element is within
    ``TRAIN_STEP_TOL`` of ``y``), on the host."""
    x, y = x.detach().float().cpu(), y.detach().float().cpu()
    d = (x - y).abs()
    lim = TRAIN_STEP_TOL["atol"] + TRAIN_STEP_TOL["rtol"] * y.abs()
    return d.max().item(), bool((d <= lim).all())


def step_error(a, b) -> dict:
    """Max abs differences of two (metrics, model) step results, and
    whether each is within ``TRAIN_STEP_TOL`` (``b`` the reference)."""
    (ma, pa), (mb, pb) = a, b
    out = {k: step_diff(ma[k], mb[k]) for k in ("loss", "grad_norm")}
    params = [step_diff(x, y) for (_, x), (_, y)
              in zip(pa.named_parameters(), pb.named_parameters())]
    out["params"] = (max(e for e, _ in params), all(ok for _, ok in params))
    return out


def halves_error(bundle, init, feed, dev) -> dict:
    """Two microbatches of an MoE arch against the two halves of the
    batch run as one microbatch each and averaged: the loss and every
    gradient (max abs, within ``TRAIN_STEP_TOL``).  MoE capacity is per
    microbatch, in the reference as here, so two microbatches route
    otherwise than one; each half routes as its microbatch does."""
    import copy

    from repro_torch.launch.steps import loss_and_grads, split_batch
    from repro_torch.models.layers import trainable

    model = trainable(copy.deepcopy(init).to(dev))
    loss = loss_and_grads(bundle, model, feed, 2)
    grads = {n: p.grad for n, p in model.named_parameters()}
    halves = trainable(copy.deepcopy(init).to(dev))
    total, acc = 0.0, {}
    for part in split_batch(feed, 2):
        total = total + loss_and_grads(bundle, halves, part)
        for n, p in halves.named_parameters():
            if p.grad is not None:
                acc[n] = acc[n] + p.grad if n in acc else p.grad.clone()

    out = {"loss": step_diff(loss, total / 2)}
    errs = [step_diff(grads[n], acc[n] / 2) for n in acc]
    if sorted(acc) != sorted(n for n, g in grads.items() if g is not None):
        raise AssertionError(f"{bundle.cfg.name}: two microbatches give "
                             "gradients to other parameters than the halves")
    out["grads"] = (max(e for e, _ in errs), all(ok for _, ok in errs))
    return out


def drive_train_reduced(torch, dev, archs=None):
    """Every arch of ``ARCHS`` at ``reduce_config`` in float32: one train
    step on the card equals the same step on the CPU (the config's
    microbatches), two microbatches equal one (an MoE arch: the two
    halves, see ``halves_error``) and ``remat="full"`` equals none on the
    card; each from the same seeded parameters and batch."""
    import copy

    from repro_torch.configs import ARCHS
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.launch.steps import make_train_step, train_state
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig

    cpu = torch.device("cpu")
    results = {}
    for arch in archs or ARCHS:
        base = dataclasses.replace(reduce_config(ARCHS[arch]),
                                   dtype="float32")
        batch = reduced_batch(base)
        init = build_model(base).init(0, cpu)

        def step(cfg, device):
            bundle = build_model(cfg)
            state = train_state(bundle, copy.deepcopy(init).to(device))
            feed = {k: torch.as_tensor(v, device=device)
                    for k, v in batch.items()}
            _, m = make_train_step(bundle, AdamWConfig())(state, feed)
            return m, state["params"]

        one = dataclasses.replace(base, microbatches=1)
        checks = {"card == cpu": (step(base, dev), step(base, cpu))}
        if base.ffn != "moe":
            checks["microbatches 2 == 1"] = (
                step(dataclasses.replace(one, microbatches=2), dev),
                step(one, dev))
        checks["remat full == none"] = (
            step(dataclasses.replace(one, remat="full"), dev),
            step(dataclasses.replace(one, remat="none"), dev))
        errs = {label: step_error(a, b)
                for label, (a, b) in checks.items()}
        if base.ffn == "moe":
            errs["microbatches 2 == the halves"] = halves_error(
                build_model(one), init,
                {k: torch.as_tensor(v, device=dev) for k, v in batch.items()},
                dev)
        log(f"  {arch} (reduced, float32, {base.microbatches} microbatches): "
            + "; ".join(f"{label}: " + ", ".join(
                f"{k} {v[0]:.2e}" for k, v in e.items())
                for label, e in errs.items()))
        bad = [f"{label} {k}" for label, e in errs.items()
               for k, (_, ok) in e.items() if not ok]
        if bad:
            raise AssertionError(f"{arch}: outside {TRAIN_STEP_TOL}: {bad}")
        results[arch] = {label: {k: v[0] for k, v in e.items()}
                         for label, e in errs.items()}
    return results


def drive_train_restart(torch, dev, tmp_dir: str, cli_extra=()):
    """Restart: on reduced qwen2.5-3b in process, 4 steps straight equal 2
    steps, a non-blocking ``save``, ``restore`` into a state from another
    seed and 2 more steps, bitwise (every parameter, moment and the step);
    then ``examples_torch/train_lm.py`` (``python -m
    repro_torch.launch.train`` as the reference's example runs it:
    phi3-mini-3.8b, 12 steps with a checkpoint every 6, then ``--steps 18
    --resume``, which must resume from step 12), beside one
    ``--compress-grads`` run of the launcher."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import state_leaves
    from repro_torch.configs import ARCHS
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig

    cfg = reduce_config(ARCHS["qwen2.5-3b"])
    bundle = build_model(cfg)
    step = make_train_step(bundle, AdamWConfig(total_steps=4))

    def run(state, start, stop):
        pipe = TokenPipeline(vocab=cfg.vocab, batch=8, seq_len=64,
                             start_step=start)
        losses = []
        try:
            for _ in range(start, stop):
                feed = {"tokens": torch.as_tensor(next(pipe)["tokens"],
                                                  device=dev).long()}
                state, m = step(state, feed)
                losses.append(m["loss"].item())
        finally:
            pipe.close()
        return losses

    straight = init_state(bundle, 0, dev)
    want = run(straight, 0, 4)
    resumed = init_state(bundle, 0, dev)
    got = run(resumed, 0, 2)
    mgr = CheckpointManager(Path(tmp_dir) / "in_process", cfg=cfg)
    mgr.save(2, resumed)
    mgr.wait()
    start, resumed = mgr.restore(init_state(bundle, 1, dev))
    got += run(resumed, start, 4)
    leaves = list(zip(state_leaves(resumed), state_leaves(straight)))
    same = all(torch.equal(a, b) for (_, a), (_, b) in leaves)
    log(f"== LM training restart (reduced qwen2.5-3b, {cfg.dtype}): 4 steps "
        f"straight {want}; 2 + save + restore (step {start}) + 2 {got}; "
        f"{len(leaves)} leaves bitwise equal: {same}")
    if start != 2 or got != want or not same:
        raise AssertionError("the restarted run is not bitwise the straight "
                             "one")

    comp = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--batch", "8",
         "--seq", "64", "--arch", "qwen2.5-3b", "--steps", "6",
         "--ckpt-every", "3", "--compress-grads", "--ckpt-dir",
         str(Path(tmp_dir) / "compressed"), *cli_extra], env=cli_env(),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):   # logged below
            demo = example("train_lm").main(
                ["--ckpt-dir", str(Path(tmp_dir) / "demo"), *cli_extra])
    finally:
        try:
            stdout, stderr = comp.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            comp.kill()
            stdout, stderr = comp.communicate()
    wall = time.perf_counter() - t0
    for line in demo:
        log(f"  examples_torch/train_lm.py: {line}")
    for line in stdout.splitlines():
        log(f"  compress-grads: {line}")
    if comp.returncode != 0:
        raise AssertionError(f"train CLI (compress-grads) exited "
                             f"{comp.returncode}:\n{stderr[-3000:]}")
    cut = next(i for i, line in enumerate(demo)
               if line.startswith(">> simulate preemption"))
    lines = {"first": demo[1:cut], "compressed": stdout.splitlines(),
             "resumed": demo[cut + 1:]}
    if lines["resumed"][0] != "[train] resumed from step 12":
        raise AssertionError(f"the resumed run printed {lines['resumed'][0]!r}")
    return dict(losses=got, cli_wall_s=wall, lines=lines)


def drive_train(torch, dev, configs, card="", flash_shape=FLASH_VJP_SHAPE,
                reduced_archs=None, cli_extra=(), **arch_kw):
    """The LM training phase: full-size training of each config, the flash
    VJP at qwen2.5-3b's attention, one step of every reduced arch on the
    card against the CPU, and the restart checks.  ``card`` (name and
    power limit) goes on the phase's summary line."""
    t0 = time.perf_counter()
    walls = {}

    def part(name, fn):
        t = time.perf_counter()
        out = fn()
        walls[name] = time.perf_counter() - t
        return out

    full = part("full", lambda: [drive_train_arch(
        torch, arch, cfg, dev, **arch_kw) for arch, cfg in configs])
    flash = part("flash_vjp", lambda: drive_flash_vjp(torch, dev,
                                                      flash_shape))
    log("== LM training: one float32 step of each reduced arch, card "
        f"against the CPU and variants (tolerance {TRAIN_STEP_TOL}); max "
        "abs differences")
    reduced = part("reduced", lambda: drive_train_reduced(torch, dev,
                                                          reduced_archs))
    with tempfile.TemporaryDirectory() as tmp:
        restart = part("restart", lambda: drive_train_restart(
            torch, dev, tmp, cli_extra))
    wall = time.perf_counter() - t0
    log(f"LM training phase: {wall:.1f} s on {card or 'no card'} (parts, "
        "s: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
        + "); summary "
        + json.dumps([{k: v for k, v in r.items()
                       if k not in ("profile", "params_host")}
                      | (r["profile"] or {}) for r in full]))
    return dict(full=full, flash=flash, reduced=reduced, restart=restart,
                wall_s=wall, part_s=walls)


# ------------------------------------------------------ LM distribution
# qwen2.5-3b trained on a (data 2, model 2) mesh whose coordinates all sit
# on the one card, with the training phase's batch (8 x 512, 4
# microbatches, remat, bfloat16 compute over float32 state), four steps
# on the repeated batch, tensor-parallel over model; then on (data 1,
# model 4); deepseek-v2-lite-16b at 4 of its 27 layers (MLA, 64 experts
# over model) on (data 1, model 4) against its own single-device run;
# psum8 over 4 ranks; a 4-stage pipeline of full-width layers over 8
# microbatches; the elastic restore onto plan_remesh(2, model_parallel=2,
# original_data=2)'s (data 1, model 2) mesh
DIST_ARCH = "qwen2.5-3b"
DIST_MESH = (2, 2)
DIST_STEPS = 4
# the mesh runs of DIST_ARCH (the meshes above, psum8, the pipeline, the
# elastic restore, seq_shard, the witness) keep DIST_LAYERS of its 36
# layers at full width, held against a single-device run of the same
# depth: a group's ranks run in turn on one card, so a mesh step is
# host-bound (whole, the phase took 762.8 s on an NVIDIA H100 80GB HBM3 at
# 700 W, with every microbatch's rows split over (2, 2)); the (1, 1) mesh
# stays whole, against drive_train's run
DIST_LAYERS = 8
TP_MESH = (1, 4)
# TP_MOE_ARCH's mesh runs keep TP_MOE_LAYERS of its 27 layers (4 until
# moe_dispatch_shard's two runs joined them and the whole script took
# 918.3 s on an NVIDIA H100 80GB HBM3 at 700 W)
TP_MOE_ARCH, TP_MOE_LAYERS = "deepseek-v2-lite-16b", 2
# a bfloat16 step whose model axis is > 1 reassociates the row-parallel
# sums, so it is held to gates against the single-device run instead of
# bitwise.  Step 0, which both runs take from the same parameters: the
# loss within the reference's 1e-3 (tests/test_sharding_multidev.py:
# 113-117), which reads the forward pass, and the gradient norm within
# TP_NORM_TOL of the single-device one's (relative), which reads the
# backward pass (readings on NVIDIA H100 80GB HBM3, 700 W: 1.0e-4 on
# (2, 2), 5.9e-4 on (1, 4), 4.7e-5 for deepseek-v2-lite on (1, 4); on the
# CPU at the reduced widths of tests/test_torch_chip_smoke.py 6.3e-4,
# 1.5e-3 and 1.8e-3; a backward that drops or doubles a rank's part moves
# it by percents).  After
# the last step: every parameter within the reference's 5e-3, which no
# gradient can fail at this learning rate (an AdamW step moves an element
# by at most about 1.05 lr, so two runs of 4 steps at lr 3e-4 differ by at
# most about 2.5e-3).  Later losses and norms are logged, not gated: a
# single-device run with its microbatches in reverse order (the same
# microbatches, their sums reassociated) is logged beside them as a
# witness of how far reassociation alone moves them.  On a model axis of
# 1 the losses and norms stay bitwise.  What holds the backward pass
# element by element is the float32 step below
TP_LOSS_TOL, TP_NORM_TOL, TP_PARAM_TOL = 1e-3, 3e-3, 5e-3
# one float32 step at full width and F32_TP_LAYERS layers, on one device
# and on each tensor-parallel mesh from the same parameters and batch,
# with the optimizer of tests/test_torch_sharding_multidev.py: the loss
# and the gradient norm (relative) within its float32 gates, and each
# leaf's gradient within F32_GRAD_TOL of one device's (the norm of the
# difference over the norm; on the CPU at reduced widths, full vocabulary
# for qwen2.5-3b, at most 1.6e-6 over five archs; a rank's part dropped,
# doubled or misplaced moves a leaf by percents).  The tests' gate on each
# element's change (1e-4 at lr 1e-3) does not carry to full width: AdamW's
# first step is g / (|g| + 1e-8), so an element whose gradient is near
# 1e-8 turns float32 noise into a change of a sizeable share of lr (on
# the card, qwen2.5-3b on (2, 2): 2.6e-4 with the loss and the norm
# equal); it is logged, not gated
F32_TP_LAYERS = 2
F32_OPT = dict(lr=1e-3, warmup_steps=0)
F32_LOSS_TOL, F32_NORM_TOL, F32_GRAD_TOL = 1e-5, 1e-5, 1e-4
# a microbatch's rows split over the data ranks (where the residual
# anchor keeps dp) and seq_shard as sequence parallelism over model:
# qwen2.5-3b on (data 2, model 1), no longer bitwise one device's (its
# GEMMs run on fewer rows, the loss and the gradients are summed over the
# ranks), held to the gates above; the prefill of the train batch on
# DIST_MESH in float32 at F32_TP_LAYERS layers within TP_DECODE_F32_TOL of
# one device's logits, its MoE drops equal; qwen2.5-3b with seq_shard on
# TP_MESH for SEQ_STEPS bfloat16 steps whose first loss equals the
# TP_MESH run's bitwise (the norms are per token, the products see the
# same gathered input, a reduce-scatter is the all-reduce's rank-order
# sum, cut), and one float32 step at F32_TP_LAYERS layers whose loss
# equals the same mesh's without seq_shard bitwise and each of whose
# leaves' gradients is within SEQ_GRAD_TOL of it (the norm of the
# difference over the norm: the norm weights' gradients are summed over
# the slices; on the CPU at reduced widths at most 1.0e-6)
DP_MESH = (2, 1)
SEQ_STEPS, SEQ_GRAD_TOL = 2, 1e-5
# moe_dispatch_shard (each data rank's group runs the expert GEMMs of its
# share of the slots, their outputs all-gathered over the data ranks) on
# TP_MOE_ARCH: bfloat16 steps on MOE_SHARD_MESHES against the
# single-device run at the gates above; one float32 step at F32_TP_LAYERS
# layers on DIST_MESH against the same mesh without the flag, the loss and
# each leaf's gradient within MOE_SHARD_REL (relative; on the CPU at
# reduced widths at most 4.9e-7, the loss bitwise) and every routing's
# drops equal; the float32 prefill on DIST_MESH, against one device and
# within MOE_SHARD_REL of the unflagged mesh's logits; the decode on
# DIST_MESH at the smallest batch from LM_BATCH up whose capacity the data
# ranks divide (at LM_BATCH the capacity is 1 and nothing would split)
MOE_SHARD_MESHES = (DIST_MESH, DP_MESH)
MOE_SHARD_REL = 1e-5
MOE_SHARD_DECODE = (4, 4)        # prompt and generated tokens
# the whole config on the (1, 1) mesh: two steps, whose peak memory above
# what was held may exceed the single-device step's by 1 % at most
MESH_1X1_STEPS, MESH_1X1_PEAK = 2, 1.01
PSUM8_RANKS = 4
PIPE_STAGES, PIPE_MICRO = 4, 8


def example(name: str):
    """``examples_torch/<name>.py`` loaded as a module (its ``main`` not
    run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mesh_on(dev, shape):
    """A ``("data", "model")`` mesh of ``shape`` whose every coordinate is
    ``dev``."""
    from repro_torch.launch.mesh import Mesh
    return Mesh.on(dev, shape, ("data", "model"))


def check_shard_bytes(state) -> dict:
    """Every shard of the parameters and both moments holds the bytes its
    spec predicts (the leaf's bytes over the product of the spec's axis
    sizes); returns the bytes each coordinate holds and the distinct
    bytes on the card."""
    from repro_torch.distributed import sharding

    groups = [state["params"], state["opt"]["mu"], state["opt"]["nu"]]
    leaf = next(iter(state["params"].values()))
    per_coord = dict.fromkeys(leaf.mesh.coords(), 0)
    distinct = 0
    for tree in groups:
        for name, lf in tree.items():
            item = lf.dtype.itemsize
            want = (int(np.prod(lf.shape)) * item
                    // int(np.prod([sharding._size(lf.mesh, e)
                                    for e in lf.spec])))
            for coord in lf.mesh.coords():
                got = lf.nbytes(coord)
                if got != want:
                    raise AssertionError(f"{name} at {coord}: {got} bytes, "
                                         f"its spec {lf.spec} predicts {want}")
                per_coord[coord] += got
            distinct += sum(t.numel() * t.element_size()
                            for t in lf.tensors.values())
    return dict(per_coord={str(k): v for k, v in per_coord.items()},
                distinct=distinct)


def drive_sharded_train(torch, dev, cfg, single, batch, seq, steps,
                        shape=DIST_MESH, profile=True):
    """``init_state`` / ``make_train_step`` with ``mesh=`` a ``("data",
    "model")`` mesh of ``shape`` on ``dev``: the shard bytes, ``steps``
    steps on one repeated batch (finite loss and gradient norm, the loss
    falling), per step wall, events, tokens/s, peak memory and the bytes
    the model group's collectives moved for one rank, the bound, a
    profiled step (with ``profile``: launches, idle share).  Against
    ``single``, a ``drive_train_arch`` record of the same config, batch
    and optimizer, where given: every loss and gradient norm bitwise
    where nothing reassociates (a ``model`` axis of 1 and microbatch rows
    the data axes do not split); else (tensor-parallel, or each
    microbatch's rows split over the data ranks) step 0's loss within
    ``TP_LOSS_TOL`` and its gradient norm within ``TP_NORM_TOL``
    (relative), and every parameter after the last step within
    ``TP_PARAM_TOL`` of those ``single`` kept after as many steps (a run
    that kept none fails)."""
    import gc

    from repro_torch.distributed import sharding
    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.models.lm import LM
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mesh = mesh_on(dev, shape)
    bundle = build_model(cfg)
    state, init_s = synced_wall(
        torch, lambda: init_state(bundle, 0, dev, mesh=mesh))
    shard_bytes = check_shard_bytes(state)
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    feed = train_tokens(torch, cfg, batch, seq, dev)
    work = train_work(LM(cfg, device="meta"), cfg, batch * seq, seq)
    T = shape[1]
    log(f"== LM distribution: {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.microbatches} microbatches, remat "
        f"{cfg.remat}, {cfg.dtype} compute) on a (data {shape[0]}, "
        f"model {T}) mesh of {dev} x {mesh.size}"
        + (f", tensor-parallel over a model group of {T}" if T > 1 else "")
        + f": init {init_s:.2f} s (peak {init_peak:.2f} GiB), "
        f"{held / 2**30:.2f} GiB held before; every shard's bytes as its "
        f"spec predicts; per coordinate "
        f"{sorted(set(shard_bytes['per_coord'].values()))} B, distinct on "
        f"the card {shard_bytes['distinct'] / 1e9:.3f} GB; batch {batch} x "
        f"{seq}, repeated; step bound {work['bound_ms']:.3f} ms")
    step = make_train_step(bundle, AdamWConfig(**TRAIN_OPT), mesh=mesh)
    n_ranks = len(step.compute.owner_ranks(feed, cfg.microbatches)[0])
    seq_split = step.compute.layout(feed, batch // cfg.microbatches)[1]
    exact = T == 1 and n_ranks == 1
    log(f"  each microbatch's {batch // cfg.microbatches} rows "
        + (f"split over {n_ranks} data ranks" if n_ranks > 1
           else "whole on one data rank")
        + ("; the sequence split over the model ranks (seq_shard)"
           if seq_split else ""))
    rows = []
    for i in range(steps):
        state, m, wall, event_ms = timed_step(torch, step, state, feed, dev)
        tally = step.compute.tallies.get(0)
        row = dict(step=i, loss=m["loss"].item(),
                   grad_norm=m["grad_norm"].item(), wall_s=wall,
                   event_ms=event_ms, tokens_per_s=batch * seq / wall,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   tp_bytes=tally.as_dict() if tally else {})
        rows.append(row)
        ev = f"{event_ms:.1f} ms" if event_ms is not None else "not measured"
        log(f"  step {i}: loss {row['loss']:.4f} gnorm "
            f"{row['grad_norm']:.4f}; wall {1e3 * wall:.1f} ms, device "
            f"(events) {ev}, {row['tokens_per_s']:.1f} tokens/s, peak "
            f"{row['peak_gib']:.2f} GiB"
            + (f"; model-group collectives of one rank (bytes) "
               f"{row['tp_bytes']}" if tally else ""))
        if not (np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])):
            raise AssertionError(f"sharded step {i}: loss {row['loss']} "
                                 f"gnorm {row['grad_norm']}")
    if not rows[-1]["loss"] < rows[0]["loss"]:
        raise AssertionError("the sharded loss did not fall: "
                             f"{[r['loss'] for r in rows]}")
    peak = max(r["peak_gib"] for r in rows)
    same = gates = None
    if single is not None:
        pairs = [((r["loss"], r["grad_norm"]),
                  (single["losses"][i], single["grad_norms"][i]))
                 for i, r in enumerate(rows)]
        same = all(a == b for a, b in pairs)
        loss_diff = [abs(a[0] - b[0]) for a, b in pairs]
        log(f"  losses and gradient norms against the single-device run's "
            f"(steps 0..{steps - 1}): bitwise {same}; |loss diff| "
            f"{loss_diff}; gradient norm / single-device's - 1 "
            f"{[a[1] / b[1] - 1 for a, b in pairs]}; peak above what was "
            f"held {peak - held / 2**30:.2f} GiB, single-device "
            f"{single['peak_gib'] - single['held_gib']:.2f} GiB")
        if exact and not same:
            raise AssertionError(f"the sharded steps differ from the "
                                 f"single-device run's: {pairs}")
        if not exact:
            if single.get("params_steps") != steps:
                raise AssertionError(
                    f"the single-device run kept no parameters after {steps} "
                    "steps to hold the tensor-parallel run against")
            param_diff = max(
                (sharding.unshard(leaf, dev)
                 - single["params_host"][n].to(dev)).abs().max().item()
                for n, leaf in state["params"].items())
            norm_rel = abs(pairs[0][0][1] / pairs[0][1][1] - 1)
            gates = dict(first_loss_diff=loss_diff[0], first_norm_rel=norm_rel,
                         max_param_diff=param_diff)
            log(f"  gates against the single-device run: step 0 |loss diff| "
                f"{loss_diff[0]:.3e} (limit {TP_LOSS_TOL}), |gradient norm / "
                f"single-device's - 1| {norm_rel:.3e} (limit {TP_NORM_TOL}); "
                f"max |param diff| after step {steps - 1} {param_diff:.3e} "
                f"(limit {TP_PARAM_TOL})")
            if not (loss_diff[0] < TP_LOSS_TOL and norm_rel < TP_NORM_TOL
                    and param_diff < TP_PARAM_TOL):
                raise AssertionError(f"the tensor-parallel steps leave the "
                                     f"gates: {gates}")
    steady = rows[1:] if len(rows) > 1 else rows
    wall = statistics.median(r["wall_s"] for r in steady)
    event_ms = (statistics.median(r["event_ms"] for r in steady)
                if rows[0]["event_ms"] is not None else None)
    out = dict(arch=cfg.name, mesh=tuple(shape), layers=cfg.n_layers,
               rows_split=n_ranks, seq_split=seq_split,
               losses=[r["loss"] for r in rows],
               grad_norms=[r["grad_norm"] for r in rows],
               bitwise_single=same, gates=gates, step_wall_ms=1e3 * wall,
               step_event_ms=event_ms, tokens_per_s=batch * seq / wall,
               peak_gib=peak, peak_above_held_gib=peak - held / 2**30,
               init_s=init_s, tp_bytes=rows[-1]["tp_bytes"],
               init_peak_gib=init_peak, held_gib=held / 2**30,
               shard_bytes=shard_bytes, bound_ms=work["bound_ms"])
    log(f"  median step (steps 1..{steps - 1}): wall {1e3 * wall:.1f} ms, "
        f"{out['tokens_per_s']:.1f} tokens/s, device "
        f"{event_ms if event_ms is None else round(event_ms, 3)} ms; bound "
        f"{work['bound_ms']:.3f} ms")
    out["profile"] = (profile_train_step(torch, step, state, feed, event_ms)
                      if event_ms and profile else None)
    del step
    gc.collect()
    return out, bundle, mesh, state, feed


def drive_single_then_tp(torch, dev, cfg, batch, seq, steps, shape,
                         also=(), flagged=()):
    """``cfg`` trained ``steps`` steps on one device (``drive_train_arch``,
    its parameters kept), its state freed, then on a mesh of ``shape``
    and of each of ``also``, and with ``moe_dispatch_shard`` on each of
    ``flagged`` (:func:`drive_sharded_train`, held to the gates against
    it: the flag changes nothing on one device)."""
    import gc

    single = drive_train_arch(torch, cfg.name, cfg, dev, batch, seq, steps,
                              keep_after=steps, profile=False)
    runs = []
    shard = dataclasses.replace(cfg, moe_dispatch_shard=True)
    for c, sh in ([(cfg, sh) for sh in (shape, *also)]
                  + [(shard, sh) for sh in flagged]):
        gc.collect()
        torch.cuda.empty_cache()
        out, _, _, state, _ = drive_sharded_train(torch, dev, c, single,
                                                  batch, seq, steps, sh)
        del state
        out["moe_shard"] = c.moe_dispatch_shard
        runs.append(out)
    single.pop("params_host")
    gc.collect()
    torch.cuda.empty_cache()
    k = 1 + len(also)
    return dict(single={k: v for k, v in single.items() if k != "profile"},
                sharded=runs[0], also=runs[1:k], flagged=runs[k:])


def drive_reversed(torch, dev, cfg, single, batch, seq, steps, tp_runs):
    """The witness for the bfloat16 drift after the first update: ``cfg``
    on one device again from the same parameters and batch, its
    microbatches run in reverse order (the same microbatches, their sums
    reassociated), against ``single``'s run; its |loss diff| and gradient
    norm / single-device's - 1 at each step logged beside those of the
    tensor-parallel runs ``tp_runs``."""
    rec = drive_train_arch(torch, cfg.name, cfg, dev, batch, seq, steps,
                           profile=False, reverse=True)
    runs = {"reversed microbatches": rec["losses"], **{
        str(r["mesh"]): r["losses"] for r in tp_runs}}
    norms = {"reversed microbatches": rec["grad_norms"], **{
        str(r["mesh"]): r["grad_norms"] for r in tp_runs}}
    out = {k: dict(loss_diff=[abs(a - b) for a, b in
                              zip(v, single["losses"])],
                   norm_rel=[a / b - 1 for a, b in
                             zip(norms[k], single["grad_norms"])])
           for k, v in runs.items()}
    log(f"== LM distribution: drift witness, {cfg.name} against its "
        f"single-device run, steps 0..{steps - 1} (|loss diff|; gradient "
        f"norm / single-device's - 1): " + "; ".join(
            f"{k}: {[f'{x:.3e}' for x in v['loss_diff']]}; "
            f"{[f'{x:.3e}' for x in v['norm_rel']]}"
            for k, v in out.items()))
    return out


def drive_f32_tp(torch, dev, cfg, shapes, batch, seq):
    """One float32 step of ``cfg`` at ``F32_TP_LAYERS`` layers, full
    width, on one device and then on a mesh of each of ``shapes`` (a
    ``model`` axis > 1), from the same parameters and batch at
    ``F32_OPT``: the loss within ``F32_LOSS_TOL``, the gradient norm
    within ``F32_NORM_TOL`` (relative) and each leaf's gradient within
    ``F32_GRAD_TOL`` of the single-device step's (the norm of the
    difference over the norm), every MoE routing's dropped choices equal
    one device's (each of the mesh's groups and ranks routes the whole
    microbatch).  Each element's parameter change is logged against the
    single-device one's, with the leaf, the element and its single-device
    gradient."""
    import gc

    from repro_torch.distributed import sharding
    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig

    cfg = dataclasses.replace(cfg, n_layers=min(cfg.n_layers, F32_TP_LAYERS),
                              dtype="float32")
    bundle = build_model(cfg)
    opt = AdamWConfig(**F32_OPT)
    feed = train_tokens(torch, cfg, batch, seq, dev)
    cpu = torch.device("cpu")
    gc.collect()
    torch.cuda.empty_cache()
    state = init_state(bundle, 0, dev)
    init = {n: p.detach().to(cpu, copy=True)
            for n, p in state["params"].named_parameters()}
    with recording_drops() as drops:
        _, m = make_train_step(bundle, opt)(state, feed)
    want = dict(loss=m["loss"].item(), grad_norm=m["grad_norm"].item())
    grads = {n: p.grad.to(cpu, copy=True)
             for n, p in state["params"].named_parameters()}
    change = {n: p.detach().to(cpu) - init[n]
              for n, p in state["params"].named_parameters()}
    del state, m
    out = dict(arch=cfg.name, layers=cfg.n_layers, single=want, meshes=[])
    for shape in shapes:
        gc.collect()
        torch.cuda.empty_cache()
        mesh = mesh_on(dev, shape)
        state = init_state(bundle, 0, dev, mesh=mesh)
        step = make_train_step(bundle, opt, mesh=mesh)
        seen = {}
        reduce = step.compute.loss_and_grads

        def keep(*args, reduce=reduce, seen=seen):
            loss, got = reduce(*args)
            seen.update(got)
            return loss, got
        step.compute.loss_and_grads = keep
        per_layer = len(step.compute.owner_ranks(
            feed, cfg.microbatches)[0]) * shape[1]
        with recording_drops() as mesh_drops:
            _, m = step(state, feed)
        n_drops, differ = compare_drops(drops, mesh_drops, 1, per_layer)
        grad_rel = {n: ((seen[n].whole().to(cpu) - g).norm()
                        / g.norm()).item() for n, g in grads.items()}
        worst = max(grad_rel, key=grad_rel.get)
        diffs = {n: ((sharding.unshard(leaf, cpu) - init[n])
                     - change[n]).abs()
                 for n, leaf in state["params"].items()}
        at = max(diffs, key=lambda n: diffs[n].max().item())
        i = int(diffs[at].argmax())
        got = dict(mesh=tuple(shape),
                   loss_diff=abs(m["loss"].item() - want["loss"]),
                   norm_rel=abs(m["grad_norm"].item() / want["grad_norm"]
                                - 1),
                   grad_rel=grad_rel[worst], grad_rel_leaf=worst,
                   change_diff=diffs[at].max().item(), change_leaf=at,
                   change_grad=grads[at].flatten()[i].item(),
                   changes_over_1e4=sum(int((d > 1e-4).sum())
                                        for d in diffs.values()),
                   drops=n_drops, routings_differing=differ)
        del state, m, step, seen, diffs, mesh_drops
        out["meshes"].append(got)
        log(f"== LM distribution: one float32 step of {cfg.name} "
            f"({cfg.n_layers} layers, full width, batch {batch} x {seq}, "
            f"lr {opt.lr}) on (data {shape[0]}, model {shape[1]}) against "
            f"one device: |loss diff| {got['loss_diff']:.3e} (limit "
            f"{F32_LOSS_TOL}), |gradient norm / single-device's - 1| "
            f"{got['norm_rel']:.3e} (limit {F32_NORM_TOL}), largest leaf "
            f"gradient |diff| / |single-device's| {got['grad_rel']:.3e} "
            f"({worst}; limit {F32_GRAD_TOL}); largest |change diff| "
            f"{got['change_diff']:.3e} ({at}, flat index {i}, whose "
            f"single-device gradient is {got['change_grad']:.3e}), "
            f"{got['changes_over_1e4']} elements over 1e-4; MoE dropped "
            f"choices {n_drops} on one device, {differ} mesh routings "
            "differing")
        if not (got["loss_diff"] < F32_LOSS_TOL
                and got["norm_rel"] < F32_NORM_TOL
                and got["grad_rel"] < F32_GRAD_TOL and differ == 0):
            raise AssertionError(f"the float32 tensor-parallel step of "
                                 f"{cfg.name} leaves the gates: {got}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def drive_prefill_dp(torch, dev, cfg, batch, seq, shape=DIST_MESH,
                     keep=False):
    """``make_prefill_step`` of one ``batch`` x ``seq`` batch of ``cfg``
    at ``F32_TP_LAYERS`` layers, full width, in float32, on one device
    and on a mesh of ``shape`` (each data rank's rows on its model group,
    every MoE layer routing the whole batch, the logits concatenated in
    rank order): the logits within ``TP_DECODE_F32_TOL`` of one device's,
    every routing's dropped choices equal one device's; both walls and
    rank 0's tally logged.  ``keep``: the mesh's logits in host memory in
    the record (``logits``)."""
    import gc

    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(cfg, n_layers=min(cfg.n_layers, F32_TP_LAYERS),
                              dtype="float32")
    bundle = build_model(cfg)
    feed = train_tokens(torch, cfg, batch, seq, dev)
    gc.collect()
    torch.cuda.empty_cache()
    model = bundle.init(0, dev)
    with recording_drops() as drops:
        want, one_s = synced_wall(
            torch, lambda: make_prefill_step(bundle)(model, feed))
    mesh = mesh_on(dev, shape)
    params = placed_params(model, mesh)
    del model
    step = make_prefill_step(bundle, mesh)
    compute = step.__self__
    n_ranks = compute.layout(feed, batch)[0]
    with recording_drops() as mesh_drops:
        got, mesh_s = synced_wall(torch, lambda: step(params, feed))
    n_drops, differ = compare_drops(drops, mesh_drops, 1,
                                    n_ranks * shape[1])
    out = dict(arch=cfg.name, mesh=tuple(shape), layers=cfg.n_layers,
               rows_split=n_ranks,
               max_abs_err=(got - want).abs().max().item(),
               single_s=one_s, mesh_s=mesh_s, drops=n_drops,
               routings_differing=differ, tally=compute.tallies[0].as_dict())
    if keep:
        out["logits"] = got.to("cpu", copy=True)
    log(f"== LM distribution: the float32 prefill of {cfg.name} "
        f"({cfg.n_layers} layers, full width, batch {batch} x {seq}"
        + (", moe_dispatch_shard" if cfg.moe_dispatch_shard else "")
        + ") on "
        f"(data {shape[0]}, model {shape[1]}), its rows split over "
        f"{n_ranks} data ranks, against one device: max |logit diff| "
        f"{out['max_abs_err']:.3e} (limit {TP_DECODE_F32_TOL}); MoE dropped "
        f"choices {n_drops} on one device, {differ} mesh routings "
        f"differing; wall {one_s:.3f} s one device, {mesh_s:.3f} s the mesh "
        f"(the first call of each); rank 0's tally (bytes) {out['tally']}")
    del params, step, compute, got, want
    gc.collect()
    torch.cuda.empty_cache()
    if not (out["max_abs_err"] <= TP_DECODE_F32_TOL and differ == 0):
        raise AssertionError(f"the prefill on {shape} leaves the gates: "
                             f"{out}")
    return out


def drive_f32_flag(torch, dev, cfg, batch, seq, shape=TP_MESH,
                   flag="seq_shard"):
    """One float32 step of ``cfg`` at ``F32_TP_LAYERS`` layers, full width,
    on a mesh of ``shape`` without and with the config switch ``flag``
    (``seq_shard`` or ``moe_dispatch_shard``), from the same parameters
    and batch at ``F32_OPT``: each leaf's gradient within
    ``SEQ_GRAD_TOL`` (the norm of the difference over the norm) and every
    MoE routing's drops equal; with ``seq_shard`` the losses bitwise
    equal and the sequence split, with ``moe_dispatch_shard`` the loss
    within ``MOE_SHARD_REL`` (relative, its bitwise equality logged) and
    the slots split over the data ranks (``ffn.slots_split``)."""
    import gc

    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.models import ffn
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig

    base = dataclasses.replace(cfg, n_layers=min(cfg.n_layers,
                                                 F32_TP_LAYERS),
                               dtype="float32")
    feed = train_tokens(torch, base, batch, seq, dev)
    mesh = mesh_on(dev, shape)
    cpu = torch.device("cpu")
    rows = batch // cfg.microbatches
    runs = []
    for on in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        bundle = build_model(dataclasses.replace(base, **{flag: on}))
        state = init_state(bundle, 0, dev, mesh=mesh)
        step = make_train_step(bundle, AdamWConfig(**F32_OPT), mesh=mesh)
        seen = {}
        reduce = step.compute.loss_and_grads

        def keep(*args, reduce=reduce, seen=seen):
            loss, got = reduce(*args)
            seen.update({n: g.whole().to(cpu) for n, g in got.items()})
            return loss, got
        step.compute.loss_and_grads = keep
        with recording_drops() as drops:
            _, m, wall, _ = timed_step(torch, step, state, feed, dev)
        n_ranks, seq_split = step.compute.layout(feed, rows)
        split = (seq_split if flag == "seq_shard" else
                 ffn.slots_split(bundle.cfg, rows * seq, n_ranks))
        runs.append(dict(loss=m["loss"].item(), grads=seen, wall_s=wall,
                         split=split, drops=drops,
                         tally=step.compute.tallies[0].as_dict()))
        del state, step, m
    (a, b) = runs
    rel = {n: ((b["grads"][n] - g).norm() / g.norm()).item()
           for n, g in a["grads"].items()}
    worst = max(rel, key=rel.get)
    _, differ = compare_drops(a["drops"], b["drops"], 1, 1)
    loss_rel = abs(b["loss"] / a["loss"] - 1)
    out = dict(arch=base.name, mesh=tuple(shape), layers=base.n_layers,
               flag=flag, split=b["split"],
               loss_bitwise=a["loss"] == b["loss"], loss_rel=loss_rel,
               grad_rel=rel[worst], grad_rel_leaf=worst,
               routings_differing=differ,
               wall_s=[a["wall_s"], b["wall_s"]], tally=b["tally"])
    log(f"== LM distribution: one float32 step of {base.name} "
        f"({base.n_layers} layers, full width) on (data {shape[0]}, model "
        f"{shape[1]}) with {flag} (split: {b['split']}) against the same "
        f"mesh without it: loss bitwise {out['loss_bitwise']} "
        f"({b['loss']!r} / {a['loss']!r}); largest leaf gradient |diff| / "
        f"|without's| {rel[worst]:.3e} ({worst}; limit {SEQ_GRAD_TOL}); MoE "
        f"routings differing {differ} of {len(b['drops'])}; wall "
        f"{a['wall_s']:.2f} / {b['wall_s']:.2f} s; rank 0's tally with it "
        f"(bytes) {b['tally']}, without {a['tally']}")
    gc.collect()
    torch.cuda.empty_cache()
    loss_ok = (out["loss_bitwise"] if flag == "seq_shard"
               else loss_rel < MOE_SHARD_REL)
    if not (out["split"] and loss_ok and rel[worst] < SEQ_GRAD_TOL
            and differ == 0):
        raise AssertionError(f"{flag}'s float32 step leaves the gates: "
                             f"{out}")
    return out


def moe_shard_batch(cfg, n_ranks: int, start: int = LM_BATCH) -> int:
    """The smallest decode batch from ``start`` up that ``n_ranks`` data
    ranks divide and whose MoE capacity they divide
    (``ffn.slots_split``)."""
    from repro_torch.models import ffn
    b = start
    while b % n_ranks or not ffn.slots_split(cfg, b, n_ranks):
        b += 1
    return b


def drive_psum8(torch, bundle, mesh, state, feed, dev):
    """``psum8`` on the embedding gradients of ``PSUM8_RANKS`` ranks (each
    the gradient of one microbatch of the batch, as a data-parallel rank
    would hold it) against their float32 sum: the error under the
    quantisation budget; both timed with CUDA events."""
    import gc

    from repro_torch.launch.steps import MeshCompute, split_batch
    from repro_torch.optim.compression import psum8

    compute = MeshCompute(bundle, mesh)
    # only the embedding's gradient is wanted: the replicas' other
    # parameters take none (11.5 GiB less on the card)
    for m in range(compute.n_model):
        for n, p in compute.rank_replica(dev, m).named_parameters():
            p.requires_grad_(n == "embed")
    xs = []
    for micro in split_batch(feed, PSUM8_RANKS):
        _, grads = compute.loss_and_grads(state["params"], micro)
        g = grads["embed"]
        xs.append(g.whole().clone())
    del compute, grads
    gc.collect()
    out = psum8(xs)
    want = xs[0]
    for x in xs[1:]:
        want = want + x
    err = (out[0] - want).abs().max().item()
    budget = PSUM8_RANKS * 0.5 * max(x.abs().max().item() for x in xs) / 127
    f32_ms = device_ms(torch, lambda: torch.stack(xs).sum(0)) \
        if dev.type == "cuda" else None
    q_ms = device_ms(torch, lambda: psum8(xs)) if dev.type == "cuda" \
        else None
    n = xs[0].numel()
    log(f"== LM distribution: psum8 over {PSUM8_RANKS} ranks of "
        f"{tuple(xs[0].shape)} float32 (the embedding gradients of "
        f"{PSUM8_RANKS} microbatches): max |psum8 - sum| {err:.4e}, budget "
        f"{budget:.4e} ({err / budget:.3f} of it); device ms psum8 {q_ms}, "
        f"float32 sum (stack + sum) {f32_ms}; int8 payload "
        f"{PSUM8_RANKS * n / 1e6:.1f} MB against "
        f"{4 * PSUM8_RANKS * n / 1e6:.1f} MB float32")
    if not err < budget:
        raise AssertionError(f"psum8 error {err} over its budget {budget}")
    shape = tuple(xs[0].shape)
    del xs, out, want
    return dict(shape=(PSUM8_RANKS, *shape), err=err, budget=budget,
                err_over_budget=err / budget, ms=q_ms, f32_sum_ms=f32_ms)


def drive_pipeline(torch, cfg, state, dev):
    """``pipeline_apply`` over a ``("pipe",)`` mesh of ``PIPE_STAGES``
    coordinates on ``dev``, each stage one full-width layer (the first
    layers of the trained state), ``PIPE_MICRO`` microbatches of one
    sequence: equal to the serial run, bitwise."""
    from torch.func import functional_call

    from repro_torch.distributed import sharding
    from repro_torch.distributed.pipeline import (bubble_fraction,
                                                  pipeline_apply)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.lm import Layer, compute_dtype

    layer = Layer(cfg.mixer_pattern[0], cfg, device=dev)
    names = [n for n, _ in layer.named_parameters()]
    cyc = cfg.cycle_len()
    stacked = {n: torch.stack([
        sharding.unshard(state["params"][
            f"cycles.{s // cyc}.layer{s % cyc}.{n}"], dev)
        for s in range(PIPE_STAGES)]) for n in names}
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = torch.randn((PIPE_MICRO, 1, TRAIN_SEQ, cfg.d_model), generator=gen,
                     device=dev).to(compute_dtype(cfg))
    positions = torch.arange(TRAIN_SEQ, device=dev)[None]

    def stage_fn(params, x):
        return functional_call(layer, params, (x, positions))

    mesh = Mesh.on(dev, (PIPE_STAGES,), ("pipe",))
    with torch.no_grad():
        got, wall = synced_wall(torch, lambda: pipeline_apply(
            mesh, stage_fn, stacked, xs))
        serial = []
        for m in range(PIPE_MICRO):
            y = xs[m]
            for s in range(PIPE_STAGES):
                y = stage_fn({n: v[s] for n, v in stacked.items()}, y)
            serial.append(y)
        serial = torch.stack(serial)
    same = torch.equal(got, serial)
    log(f"== LM distribution: pipeline_apply, {PIPE_STAGES} stages of one "
        f"{cfg.name} layer each (d {cfg.d_model}), {PIPE_MICRO} microbatches "
        f"of 1 x {TRAIN_SEQ} in {compute_dtype(cfg)}: bitwise the serial "
        f"run: {same}; wall {1e3 * wall:.1f} ms; bubble fraction "
        f"{bubble_fraction(PIPE_STAGES, PIPE_MICRO):.4f}")
    if not same:
        raise AssertionError("pipeline_apply differs from the serial run")
    return dict(bitwise=same, wall_ms=1e3 * wall,
                bubble=bubble_fraction(PIPE_STAGES, PIPE_MICRO))


def drive_elastic(torch, bundle, state, feed, dev, tmp_dir):
    """Save the mesh state; ``plan_remesh(2, model_parallel=2,
    original_data=2)`` (``(1, 2)``, microbatch scale 2); restore onto that
    mesh on ``dev`` by ``state_shardings`` (every leaf bitwise the saved
    one, every shard by the new spec); one more step with the microbatches
    scaled, finite."""
    import gc

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _from_host
    from repro_torch.distributed import sharding
    from repro_torch.distributed.elastic import plan_remesh
    from repro_torch.launch.steps import make_train_step, state_shardings
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig

    mgr = CheckpointManager(Path(tmp_dir) / "elastic")
    _, save_s = synced_wall(torch, lambda: mgr.save(DIST_STEPS, state,
                                                    blocking=True))
    meta = lambda l: torch.empty(l.shape, dtype=l.dtype,    # noqa: E731
                                 device="meta")
    template = {"params": {n: meta(l) for n, l in state["params"].items()},
                "opt": {"mu": {n: meta(l) for n, l in
                               state["opt"]["mu"].items()},
                        "nu": {n: meta(l) for n, l in
                               state["opt"]["nu"].items()},
                        "step": state["opt"]["step"].clone()}}
    state.clear()
    gc.collect()
    torch.cuda.empty_cache()
    plan = plan_remesh(2, model_parallel=2, original_data=2)
    if plan.mesh_shape != (1, 2) or plan.microbatch_scale != 2:
        raise AssertionError(f"plan_remesh gave {plan}")
    small = mesh_on(dev, plan.mesh_shape)
    t0 = time.perf_counter()
    with small:
        step_no, back = mgr.restore(
            template, shardings=state_shardings(template["params"], small))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    manifest = json.loads((mgr.dir / f"step_{step_no:09d}" /
                           "manifest.json").read_text())
    # checkpoint path -> (parameter name, restored leaf)
    flat = {f"params.{n}": (n, l) for n, l in back["params"].items()}
    flat |= {f"opt.{k}.{n}": (n, l) for k in ("mu", "nu")
             for n, l in back["opt"][k].items()}
    flat["opt.step"] = (None, back["opt"]["step"])
    bad = []
    for i, leaf in enumerate(manifest["leaves"]):
        saved = _from_host(np.load(mgr.dir / f"step_{step_no:09d}" /
                                   f"arr_{i}.npy"), leaf["dtype"])
        name, got = flat[leaf["path"]]
        if isinstance(got, sharding.Sharded):
            if got.spec != sharding.param_spec(name, got.shape, small):
                bad.append(f"{leaf['path']}: spec {got.spec}")
            for coord in small.coords():
                if tuple(got.local(coord).shape) != sharding.block_shape(
                        got.spec, got.shape, small):
                    bad.append(f"{leaf['path']} at {coord}")
            got = sharding.unshard(got, dev)
        if not torch.equal(got, saved.to(dev)):
            bad.append(leaf["path"])
    cfg2 = dataclasses.replace(
        bundle.cfg, microbatches=bundle.cfg.microbatches
        * plan.microbatch_scale)
    step = make_train_step(build_model(cfg2), AdamWConfig(**TRAIN_OPT),
                           mesh=small)
    _, m = step(back, feed)
    loss = m["loss"].item()
    log(f"== LM distribution: elastic: save {save_s:.1f} s "
        f"({len(manifest['leaves'])} leaves), {plan}, restore onto (data "
        f"{plan.mesh_shape[0]}, model {plan.mesh_shape[1]}) "
        f"{restore_s:.1f} s: every leaf bitwise and every shard by the new "
        f"spec: {not bad}; one more step ({cfg2.microbatches} microbatches) "
        f"loss {loss:.4f}")
    if bad:
        raise AssertionError(f"elastic restore differs: {bad[:5]}")
    if not np.isfinite(loss):
        raise AssertionError(f"the step after the elastic restore: {loss}")
    del step, back, flat
    gc.collect()
    torch.cuda.empty_cache()
    return dict(plan=dataclasses.asdict(plan), save_s=save_s,
                restore_s=restore_s, leaves=len(manifest["leaves"]),
                loss_after=loss)


def drive_mesh_1x1(torch, dev, cfg):
    """Two steps of reduced ``cfg`` on the ``(1, 1)`` mesh equal two
    single-device steps bitwise (loss, gradient norm, every parameter,
    both moments)."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig

    bundle = build_model(cfg)
    feed = {k: torch.as_tensor(v, device=dev)
            for k, v in reduced_batch(cfg).items()}
    mesh = mesh_on(dev, (1, 1))
    one, many = init_state(bundle, 0, dev), init_state(bundle, 0, dev,
                                                       mesh=mesh)
    s1 = make_train_step(bundle, AdamWConfig())
    s2 = make_train_step(bundle, AdamWConfig(), mesh=mesh)
    same = True
    for _ in range(2):
        _, m1 = s1(one, feed)
        _, m2 = s2(many, feed)
        same &= all(torch.equal(m1[k], m2[k]) for k in ("loss", "grad_norm"))
    for n, p in one["params"].named_parameters():
        same &= torch.equal(sharding.unshard(many["params"][n], dev), p)
        for k in ("mu", "nu"):
            same &= torch.equal(sharding.unshard(many["opt"][k][n], dev),
                                one["opt"][k][n])
    log(f"== LM distribution: (1, 1) mesh, reduced {cfg.name}: two steps "
        f"bitwise make_train_step's: {same}")
    if not same:
        raise AssertionError("the (1, 1) mesh step differs from "
                             "make_train_step")
    return same


def drive_distributed(torch, dev, cfg, card="", single=None,
                      reduced_cfg=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      steps=DIST_STEPS, moe_cfg=None):
    """The LM distribution phase.  ``cfg`` at ``DIST_LAYERS`` layers
    (``near``: trained on one device first, its parameters kept after
    ``steps`` steps): sharded, tensor-parallel training on a
    ``DIST_MESH`` mesh, ``psum8`` on its embedding gradients, the
    pipeline of its first layers, the elastic restore, then ``TP_MESH``,
    ``DP_MESH`` (rows split, nothing tensor-parallel) and ``seq_shard``
    on ``TP_MESH`` (its first loss bitwise the ``TP_MESH`` run's), and
    the reversed-microbatch witness (:func:`drive_reversed`); the whole
    ``cfg`` on the ``(1, 1)`` mesh (against ``single``,
    ``drive_train_arch``'s record of it on the same batch, where given:
    its peak memory at most ``MESH_1X1_PEAK`` times the single-device
    step's); the ``(1, 1)`` mesh on ``reduced_cfg`` (default:
    ``reduce_config(cfg)``) against ``make_train_step``; ``moe_cfg``
    (default: ``TP_MOE_ARCH`` at ``TP_MOE_LAYERS`` layers) on one device
    and on ``TP_MESH`` and ``DIST_MESH``, and with ``moe_dispatch_shard``
    on ``MOE_SHARD_MESHES``; one float32 step of each on its
    tensor-parallel meshes against one device (:func:`drive_f32_tp`, the
    MoE drops equal); the float32 prefill of each on ``DIST_MESH``
    against one device (:func:`drive_prefill_dp`), ``moe_cfg``'s also
    with the flag; one float32 step of ``cfg`` with ``seq_shard`` against
    the same mesh without it (:func:`drive_f32_flag`); the rest of
    ``moe_dispatch_shard`` (:func:`drive_moe_shard`: a float32 step
    against the unflagged mesh, the flagged prefill against the
    unflagged one, a decode whose capacity the data ranks divide).  The
    mesh steps are held against ``near``'s
    run: bitwise where nothing reassociates (a ``model`` axis of 1,
    microbatch rows not split), within the gates elsewhere.  ``card``
    (name and power limit) goes on the phase's summary line."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.reduced import reduce_config

    t0 = time.perf_counter()
    walls = {}

    def part(name, fn):
        t = time.perf_counter()
        out = fn()
        walls[name] = time.perf_counter() - t
        return out

    full_cfg, cfg = cfg, dataclasses.replace(
        cfg, n_layers=min(cfg.n_layers, DIST_LAYERS))
    near = part("single", lambda: drive_train_arch(
        torch, cfg.name, cfg, dev, batch, seq, steps, keep_after=steps,
        profile=False))
    train, bundle, mesh, state, feed = part("train", lambda: (
        drive_sharded_train(torch, dev, cfg, near, batch, seq, steps)))
    psum = part("psum8", lambda: drive_psum8(torch, bundle, mesh, state,
                                             feed, dev))
    pipe = part("pipeline", lambda: drive_pipeline(torch, cfg, state, dev))
    with tempfile.TemporaryDirectory() as tmp:
        elastic = part("elastic", lambda: drive_elastic(
            torch, bundle, state, feed, dev, tmp))
    del state
    tp4 = part("train_tp", lambda: drive_sharded_train(
        torch, dev, cfg, near, batch, seq, steps, shape=TP_MESH)[0])
    full_1x1 = part("mesh_1x1_full", lambda: drive_sharded_train(
        torch, dev, full_cfg, single, batch, seq, MESH_1X1_STEPS,
        shape=(1, 1), profile=False)[0])
    if single is not None:
        above = single["peak_gib"] - single["held_gib"]
        if not full_1x1["peak_above_held_gib"] <= MESH_1X1_PEAK * above:
            raise AssertionError(
                f"the (1, 1) mesh step peaks at "
                f"{full_1x1['peak_above_held_gib']:.3f} GiB above what was "
                f"held, the single-device step at {above:.3f} GiB")
    one = part("mesh_1x1", lambda: drive_mesh_1x1(
        torch, dev, dataclasses.replace(
            reduced_cfg or reduce_config(full_cfg), dtype="float32")))
    moe_cfg = moe_cfg or dataclasses.replace(ARCHS[TP_MOE_ARCH],
                                             n_layers=TP_MOE_LAYERS)
    moe = part("moe_tp", lambda: drive_single_then_tp(
        torch, dev, moe_cfg, batch, seq, steps, TP_MESH, also=(DIST_MESH,),
        flagged=MOE_SHARD_MESHES))
    f32 = part("f32_tp", lambda: [
        drive_f32_tp(torch, dev, cfg, (DIST_MESH, TP_MESH), batch, seq),
        drive_f32_tp(torch, dev, moe_cfg, (TP_MESH, DIST_MESH), batch, seq)])
    dp = part("train_dp", lambda: drive_sharded_train(
        torch, dev, cfg, near, batch, seq, steps, shape=DP_MESH)[0])
    prefill = part("prefill_dp", lambda: [
        drive_prefill_dp(torch, dev, c, batch, seq, keep=i > 0)
        for i, c in enumerate((cfg, moe_cfg, dataclasses.replace(
            moe_cfg, moe_dispatch_shard=True)))])
    moe_shard = part("moe_shard", lambda: drive_moe_shard(
        torch, dev, moe_cfg, batch, seq, prefill[1:]))
    seq_run = part("seq_shard", lambda: drive_sharded_train(
        torch, dev, dataclasses.replace(cfg, seq_shard=True), None, batch,
        seq, SEQ_STEPS, shape=TP_MESH)[0])
    seq_same = seq_run["losses"][0] == tp4["losses"][0]
    log(f"== LM distribution: {cfg.name} with seq_shard on {TP_MESH} "
        f"(sequence split: {seq_run['seq_split']}): step 0's loss "
        f"{seq_run['losses'][0]!r}, without it {tp4['losses'][0]!r}: "
        f"bitwise {seq_same}")
    if not (seq_run["seq_split"] and seq_same):
        raise AssertionError("seq_shard's first loss differs from the same "
                             "mesh's without it")
    seq_f32 = part("seq_f32", lambda: drive_f32_flag(torch, dev, cfg, batch,
                                                     seq))
    witness = part("witness", lambda: drive_reversed(
        torch, dev, cfg, near, batch, seq, steps, (train, tp4)))
    near.pop("params_host")
    wall = time.perf_counter() - t0
    tp_runs = [train, tp4, moe["sharded"], *moe["also"], *moe["flagged"],
               dp, seq_run]
    log(f"LM distribution phase: {wall:.1f} s on {card or 'no card'} "
        "(parts, s: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
        + "); tensor-parallel steps " + json.dumps(
            [{k: r[k] for k in ("arch", "mesh", "layers", "rows_split",
                                "seq_split", "step_wall_ms",
                                "step_event_ms", "tokens_per_s",
                                "peak_above_held_gib", "gates", "tp_bytes")}
             | (r["profile"] or {}) for r in tp_runs], default=str)
        + "; float32 steps " + json.dumps(f32, default=str)
        + "; prefills " + json.dumps(prefill, default=str)
        + "; float32 seq_shard " + json.dumps(seq_f32, default=str)
        + "; moe_dispatch_shard " + json.dumps(
            {k: v for k, v in moe_shard.items() if k != "decode"}
            | {"decode": [{k: v for k, v in m.items() if k != "profile"}
                          | (m["profile"] or {})
                          for m in moe_shard["decode"]["meshes"]]},
            default=str))
    return dict(near=near, train=train, psum8=psum, pipeline=pipe,
                elastic=elastic, train_tp=tp4, mesh_1x1_full=full_1x1,
                mesh_1x1=one, moe=moe, f32_tp=f32, train_dp=dp,
                prefill_dp=prefill,
                seq_shard=seq_run, seq_f32=seq_f32, moe_shard=moe_shard,
                witness=witness, wall_s=wall, part_s=walls)


def drive_moe_shard(torch, dev, cfg, batch, seq, prefills):
    """``moe_dispatch_shard`` on ``cfg`` (MoE) beyond its bfloat16 steps
    (``drive_single_then_tp``'s ``flagged``): one float32 step on
    ``DIST_MESH`` against the same mesh without it
    (:func:`drive_f32_flag`); the flagged float32 prefill on ``DIST_MESH``
    (``prefills``: :func:`drive_prefill_dp`'s records without and with
    the flag, each held against one device) within ``MOE_SHARD_REL`` of
    the unflagged mesh's logits; the decode at :func:`moe_shard_batch`'s
    batch on ``DIST_MESH`` (:func:`drive_tp_decode_arch` at
    ``TP_MOE_LAYERS`` layers, ``MOE_SHARD_DECODE`` tokens: against one
    device at the decode phase's gates, its CUDA graph bitwise)."""
    from repro_torch.models import ffn

    f32 = drive_f32_flag(torch, dev, cfg, batch, seq, DIST_MESH,
                         "moe_dispatch_shard")
    base, flagged = (p.pop("logits") for p in prefills)
    prefill_rel = ((flagged - base).norm() / base.norm()).item()
    prefill_bitwise = bool(torch.equal(flagged, base))
    tokens = batch * seq
    prefill_split = ffn.slots_split(dataclasses.replace(
        cfg, moe_dispatch_shard=True), tokens, DIST_MESH[0])
    log(f"== LM distribution: the float32 prefill of {cfg.name} with "
        f"moe_dispatch_shard on {DIST_MESH} (capacity "
        f"{ffn.moe_capacity(cfg, tokens)}, slots split: {prefill_split}) "
        f"against the same mesh without it: logits |diff| / |without's| "
        f"{prefill_rel:.3e} (limit {MOE_SHARD_REL}), bitwise "
        f"{prefill_bitwise}")
    if not (prefill_split and prefill_rel < MOE_SHARD_REL):
        raise AssertionError(f"the flagged prefill leaves the gates: "
                             f"{prefill_rel}")
    shard = dataclasses.replace(cfg, moe_dispatch_shard=True,
                                n_layers=min(cfg.n_layers, TP_MOE_LAYERS))
    b = moe_shard_batch(shard, DIST_MESH[0])
    log(f"== LM distribution: the decode of {cfg.name} with "
        f"moe_dispatch_shard on {DIST_MESH} at batch {b} (capacity "
        f"{ffn.moe_capacity(shard, b)}; at batch {LM_BATCH} it is "
        f"{ffn.moe_capacity(shard, LM_BATCH)})")
    decode = drive_tp_decode_arch(torch, cfg.name, shard, dev, (DIST_MESH,),
                                  b, *MOE_SHARD_DECODE)
    return dict(f32=f32, prefill_rel=prefill_rel,
                prefill_bitwise=prefill_bitwise, decode_batch=b,
                decode=decode)


# ------------------------------------------------------------ LM decode on model
# make_serve_step(bundle, mesh) on meshes whose coordinates share the card:
# (arch, layers (None: all), meshes); each arch's bfloat16 serve loop on
# one device (batch LM_BATCH x (LM_PROMPT + LM_GEN), greedy) gives the
# tokens every other run is fed (teacher forcing): one device in float32,
# then on each mesh the bfloat16 step, its CUDA graph, and the float32 step
TP_DECODE_ARCHS = (("qwen2.5-3b", None, ((1, 4), (2, 2))),
                   ("mamba2-780m", None, ((1, 4),)),
                   ("deepseek-v2-lite-16b", 4, ((1, 4), (2, 2))))
# float32 on a mesh against one device at every step: 1e-4 (the tests' gate
# against the reference's sharded serve step), with the MoE dropped
# choices equal.  bfloat16 cannot be held to one device's bfloat16 run:
# any reassociation (the split-KV combine, the row-parallel partial sums,
# another GEMM kernel for a column slice) flips a few roundings in the
# first layer, and those spread through every later bfloat16 op
# (scripts/tp_decode_drift.py on an NVIDIA H100 80GB HBM3 at 700 W:
# qwen2.5-3b's (1, 4) logits 3.1e-2 from one device's at 2 layers, 8.6e-2
# at 36; in float32 4.1e-6; the (d, 1) meshes, which reassociate nothing,
# bitwise).  So the mesh's bfloat16 logits are held against one device's
# float32 logits, no further from them than TP_DECODE_BF16_SLACK times one
# device's own bfloat16 logits are; their distance to one device's
# bfloat16 logits and the greedy agreement are logged
TP_DECODE_F32_TOL, TP_DECODE_BF16_SLACK = 1e-4, 1.5
# one float32 qwen2.5-3b step at the last position of a cache this deep,
# filled from a seeded generator, on (1, 4)
TP_DECODE_LONG, TP_DECODE_LONG_MESH = 32768, (1, 4)


def placed_params(model, mesh) -> dict:
    """``model``'s parameters placed on ``mesh`` by ``params_shardings``."""
    from repro_torch.distributed import sharding
    specs = sharding.params_shardings(model, mesh)
    return {n: sharding.shard(p, specs[n], mesh)
            for n, p in model.named_parameters()}


@contextlib.contextmanager
def recording_drops(enabled=True):
    """While active, every MoE routing's dropped choices (``[tokens, K]``
    booleans) are appended to the yielded list (none when ``enabled`` is
    false: a CUDA-graph capture must not keep them)."""
    from repro_torch.models import ffn
    drops, route = [], ffn.moe_route

    def recording(m, xf):
        out = route(m, xf)
        drops.append((out.order == m.cfg.n_experts * out.cap).clone())
        return out

    if enabled:
        ffn.moe_route = recording
    try:
        yield drops
    finally:
        ffn.moe_route = route


def forced_loop(decode, params, cache, tokens) -> list:
    """The decode step fed ``tokens[:, t]`` at position t: its logits at
    every step (``cache`` written in place)."""
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = decode(params, cache, tokens[:, t:t + 1], t)
        out.append(logits)
    return out


def compare_drops(single, mesh, n_steps, per_layer) -> tuple[int, int]:
    """The mesh's dropped choices (``per_layer`` routings of each MoE layer
    and step, after each other) against the single device's (one each):
    ``(dropped choices of one device, mesh routings that differ)``."""
    if not single:
        return 0, 0
    n_moe = len(single) // n_steps
    if len(mesh) != len(single) * per_layer:
        raise AssertionError(f"{len(mesh)} routings on the mesh, "
                             f"{len(single)} x {per_layer} expected")
    differ = 0
    for k, want in enumerate(single):
        for got in mesh[k * per_layer:(k + 1) * per_layer]:
            differ += not bool((got == want).all())
    return int(sum(int(d.sum()) for d in single)), differ


def max_err(torch, xs, ys) -> float:
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(xs, ys))


def mesh_step(bundle, mesh):
    """``make_serve_step(bundle, mesh)`` called as ``bundle.decode_step``
    is."""
    from repro_torch.launch.steps import make_serve_step
    step = make_serve_step(bundle, mesh)
    return step, lambda p, c, tok, t: step(p, c, {"tokens": tok, "pos": t})


def drive_tp_decode_mesh(torch, bundle, bundle32, params, dev, shape, tokens,
                         ref, profile=True):
    """One mesh of the decode phase, from the parameters ``params`` placed
    on it: ``tokens`` through the eager bfloat16 mesh step, timed (held
    against one device's float32 logits, no further than
    ``TP_DECODE_BF16_SLACK`` times one device's bfloat16 logits; their
    distance to one device's bfloat16 logits, the greedy agreement and
    the MoE drops logged), then through ``CapturedDecode`` (the capture
    run, then a timed run of replays on the zeroed cache: both bitwise
    the eager steps) and a profiled replay; then the float32 mesh step
    (``bundle32``), within ``TP_DECODE_F32_TOL`` of one device's at every
    step with its MoE dropped choices equal.  ``ref``: one device's
    bfloat16 and float32 logits and drops."""
    import gc

    from repro_torch.distributed import sharding
    from repro_torch.launch.steps import CapturedDecode, cache_leaves

    batch, n = tokens.shape
    mesh = params[next(iter(params))].mesh
    label = f"{bundle.cfg.name} on {shape}"

    def fresh(b):
        return sharding.shard_cache(b.init_cache(batch, n, dev), mesh)

    step, eager = mesh_step(bundle, mesh)
    per_layer = 0
    with recording_drops(bool(ref["drops"])) as drops:
        got, eager_s = synced_wall(torch, lambda: forced_loop(
            eager, params, fresh(bundle), tokens))
        per_layer = len(step.compute.tallies) * step.compute.n_model
    n_drops, differ = compare_drops(ref["drops"], drops, n, per_layer)
    err = max_err(torch, ref["bf16"], got)
    err32 = max_err(torch, ref["f32"], got)
    agree = float(np.mean([bool(torch.equal(a.argmax(-1), b.argmax(-1)))
                           for a, b in zip(ref["bf16"], got)]))
    decode = CapturedDecode(bundle, step)
    cap_cache = fresh(bundle)
    replay, first_s = synced_wall(torch, lambda: forced_loop(
        decode, params, cap_cache, tokens))
    for t in cache_leaves(cap_cache):
        t.zero_()
    replay2, replay_s = synced_wall(torch, lambda: forced_loop(
        decode, params, cap_cache, tokens))
    bitwise = all(torch.equal(a, b) and torch.equal(a, c)
                  for a, b, c in zip(got, replay, replay2))
    rec = dict(arch=bundle.cfg.name, mesh=shape, steps=n,
               max_abs_err=err, err_vs_f32=err32,
               single_err_vs_f32=ref["bf16_vs_f32"], greedy_agree=agree,
               replay_bitwise=bitwise, drops=n_drops,
               routings_differing_bf16=differ, captures=decode.captures,
               eager_step_ms=1e3 * eager_s / n,
               replay_step_ms=1e3 * replay_s / n, capture_run_s=first_s,
               tally=step.compute.tallies[0].as_dict(),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    rec["profile"] = (profile_lm_step(torch, decode, params, cap_cache,
                                      tokens[:, :1], n - 1)
                      if profile and dev.type == "cuda" else None)
    del step, eager, decode, cap_cache, got, replay, replay2
    gc.collect()
    torch.cuda.empty_cache()
    step32, eager32 = mesh_step(bundle32, mesh)
    with recording_drops(bool(ref["drops"])) as drops32:
        got32 = forced_loop(eager32, params, fresh(bundle32), tokens)
    f32_err = max_err(torch, ref["f32"], got32)
    n32, differ32 = compare_drops(ref["drops32"], drops32, n, per_layer)
    rec.update(f32_max_abs_err=f32_err, f32_drops=n32,
               f32_routings_differing=differ32)
    log(f"  mesh {shape}: bfloat16 logits {err:.3e} from one device's "
        f"bfloat16 logits (greedy agreement {agree:.3f}), {err32:.3e} from "
        f"its float32 logits (one device's bfloat16: "
        f"{ref['bf16_vs_f32']:.3e}; gate {TP_DECODE_BF16_SLACK}x); "
        f"bfloat16 MoE routings differing from one device's {differ} of "
        f"{len(drops)}; replays bitwise the eager steps: {bitwise}; "
        f"float32 logits {f32_err:.3e} from one device's (gate "
        f"{TP_DECODE_F32_TOL}), dropped choices {n32}, routings differing "
        f"{differ32}; per step: eager {rec['eager_step_ms']:.3f} ms, "
        f"replayed {rec['replay_step_ms']:.3f} ms (host wall over {n} "
        f"steps; the ranks share one card and run in turn), capture run "
        f"{first_s:.2f} s; peak {rec['peak_gib']:.2f} GiB; rank 0's tally "
        f"a bfloat16 step {json.dumps(rec['tally'])}")
    if err32 > TP_DECODE_BF16_SLACK * ref["bf16_vs_f32"]:
        raise AssertionError(f"{label}: bfloat16 logits {err32:.3e} from one "
                             "device's float32 logits, one device's "
                             f"bfloat16 {ref['bf16_vs_f32']:.3e}")
    if f32_err > TP_DECODE_F32_TOL:
        raise AssertionError(f"{label}: float32 logits {f32_err:.3e} from "
                             "one device's")
    if differ32:
        raise AssertionError(f"{label}: {differ32} float32 MoE routings drop "
                             "other choices than one device's")
    if not bitwise:
        raise AssertionError(f"{label}: captured replays differ from the "
                             "eager mesh steps")
    if dev.type == "cuda" and rec["captures"] != 1:
        raise AssertionError(f"{label}: {rec['captures']} captures")
    return rec


def drive_tp_decode_arch(torch, arch, cfg, dev, meshes, batch=LM_BATCH,
                         prompt_len=LM_PROMPT, gen=LM_GEN, one=False):
    """One arch of the decode phase: the single-device bfloat16 serve loop
    (greedy), the single-device float32 decode fed its tokens, then each
    mesh (:func:`drive_tp_decode_mesh`); with ``one`` also the ``(1, 1)``
    mesh, bitwise the single-device bfloat16 decode."""
    import gc

    from repro_torch.models.registry import build_model

    bundle = build_model(cfg)
    bundle32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    torch.cuda.reset_peak_memory_stats()
    model = bundle.init(0, dev)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, prompt_len)), device=dev)
    moe = cfg.ffn == "moe"
    with recording_drops(moe) as drops:
        single, toks = serve_loop(torch, bundle, model, bundle.decode_step,
                                  prompts, gen, bundle.init_cache(
                                      batch, prompt_len + gen, dev))
    tokens = torch.cat([prompts, toks], dim=1)
    model32 = bundle32.init(0, dev)
    with recording_drops(moe) as drops32:
        single32 = forced_loop(bundle32.decode_step, model32,
                               bundle32.init_cache(batch, prompt_len + gen,
                                                   dev), tokens)
    del model32
    gc.collect()
    torch.cuda.empty_cache()
    ref = dict(bf16=single, f32=single32, drops=drops, drops32=drops32,
               bf16_vs_f32=max_err(torch, single32, single))
    log(f"== LM decode on a model axis: {arch} ({cfg.n_layers} layers, "
        f"{cfg.dtype}), batch {batch} x ({prompt_len} + {gen}) tokens, one "
        f"device's greedy tokens {toks[0, :8].tolist()}...; one device's "
        f"bfloat16 logits {ref['bf16_vs_f32']:.3e} from its float32 logits")
    out = dict(arch=arch, layers=cfg.n_layers, meshes=[],
               single_err_vs_f32=ref["bf16_vs_f32"])
    for shape in meshes:
        params = placed_params(model, mesh_on(dev, shape))
        out["meshes"].append(drive_tp_decode_mesh(
            torch, bundle, bundle32, params, dev, shape, tokens, ref))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    if one:
        from repro_torch.distributed import sharding
        mesh = mesh_on(dev, (1, 1))
        _, eager = mesh_step(bundle, mesh)
        got = forced_loop(eager, placed_params(model, mesh),
                          sharding.shard_cache(bundle.init_cache(
                              batch, prompt_len + gen, dev), mesh), tokens)
        out["mesh_1x1_bitwise"] = all(torch.equal(a, b)
                                      for a, b in zip(single, got))
        log(f"  mesh (1, 1): bitwise the single-device decode at every "
            f"step: {out['mesh_1x1_bitwise']}")
        if not out["mesh_1x1_bitwise"]:
            raise AssertionError("the (1, 1) mesh decode differs from the "
                                 "single-device decode")
    return out


def drive_tp_decode_long(torch, cfg, dev, shape, tokens, pos):
    """One float32 decode step of ``cfg`` at position ``pos`` against a
    ``pos + 1``-deep cache filled from a seeded ``torch.Generator``, on one
    device and on the mesh ``shape`` from the same parameters: logits
    within ``TP_DECODE_F32_TOL``; the step timed on both."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.steps import cache_leaves
    from repro_torch.models.registry import build_model

    bundle = build_model(dataclasses.replace(cfg, dtype="float32"))
    model = bundle.init(0, dev)
    cache = bundle.init_cache(tokens.shape[0], pos + 1, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for t in cache_leaves(cache):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    mesh = mesh_on(dev, shape)
    params = placed_params(model, mesh)
    placed = sharding.shard_cache(cache, mesh)
    step, eager = mesh_step(bundle, mesh)
    a, _ = bundle.decode_step(model, cache, tokens, pos)
    b, _ = eager(params, placed, tokens, pos)
    err = (a - b).abs().max().item()
    single_ms = mesh_ms = None
    if dev.type == "cuda":
        # the same step again (it rewrites its slot with the same values)
        single_ms = device_ms(torch, lambda: bundle.decode_step(
            model, cache, tokens, pos), reps=3, inner=1)
        mesh_ms = device_ms(torch, lambda: eager(params, placed, tokens,
                                                 pos), reps=3, inner=1)
    rec = dict(arch=cfg.name, mesh=shape, depth=pos + 1, max_abs_err=err,
               single_ms=single_ms, mesh_ms=mesh_ms,
               tally=step.compute.tallies[0].as_dict())
    log(f"  float32, mesh {shape}, one step at position {pos} of a "
        f"{pos + 1}-deep cache filled from a seeded generator: logits "
        f"within {err:.3e} of one device's (gate {TP_DECODE_F32_TOL}); the "
        f"step by CUDA events: one device {single_ms} ms, the mesh "
        f"{mesh_ms} ms (its ranks share one card and run in turn: this "
        f"time says nothing of {shape[1]} cards); rank 0's tally "
        f"{json.dumps(rec['tally'])}")
    if err > TP_DECODE_F32_TOL:
        raise AssertionError(f"{cfg.name} float32 at position {pos} on "
                             f"{shape}: logits {err:.3e} from one device's")
    return rec


def drive_tp_decode(torch, dev, card="", configs=None, long_len=TP_DECODE_LONG,
                    batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN):
    """The decode-on-``model`` phase: each of ``configs`` ((arch, config,
    meshes); default ``TP_DECODE_ARCHS`` at full width) through
    :func:`drive_tp_decode_arch` (the first also on the ``(1, 1)`` mesh),
    then the first config's float32 step at position ``long_len - 1`` on
    ``TP_DECODE_LONG_MESH`` (:func:`drive_tp_decode_long`)."""
    import gc

    from repro_torch.configs import ARCHS

    t0 = time.perf_counter()
    if configs is None:
        configs = [(arch, ARCHS[arch] if n is None
                    else dataclasses.replace(ARCHS[arch], n_layers=n), meshes)
                   for arch, n, meshes in TP_DECODE_ARCHS]
    runs = []
    for i, (arch, cfg, meshes) in enumerate(configs):
        runs.append(drive_tp_decode_arch(torch, arch, cfg, dev, meshes,
                                         batch, prompt_len, gen, one=i == 0))
        gc.collect()
        torch.cuda.empty_cache()
    cfg = configs[0][1]
    long = drive_tp_decode_long(
        torch, cfg, dev, TP_DECODE_LONG_MESH, torch.as_tensor(
            np.random.default_rng(1).integers(0, cfg.vocab, (batch, 1)),
            device=dev), long_len - 1)
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"LM decode-on-model phase: {wall:.1f} s on {card or 'no card'}; "
        "summary " + json.dumps(
            [{k: v for k, v in m.items() if k != "profile"}
             | (m["profile"] or {}) for r in runs for m in r["meshes"]]
            + [long], default=str))
    return dict(runs=runs, long=long, wall_s=wall)


# ------------------------------------------------------------ LM dry-run
# the dry-run's count (launch/dryrun.py, on the meta device) of the
# training phase's qwen2.5-3b step (batch 8 x 512, 4 microbatches, remat
# full) on the (1, 1) mesh, held against the same step on the card: FLOPs
# equal, the peak within DRYRUN_PEAK_TOL; and two production cells of the
# dry-run CLI, run as subprocesses beside the count (a train_4k cell now
# counts three microbatches of every rank's rows, not one whole: qwen2.5-3b's
# took 260.8 s on the card machine's CPU, mamba2-780m's is the shortest)
DRYRUN_ARCH = "qwen2.5-3b"
DRYRUN_PEAK_TOL = 0.15
DRYRUN_CELLS = (("mamba2-780m", "train_4k", "single"),
                ("deepseek-v2-lite-16b", "decode_32k", "single"))
DRYRUN_CELL_TIMEOUT = 900
# the tensor-parallel step's FLOPs on the card (FlopCounterMode) against the
# sum of the dry-run's per-rank counts, on a (data 1, model 2) mesh; remat
# off, so that each rank's count (its own program, whose checkpoint would
# skip its own last product's recompute) and the one-process step (which
# recomputes every rank's but the last's) run the same products
TP_COUNT_MESH = (1, 2)
_RANK_COUNT = """
import dataclasses, json, sys
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in json.loads(sys.argv[1]).items()})
batch, seq, rank = map(int, sys.argv[2:5])
shape = tuple(map(int, sys.argv[5].split("x")))
r = dryrun.count_cell(cfg, ShapeConfig("chip_smoke", seq, batch, "train"),
                      Mesh.on("meta", shape, ("data", "model")),
                      model_rank=rank)
print("COUNT " + json.dumps({"flops": r["cost"]["flops"],
                             "busiest": r["busiest"],
                             "tp_collectives": r["tp_collectives"],
                             "peak_gb": r["memory"]["peak_per_device_gb"]}))
"""


def start_dryrun_cells(out_dir: str, cells) -> list:
    """``python -m repro_torch.launch.dryrun`` for each (arch, shape, mesh)
    of ``cells``, started as subprocesses (they need no card)."""
    return [(cell, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--mesh", cell[2], "--out", out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=cli_env(), cwd=ROOT)) for cell in cells]


def finish_dryrun_cells(procs, out_dir: str,
                        timeout=DRYRUN_CELL_TIMEOUT) -> list[dict]:
    """Wait for the cells of :func:`start_dryrun_cells`, log their lines
    and return their records; a cell that fails, errs or runs out of
    time raises (every subprocess is ended either way)."""
    out = []
    try:
        for (arch, shape, mesh), proc in procs:
            text, _ = proc.communicate(timeout=timeout)
            path = Path(out_dir) / f"{arch}__{shape}__{mesh}.json"
            rec = json.loads(path.read_text()) if path.exists() else {}
            log(f"== LM dry-run cell {arch} x {shape} x {mesh} (exit "
                f"{proc.returncode}):")
            for line in text.strip().splitlines():
                log(f"  {line}")
            if rec.get("status") == "ok":
                coll = rec["collectives"]
                log(f"  one device a step (counts, not timings): all-gather "
                    f"{coll['all-gather'] / 1e9:.3f} GB, all-reduce "
                    f"{coll['all-reduce'] / 1e9:.3f} GB; its model group's "
                    f"collectives {json.dumps(rec['tp_collectives'])}; "
                    f"busiest {json.dumps(rec['busiest'])}")
            if proc.returncode or rec.get("status") not in (
                    "ok", "skipped-by-design"):
                raise AssertionError(f"dry-run cell {arch} x {shape} x "
                                     f"{mesh}: exit {proc.returncode}, "
                                     f"status {rec.get('status')}")
            out.append(rec)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def start_rank_counts(cfg, batch: int, seq: int, shape) -> list:
    """The dry-run's count of each model rank of ``cfg``'s train step on a
    meta mesh of ``shape``, one subprocess a rank (they need no card)."""
    arg = json.dumps(dataclasses.asdict(cfg))
    return [subprocess.Popen(
        [sys.executable, "-c", _RANK_COUNT, arg, str(batch), str(seq),
         str(m), "x".join(map(str, shape))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=cli_env(), cwd=ROOT) for m in range(shape[1])]


def finish_rank_counts(procs, timeout=DRYRUN_CELL_TIMEOUT) -> list[dict]:
    """The records of :func:`start_rank_counts`' subprocesses, in rank
    order; one that fails raises (every subprocess is ended either way)."""
    out = []
    try:
        for m, proc in enumerate(procs):
            text, _ = proc.communicate(timeout=timeout)
            lines = [l for l in text.splitlines() if l.startswith("COUNT ")]
            if proc.returncode or not lines:
                raise AssertionError(f"rank {m}'s count: exit "
                                     f"{proc.returncode}: {text[-2000:]}")
            out.append(json.loads(lines[-1][len("COUNT "):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def card_tp_step_flops(torch, cfg, dev, batch, seq, shape) -> dict:
    """One tensor-parallel train step of ``cfg`` (seed 0, one random batch)
    on a mesh of ``shape`` on ``dev`` under ``FlopCounterMode``: its
    FLOPs, loss and the model group's tally of one rank."""
    import gc

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig

    gc.collect()
    torch.cuda.empty_cache()
    bundle = build_model(cfg)
    mesh = mesh_on(dev, shape)
    state = init_state(bundle, 0, dev, mesh=mesh)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (batch, seq))
    feed = {"tokens": torch.as_tensor(tokens, device=dev).long()}
    step = make_train_step(bundle, AdamWConfig(**TRAIN_OPT), mesh=mesh)
    with FlopCounterMode(display=False) as fc:
        state, m = step(state, feed)
    out = dict(flops=fc.get_total_flops(), loss=float(m["loss"]),
               tp_collectives=step.compute.tallies[0].as_dict())
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_flops_causes(cfg, tokens: int, seq: int) -> dict:
    """What a counted train step of a dense arch whose layers are all in
    cycles does beyond and short of ``train_work``'s products: the flash
    attention computes every key of each chunk (512 keys, or the whole
    sequence when shorter) where ``train_work`` counts (L + 1) / 2 a query
    (forward, backward twice, one recompute), and the checkpoint's early
    stop does not recompute the last product of each cycle (its
    ``w_down``), whose output the backward does not need."""
    n_cycles = cfg.n_layers // cfg.cycle_len()
    attn_layers = n_cycles * sum(mt in ("attn", "mla")
                                 for mt in cfg.mixer_pattern)
    chunk = min(512, seq)
    keys = -(-seq // chunk) * chunk
    per_key = attn_layers * tokens * 4 * cfg.n_heads * cfg.resolved_head_dim
    passes = 3 + (cfg.remat == "full")
    attn = per_key * (keys - (seq + 1) / 2) * passes
    early = (2.0 * tokens * cfg.d_model * cfg.d_ff * n_cycles
             if cfg.remat == "full" else 0.0)
    return dict(full_chunks=attn, early_stop=early)


def card_train_step(torch, cfg, dev, batch, seq) -> dict:
    """``cfg``'s training state from seed 0 and three steps of
    ``make_train_step`` on one random batch: the first's peak memory above
    what the process held before the state, the second's FLOPs under
    ``FlopCounterMode`` (its module tracker holds tensors, so it is not
    around the step whose peak is read), the third's device ms."""
    import gc

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    bundle = build_model(cfg)
    state = init_state(bundle, 0, dev)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (batch, seq))
    feed = {"tokens": torch.as_tensor(tokens, device=dev).long()}
    step = make_train_step(bundle, AdamWConfig(**TRAIN_OPT))
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, feed)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    with FlopCounterMode(display=False) as fc:
        state, m2 = step(state, feed)
    state, m3, wall, event_ms = timed_step(torch, step, state, feed, dev)
    losses = [float(x["loss"]) for x in (m, m2, m3)]
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"card steps' losses {losses}")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(flops=fc.get_total_flops(), held=held - base,
                peak=peak - base, event_ms=event_ms, wall_s=wall,
                losses=losses)


def drive_dryrun(torch, dev, cfg, card="", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                 cells=DRYRUN_CELLS):
    """The LM dry-run phase: ``count_cell`` of ``cfg``'s train step at
    ``batch`` x ``seq`` on the (1, 1) mesh of meta coordinates, then the
    same step on the card (:func:`card_train_step`): FLOPs equal, the peak
    above what the process held before the state within
    ``DRYRUN_PEAK_TOL`` of the counted peak (off the card, where no
    memory is measured, not checked), the roofline bound's share of the
    measured step; the ratio to ``train_work`` with its causes; and the
    dry-run CLI on ``cells``, run beside the rest as subprocesses."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.registry import build_model

    t0 = time.perf_counter()
    tp_cfg = dataclasses.replace(cfg, remat="none")
    with tempfile.TemporaryDirectory() as tmp:
        procs = start_dryrun_cells(tmp, cells)
        rank_procs = start_rank_counts(tp_cfg, batch, seq, TP_COUNT_MESH)
        try:
            shape = ShapeConfig("chip_smoke", seq, batch, "train")
            t = time.perf_counter()
            counted = dryrun.count_cell(cfg, shape, Mesh.on(
                "meta", (1, 1), ("data", "model")))
            count_s = time.perf_counter() - t
            mem, terms = counted["memory"], counted["roofline"]
            flops = counted["cost"]["flops"]
            predicted = (mem["shard_bytes"] + mem["replica_bytes"]
                         + mem["activation_bytes"])
            log(f"== LM dry-run: {cfg.name} train step, batch {batch} x "
                f"{seq}, {cfg.microbatches} microbatches, remat "
                f"{cfg.remat}, counted on the (1, 1) meta mesh in "
                f"{count_s:.1f} s (counts at H100 constants, not timings): "
                f"{flops / 1e12:.4f} TFLOP, "
                f"{counted['cost']['bytes_accessed'] / 1e12:.4f} TB, peak "
                f"{predicted / 2**30:.2f} GiB (held {(mem['shard_bytes'] + mem['replica_bytes']) / 2**30:.2f} + "
                f"activations {mem['activation_bytes'] / 2**30:.2f}); bound "
                f"{1e3 * terms['total_bound_s']:.3f} ms "
                f"({terms['dominant']})")
            work = train_work(build_model(cfg).abstract_params(), cfg,
                              batch * seq, seq)
            causes = train_flops_causes(cfg, batch * seq, seq)
            explained = (work["flops"] + causes["full_chunks"]
                         - causes["early_stop"])
            log(f"  counted / train_work = {flops / work['flops']:.4f} "
                f"({flops / 1e12:.4f} / {work['flops'] / 1e12:.4f} TFLOP): "
                f"+{causes['full_chunks'] / 1e12:.4f} TFLOP the flash "
                "attention computes every key of a chunk (train_work "
                "counts (L + 1) / 2 a query), "
                f"-{causes['early_stop'] / 1e12:.4f} TFLOP the "
                "checkpoint's early stop recomputes no w_down; train_work "
                f"+ those = {explained / 1e12:.4f} TFLOP (== counted: "
                f"{explained == flops})")
            measured = card_train_step(torch, cfg, dev, batch, seq)
            tp_card = card_tp_step_flops(torch, tp_cfg, dev, batch, seq,
                                         TP_COUNT_MESH)
        except BaseException:
            for proc in [p for _, p in procs] + rank_procs:
                proc.kill()
                proc.wait()
            raise
        cell_recs = finish_dryrun_cells(procs, tmp)
        ranks = finish_rank_counts(rank_procs)
    log(f"  card step: {measured['flops'] / 1e12:.4f} TFLOP under "
        f"FlopCounterMode; counted == card: {measured['flops'] == flops}")
    if measured["flops"] != flops:
        raise AssertionError(f"counted {flops} FLOPs, the card's step "
                             f"{measured['flops']}")
    rank_sum = sum(r["flops"] for r in ranks)
    log(f"  tensor-parallel step, (data {TP_COUNT_MESH[0]}, model "
        f"{TP_COUNT_MESH[1]}) mesh, remat none: card "
        f"{tp_card['flops'] / 1e12:.4f} TFLOP under FlopCounterMode; the "
        f"dry-run's per-rank counts {[r['flops'] / 1e12 for r in ranks]} "
        f"TFLOP, sum {rank_sum / 1e12:.4f} (== card: "
        f"{rank_sum == tp_card['flops']}); per-rank peak "
        f"{[r['peak_gb'] for r in ranks]} GB; one rank's collectives "
        f"counted {ranks[0]['tp_collectives']}, on the card "
        f"{tp_card['tp_collectives']}")
    if rank_sum != tp_card["flops"]:
        raise AssertionError(f"the per-rank counts sum to {rank_sum} FLOPs, "
                             f"the card's tensor-parallel step "
                             f"{tp_card['flops']}")
    if ranks[0]["tp_collectives"] != tp_card["tp_collectives"]:
        raise AssertionError("the counted rank's collectives differ from "
                             "the card step's tally")
    out = dict(counted=counted, card=measured, train_work=work,
               causes=causes, cells=cell_recs, count_s=count_s,
               tp_card=tp_card, tp_ranks=ranks)
    if dev.type == "cuda":
        ratio = measured["peak"] / predicted
        held = mem["shard_bytes"] + mem["replica_bytes"]
        act = measured["peak"] - measured["held"]
        log(f"  peak above what the process held before the state: card "
            f"{measured['peak'] / 2**30:.2f} GiB, counted "
            f"{predicted / 2**30:.2f} GiB, card / counted {ratio:.4f}; "
            f"held on entry card {measured['held'] / 2**30:.2f} / counted "
            f"{held / 2**30:.2f} GiB ({measured['held'] / held:.4f}); the "
            f"step's own peak card {act / 2**30:.2f} / counted "
            f"{mem['activation_bytes'] / 2**30:.2f} GiB "
            f"({act / mem['activation_bytes']:.4f})")
        share = 1e3 * terms["total_bound_s"] / measured["event_ms"]
        log(f"  roofline bound {1e3 * terms['total_bound_s']:.3f} ms of the "
            f"measured step {measured['event_ms']:.1f} ms (events; wall "
            f"{1e3 * measured['wall_s']:.1f} ms): {share:.1%}")
        out.update(peak_ratio=ratio, bound_share=share)
        if abs(ratio - 1) > DRYRUN_PEAK_TOL:
            raise AssertionError(f"the card's peak is {ratio:.4f} of the "
                                 f"counted one (tolerance {DRYRUN_PEAK_TOL})")
    else:
        log("  peak and step time not measured (no card)")
    out["wall_s"] = time.perf_counter() - t0
    log(f"LM dry-run phase: {out['wall_s']:.1f} s on {card or 'no card'}")
    return out


def drive_examples(dev) -> dict:
    """``examples_torch/quickstart.py`` and ``gnn_inference.py`` at their
    defaults (on the card), their output logged."""
    out = {}
    for name in ("quickstart", "gnn_inference"):
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            example(name).main(["--device", str(dev)])
        out[name] = dict(wall_s=time.perf_counter() - t,
                         lines=buf.getvalue().splitlines())
        log(f"== examples_torch/{name}.py on {dev}: "
            f"{out[name]['wall_s']:.1f} s")
        for line in out[name]["lines"]:
            log(f"  {line}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # the launchers and examples run as subprocesses find the port too
    os.environ["PYTHONPATH"] = cli_env()["PYTHONPATH"]
    os.environ.pop("REPRO_CALIBRATION_PATH", None)   # measure, never replay
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import DynasparseEngine
    from repro_torch.data.graphs import load_graph
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import gemm, spdmm, spmm
    from repro_torch.models import gnn

    t_start = time.perf_counter()
    mods = {"gemm": gemm, "spdmm": spdmm, "spmm": spmm}
    card = card_line()
    dev = torch.device("cuda", 0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({_build.BUILD_INFO.get('path')}, cached="
        f"{_build.BUILD_INFO.get('cached')})")
    for line in _build.BUILD_INFO.get("ptxas", "").splitlines():
        if ("registers" in line or "Compiling entry" in line
                or "spill" in line):
            log(f"  ptxas: {line.strip()}")

    t0 = time.perf_counter()
    fl = load_graph("FL", device=dev)
    log(f"FL stand-in generated in {time.perf_counter() - t0:.2f} s")
    fl_eager = drive(torch, gnn, ops, DynasparseEngine, "main path", "GCN",
                     fl, 128, dev, mods)
    for k in ("gemm_batch_scatter", "spdmm_fused"):
        if fl_eager["launches"].get(k, 0) <= 0:
            raise AssertionError(f"main path launched no {k} kernel")

    co = load_graph("CO", device=dev)
    co_eager = drive(torch, gnn, ops, DynasparseEngine, "SpMM path", "GIN",
                     co, 16, dev, mods)
    if co_eager["launches"].get("spmm_fused", 0) <= 0:
        raise AssertionError("GIN on CO launched no spmm_fused kernel")

    fl_comp, cm = drive_compiled(torch, gnn, ops, "compiled GCN-FL", "GCN",
                                 fl, dev, mods, fl_eager)
    if fl_comp["per_call"] != {"gemm": 2, "spdmm_fused": 2}:
        raise AssertionError(f"compiled GCN-FL launches per call "
                             f"{fl_comp['per_call']}, expected gemm 2 and "
                             "spdmm_fused 2")
    del cm
    co_comp, cm = drive_compiled(torch, gnn, ops, "compiled GIN-CO", "GIN",
                                 co, dev, mods, co_eager)
    for k in ("spmm_fused", "spdmm_fused", "gemm"):
        if co_comp["per_call"].get(k, 0) <= 0:
            raise AssertionError(f"compiled GIN-CO launches no {k} per call")
    check_activation_route(torch, gnn, ops, DynasparseEngine,
                           "compiled GIN-CO", "GIN", co, dev, co_eager, cm)
    del cm
    co_task = drive_pertask(torch, gnn, ops, DynasparseEngine,
                            "per-task GIN-CO", "GIN", co, dev, mods,
                            co_eager)
    batch = drive_gemm_batch(torch, ops, dev, mods)
    sharded = drive_sharded(torch, gnn, ops, DynasparseEngine, fl, co, dev,
                            fl_eager, co_eager, mods)
    _, lm_moe = drive_lm(torch, ops, dev, mods, lm_configs(), card=card)
    require_launched("LM-MoE", lm_moe["launches"], ("spdmm",))
    trained = drive_train(torch, dev, train_configs(), card=card)
    from repro_torch.configs import ARCHS
    drive_distributed(torch, dev, ARCHS[DIST_ARCH], card=card,
                      single=next(r for r in trained["full"]
                                  if r["arch"] == DIST_ARCH))
    drive_tp_decode(torch, dev, card=card)
    drive_dryrun(torch, dev, ARCHS[DRYRUN_ARCH], card=card)
    drive_examples(dev)

    calib, fl_calib = drive_calibration(torch, gnn, ops, DynasparseEngine,
                                        fl, dev, fl_eager, mods)
    fl_serve = drive_serving(torch, gnn, ops, DynasparseEngine,
                             "GCN-FL serving", "GCN", fl, dev, fl_eager,
                             n_requests=16, max_batch=4, min_compiled=3,
                             mods=mods)
    require_launched("GCN-FL serving", fl_serve["launches"],
                     ("gemm_batch_scatter", "spdmm_fused", "gemm"))
    fl_held = drive_serving(torch, gnn, ops, DynasparseEngine,
                            "GCN-FL serving, cache holding FL", "GCN", fl,
                            dev, fl_eager, n_requests=16, max_batch=4,
                            min_compiled=3, max_bytes=FL_CACHE_BYTES)
    require_launched("GCN-FL serving, cache holding FL",
                     fl_held["launches"],
                     ("gemm_batch_scatter", "spdmm_fused", "gemm"))
    co_serve = drive_serving(torch, gnn, ops, DynasparseEngine,
                             "GIN-CO serving", "GIN", co, dev, co_eager,
                             n_requests=8, max_batch=4, min_compiled=1,
                             mods=mods)
    require_launched("GIN-CO serving", co_serve["launches"],
                     ("spmm_fused", "spdmm_fused", "gemm_batch_scatter"))
    co_mesh = drive_serving(torch, gnn, ops, DynasparseEngine,
                            "GIN-CO serving, mesh 1", "GIN", co, dev,
                            co_eager, n_requests=8, max_batch=4,
                            min_compiled=1, mods=mods, n_devices=1)
    require_launched("GIN-CO serving, mesh 1", co_mesh["launches"],
                     ("spmm_fused", "spdmm_fused"))
    chaos = drive_chaos(torch, ops, DynasparseEngine, co, dev, co_eager,
                        mods)
    with tempfile.TemporaryDirectory() as tmp:
        restart = drive_restart(tmp)
    if not all(r["kernel_launches_per_request"] > 0 for r in restart):
        raise AssertionError("gnn_serve --literal launched no kernel")

    summary = summarize(torch, mods,
                        [("GCN-FL", fl, fl_eager), ("GIN-CO", co, co_eager),
                         ("GCN-FL compiled", fl, fl_comp),
                         ("GIN-CO compiled", co, co_comp),
                         ("GIN-CO per-task", co, co_task),
                         ("gemm_batch", None, batch),
                         ("calibration", None, calib),
                         ("GCN-FL calibrated", fl, fl_calib),
                         ("GCN-FL serving", fl, fl_serve),
                         ("GCN-FL serving, cache holding FL", fl, fl_held),
                         ("GIN-CO serving", co, co_serve),
                         ("GIN-CO chaos", co, chaos)]
                        + [(label, fl if "FL" in label else
                            co if "CO" in label else None, rec)
                           for label, rec in sharded.items()]
                        + [("GIN-CO serving, mesh 1", co, co_mesh),
                           ("LM-MoE", None, lm_moe)])
    log(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "path", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  | {k: e[k] for k in EXTRA if k in e}
                                  for e in summary]}), flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
