"""Multi-pod dry-run: count every (arch x shape x mesh) cell on the ``meta``
device, the counterpart of the reference's ``repro/launch/dryrun.py``.

The reference forces 512 host placeholder devices and lowers and compiles
each cell's step with XLA.  Here a mesh of ``meta`` coordinates stands in
for the devices (``Mesh.on("meta", (16, 16), ("data", "model"))``, or
``(2, 16, 16)`` over ``("pod", "data", "model")``: the shapes of
``make_production_mesh``), and the work of the busiest device runs
eagerly on meta tensors under :class:`~repro_torch.launch.roofline.
StepCounter`: no device is touched and no memory is taken.  The counts
are at H100 constants (``roofline.py``); none is a timing.

The busiest device's work is the port's own (``launch/steps.py``), one
rank's program: on a ``model`` axis of T > 1 the device is one model rank
of a tensor-parallel group (``distributed/tensor_parallel.py``), and its
step runs in the group's counted mode: only that rank's local ops run
(its share of every split product, the replicated work such as the kv
projections, the router, MLA's down-projections and SSD's B and C), an
all-reduce passes the rank's own partial through, and every collective is
tallied (``tp_collectives``, and into ``collectives``):

- *train*: the state stored by the sharding rules (``abstract_state(
  bundle, mesh)``); the microbatches that ``MeshCompute`` runs on the
  data-parallel rank that runs most of them (where the residual anchor
  keeps dp, every rank runs its share of every microbatch's rows, and an
  MoE layer gathers every rank's rows to route the whole microbatch;
  else each microbatch whole on the first rank that holds its rows), on
  the device's replica (its local blocks gathered over the data axes;
  remat as configured; with ``seq_shard`` the residual stream cut over
  the sequence), then the AdamW update of that device's shards from its
  gradient blocks (another rank's part of a stored block stands in as
  zeros);
- *prefill*: the prefill step on the rows of one data-parallel rank (the
  whole batch where the dp axes do not divide it; an MoE layer's inputs
  gathered from every rank to route the whole batch), on the device's
  replica of the parameters placed by ``params_shardings``
  (tensor-parallel on a ``model`` axis), with the serving compute
  copies;
- *decode*: the serve step (``MeshCompute.decode`` in counted mode) on
  the rows of data-parallel rank 0 against the cache placed by
  ``cache_shardings``, on the device's replica as for a prefill: the
  rank reads and writes its own cache blocks (k and v over its slice of
  the length, combined across the group by the split-KV softmax's
  all-reduces), gathers only what crosses its blocks (SSD's conv
  window, the leaves of a layer that runs whole) and, where the batch is
  split over the data axes, the MoE layers' inputs of every rank's rows.

Microbatches of one step have one shape, so a device that runs more than
three counts three (the first creates the gradients, the second is the
steady one) and adds the second once for each further one, as
``hlo_cost`` multiplies a while body by its trip count.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR] \
        [--jobs N]

Each cell writes ``<out>/<arch>__<shape>__<mesh>.json`` with the memory,
the cost, the collective bytes and the roofline terms of its busiest
device.  ``--all`` drives one subprocess per cell (a pathological cell
cannot kill the sweep), ``--jobs`` of them at a time; completed cells are
skipped, so the sweep is resumable.  ``busiest`` names the device's
coordinate, its microbatches and rows, the devices that compute
(``compute_devices``), the model group's size (``model_group``) and the
layers that run whole on it (``whole_layers``, the layer rule of
``tensor_parallel.py``).

``memory``: ``shard_bytes`` (the blocks the device holds by the rules),
``replica_bytes`` (what its step holds on entry beyond them: the gathered
replica, serving's compute copies, the batch), ``activation_bytes`` (the step's peak above what it holds on
entry) and ``peak_per_device_gb``, their sum.  ``compile_s`` is the
count's own wall time (there is no compile).  The reference's
``lower_s``, ``xla_flops_once``, ``xla_bytes_once`` and ``hlo_path``
have no counterpart (there is no XLA and no HLO).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

DEFAULT_OUT = Path("results/dryrun_torch")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def meta_mesh(kind: str):
    """The production mesh ``kind`` ("single" / "multi") of meta
    coordinates."""
    from repro_torch.launch.mesh import Mesh
    shape, names = MESHES[kind]
    return Mesh.on("meta", shape, names)


def apply_opts(cfg, opts):
    """The config of the hillclimb variants in ``opts`` that change it."""
    if "seq_shard" in opts:
        cfg = dataclasses.replace(cfg, seq_shard=True)
    if "flash_skip" in opts:
        cfg = dataclasses.replace(cfg, flash_causal_skip=True)
    if "moe_shard" in opts:
        cfg = dataclasses.replace(cfg, moe_dispatch_shard=True)
    if "mb2" in opts:
        cfg = dataclasses.replace(cfg, microbatches=cfg.microbatches * 2)
    if "flash_vjp" in opts:
        cfg = dataclasses.replace(cfg, flash_vjp=True)
    return cfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _at(leaf, coord):
    """``leaf`` cut to the one block ``coord`` holds."""
    key = leaf.where[tuple(coord)]
    return dataclasses.replace(leaf, tensors={key: leaf.tensors[key]},
                               where={tuple(coord): key})


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _train(bundle, shape, mesh, specs, model_rank=0, dp_rank=None):
    """The train step counted on model rank ``model_rank`` of the busiest
    data-parallel rank's group, or of ``dp_rank``'s."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.steps import (MeshCompute, abstract_state,
                                          loss_and_grads, stored_grads)
    from repro_torch.optim.adamw import AdamWConfig, sharded_adamw_update

    state = abstract_state(bundle, mesh)
    compute = MeshCompute(bundle, mesh)
    mb = max(1, bundle.cfg.microbatches)
    owners = compute.owner_ranks(specs, mb)
    by_rank = collections.Counter(r for ranks in owners for r in ranks)
    rank, runs = by_rank.most_common(1)[0]
    if dp_rank is not None:
        rank, runs = dp_rank, by_rank[dp_rank]
    n_ranks = len(owners[0])
    _, seq = compute.layout(specs, shape.global_batch // mb)
    coord = compute.coord(rank, model_rank)
    dev = mesh.device(coord)
    T = compute.n_model
    # the counted rank's program: its local replica, its share of every
    # split product and of every microbatch's rows, its collectives
    # tallied
    plan = compute.plan(model_rank)
    model = compute.bind_rank(dev, state["params"], model_rank)
    group = tp.ModelGroup(compute.group_devices(rank), members=(model_rank,),
                          seq=seq)
    k = min(runs, 3)
    rows = shape.global_batch // mb // n_ranks
    at = owners[0].index(rank) if n_ranks > 1 else 0
    # the device's rows are held whole; the first k microbatches run
    batch = {n: _meta((runs * rows, *t.shape[1:]), t.dtype)
             for n, t in specs.items()}
    opt = state["opt"]
    local = {n: _at(leaf, coord) for n, leaf in state["params"].items()}
    local_opt = {"mu": {n: _at(v, coord) for n, v in opt["mu"].items()},
                 "nu": {n: _at(v, coord) for n, v in opt["nu"].items()},
                 "step": opt["step"]}
    shards = [leaf.local(coord) for tree in (state["params"], opt["mu"],
                                             opt["nu"])
              for leaf in tree.values()] + [opt["step"]]
    marks = []

    def loss(m, b):
        marks.append((counter.totals(), group.tally.copy()))
        run = tp.Run(rank, group, {model_rank: m}, tp.feeds_on(group, b),
                     slice(at * rows, (at + 1) * rows))
        return tp.step_loss(bundle, [run], n_ranks)

    counted = dataclasses.replace(bundle, loss=loss)
    with rl.StepCounter(shards + rl.held_tensors(model, batch)) as counter:
        loss_and_grads(counted, model,
                       {n: t[:k * rows] for n, t in batch.items()}, k)
        grads = tp.piece_grads(
            [({n: p.grad for n, p in model.named_parameters()},
              plan.splits)], {n: l.shape for n, l in local.items()})
        sharded_adamw_update(*stored_grads(grads, local), local_opt, local,
                             AdamWConfig())
    out = counter.result()
    if runs > k:
        # the second microbatch's section is the steady one
        for i, key in enumerate(("flops", "bytes")):
            out[key] += (runs - k) * (marks[2][0][i] - marks[1][0][i])
        group.tally.add_between(marks[1][1], marks[2][1], runs - k)
    busiest = dict(coord=list(coord), microbatches=runs, rows=rows,
                   compute_devices=len(by_rank) * T, model_group=T,
                   whole_layers=plan.whole)
    return (out, counter.top_bytes(5),
            rl.step_collectives(mesh, state, plan.splits, coord, group.tally),
            _nbytes(shards), busiest, group.tally)


def _serve(bundle, shape, mesh, specs, opts, model_rank=0):
    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.steps import MeshCompute

    model = bundle.abstract_params()
    if "bf16_params" in opts:
        model.to(torch.bfloat16)
    pspecs = sharding.params_shardings(model, mesh,
                                       fsdp="infer_tp" not in opts)
    params = {n: sharding.shard(p, pspecs[n], mesh)
              for n, p in model.named_parameters()}
    compute = MeshCompute(bundle, mesh)
    # the counted rank's program on data-parallel rank 0's group: its
    # local replica (its compute blocks, with serving's compute copies)
    coord = compute.coord(0, model_rank)
    plan = compute.plan(model_rank)
    replica = compute.serving_replica(mesh.device(coord), params,
                                      model_rank)
    name, leaf = next(iter(specs.items()))
    shards = [leaf.local(coord) for leaf in params.values()]
    if shape.kind == "prefill":
        # the rows of one data-parallel rank where the residual anchor
        # keeps dp, all of them on rank 0 where it does not
        n_ranks, seq = compute.layout(specs, leaf.shape[0])
        split = n_ranks > 1
        rows = leaf.shape[0] // n_ranks
        group = tp.ModelGroup(compute.group_devices(0),
                              members=(model_rank,), seq=seq)
        batch = {n: _meta((rows, *t.shape[1:]), t.dtype)
                 for n, t in specs.items()}
        run = tp.Run(0, group, {model_rank: replica},
                     tp.feeds_on(group, batch), slice(0, rows))

        def step():
            tp.step_prefill(bundle, [run], n_ranks)
    else:
        # the rows of one data-parallel rank (``batch_spec``); the whole
        # batch goes in, and the counted rank runs rank 0's rows against
        # its own blocks of the placed cache
        split = sharding.batch_spec(name, tuple(leaf.shape),
                                    mesh)[0] is not None
        rows = leaf.shape[0] // (compute.n_dp if split else 1)
        batch = dict(specs)
        cache = sharding.shard_cache(
            bundle.abstract_cache(shape.global_batch, shape.seq_len), mesh)
        shards += [leaf.local(coord)
                   for leaf in sharding.tree_leaves(cache).values()]

        def step():
            compute.decode(params, cache, batch, model_rank)
    with rl.StepCounter(shards + rl.held_tensors(replica, batch)) as counter:
        step()
    tally = group.tally if shape.kind == "prefill" else compute.tallies[0]
    T = compute.n_model
    busiest = dict(coord=list(coord), rows=rows,
                   compute_devices=(compute.n_dp if split else 1) * T,
                   model_group=T, whole_layers=plan.whole)
    return (counter.result(), counter.top_bytes(5),
            rl.step_collectives(mesh, {"params": params}, plan.splits, coord,
                                tally),
            _nbytes(shards), busiest, tally)


def count_cell(cfg, shape, mesh, opts=(), model_rank=0) -> dict:
    """Count the busiest device's step of ``cfg`` at ``shape`` (a
    ``ShapeConfig``) on ``mesh`` (of meta coordinates): the result keys
    of :func:`run_cell` from ``n_chips`` on.  On a ``model`` axis the
    device is model rank ``model_rank`` of the busiest data-parallel
    rank's group (a prefill's and a decode step's: of rank 0's)."""
    from repro_torch.launch import roofline as rl
    from repro_torch.models.registry import build_model, input_specs

    t0 = time.time()
    bundle = build_model(cfg)
    specs = input_specs(cfg, shape)
    train = shape.kind == "train"
    with torch.set_grad_enabled(train):
        cost, top, coll, shard_bytes, busiest, tally = (
            _train(bundle, shape, mesh, specs, model_rank) if train
            else _serve(bundle, shape, mesh, specs, opts, model_rank))
    count_s = time.time() - t0
    n_chips = mesh.size
    flops, nbytes = cost["flops"], cost["bytes"]
    terms = rl.roofline_terms(flops, nbytes, sum(coll.values()), n_chips)
    mf = rl.model_flops(cfg, shape)
    peak = cost["peak_bytes"]
    return dict(
        n_chips=n_chips,
        compile_s=round(count_s, 1),
        memory={"shard_bytes": shard_bytes,
                "replica_bytes": cost["held_bytes"] - shard_bytes,
                "activation_bytes": peak - cost["held_bytes"],
                "peak_per_device_gb": round(peak / 1e9, 3)},
        cost={"flops": flops, "bytes_accessed": nbytes},
        collectives=coll,
        tp_collectives=tally.as_dict() if tally is not None else {},
        roofline=terms,
        model_flops=mf,
        useful_flops_ratio=(round(mf / (flops * n_chips), 4)
                            if flops else None),
        params_b=round(cfg.param_count() / 1e9, 3),
        params_active_b=round(cfg.param_count(active_only=True) / 1e9, 3),
        busiest=busiest,
        top_bytes=top,
    )


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
             save_hlo: bool = False, opts: tuple[str, ...] = ()) -> dict:
    """``opts`` enables the hillclimb variants (baseline = no opts):
    seq_shard, flash_skip, moe_shard, mb2, flash_vjp (the config's
    switches), infer_tp (TP-only inference parameters) and bf16_params
    (bfloat16 serving parameters).  ``save_hlo`` and ``out_dir`` are
    kept for the reference's signature: there is no HLO to save."""
    del out_dir, save_hlo
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.models.registry import cell_is_runnable

    cfg = apply_opts(ARCHS[arch], opts)
    shape = SHAPES[shape_name]
    runnable, reason = cell_is_runnable(cfg, shape_name)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "opts": list(opts), "timestamp": time.time()}
    if not runnable:
        result.update(status="skipped-by-design", reason=reason)
        return result
    result.update(status="ok", **count_cell(cfg, shape, meta_mesh(mesh_kind),
                                            opts))
    gc.collect()
    return result


def all_cells():
    from repro_torch.configs import ARCHS, SHAPES
    for arch in ARCHS:
        for shape in SHAPES:
            for mesh in MESHES:
                yield arch, shape, mesh


# the longest counts first (a meta op costs the same at any size, so a
# cell's count takes about as long as it has ops: 32k prefills, then
# trains, by depth), so that the short ones fill the end of a pooled sweep
_SHAPE_ORDER = ("prefill_32k", "train_4k", "decode_32k", "long_500k")


def _longest_first(cell) -> tuple:
    from repro_torch.configs import ARCHS
    arch, shape, _ = cell
    order = (_SHAPE_ORDER.index(shape) if shape in _SHAPE_ORDER
             else len(_SHAPE_ORDER))
    return order, -ARCHS[arch].n_layers


def _run_pool(out_dir: Path, timeout: int, jobs: int = 1) -> None:
    """``--all``: every cell not yet written, one subprocess each, ``jobs``
    at a time, the longest first; a cell whose subprocess fails or runs
    longer than ``timeout`` seconds is written as ``failed``."""
    cells = list(all_cells())

    def path(cell):
        return out_dir / f"{'__'.join(cell)}.json"

    todo = sorted((c for c in cells if not path(c).exists()),
                  key=_longest_first)
    running: dict = {}
    failed = 0
    while todo or running:
        while todo and len(running) < jobs:
            cell = todo.pop(0)
            print(f"[dryrun] {' x '.join(cell)} ...", flush=True)
            running[cell] = (subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 cell[0], "--shape", cell[1], "--mesh", cell[2], "--out",
                 str(out_dir)]), time.time())
        time.sleep(0.5)
        for cell, (proc, t0) in list(running.items()):
            rc = proc.poll()
            if rc is None and time.time() - t0 > timeout:
                proc.kill()
                proc.wait()
                rc = -9
            if rc is None:
                continue
            del running[cell]
            if rc != 0 and not path(cell).exists():
                path(cell).write_text(json.dumps(
                    dict(zip(("arch", "shape", "mesh"), cell),
                         status="failed", returncode=rc), indent=1))
                failed += 1
    print(f"[dryrun] complete: {len(cells) - failed} ok/skipped, {failed} "
          f"failed of {len(cells)}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=tuple(MESHES), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--save-hlo", action="store_true",
                    help="accepted for the reference's command line; "
                         "writes nothing (the port has no HLO)")
    ap.add_argument("--opt", default="",
                    help="comma list of hillclimb variants: seq_shard,"
                         "flash_skip,moe_shard,mb2,flash_vjp,infer_tp,"
                         "bf16_params")
    ap.add_argument("--timeout", type=int, default=3000,
                    help="per-cell timeout (s) in --all mode")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at a time in --all mode (the "
                         "longest first)")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.save_hlo:
        print("[dryrun] --save-hlo: nothing written (the port runs its "
              "steps eagerly on the meta device; there is no HLO)")
    if args.all:
        _run_pool(out_dir, args.timeout, args.jobs)
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required (or --all)")
    opts = tuple(o for o in args.opt.split(",") if o)
    try:
        result = run_cell(args.arch, args.shape, args.mesh, out_dir,
                          opts=opts)
    except Exception as e:  # recorded, not raised: the sweep must continue
        result = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
                  "opts": list(opts),
                  "status": "error", "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    suffix = ("__" + "_".join(opts)) if opts else ""
    path = out_dir / f"{args.arch}__{args.shape}__{args.mesh}{suffix}.json"
    path.write_text(json.dumps(result, indent=1))
    status = result.get("status")
    print(f"[dryrun] {args.arch} x {args.shape} x {args.mesh}: {status}")
    if status == "ok":
        r = result["roofline"]
        print(f"  count {result['compile_s']}s | peak/dev "
              f"{result['memory']['peak_per_device_gb']} GB | "
              f"compute {r['compute_s']:.3e}s memory {r['memory_s']:.3e}s "
              f"collective {r['collective_s']:.3e}s -> {r['dominant']} "
              "(counts at H100 constants)")
    elif status == "error":
        print(result["error"])
        sys.exit(1)


if __name__ == "__main__":
    main()
