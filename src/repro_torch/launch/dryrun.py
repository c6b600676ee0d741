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

The busiest device's work is the port's own (``launch/steps.py``):

- *train*: the state stored by the sharding rules (``abstract_state(
  bundle, mesh)``); the microbatches that ``MeshCompute`` runs on the
  device that runs most of them (each microbatch whole on the first
  data-parallel rank that holds its rows), on its replica (whole
  products, remat as configured), then the AdamW update of that
  device's shards (the norm over the whole gradients, as
  ``sharded_adamw_update`` takes it);
- *prefill*: the prefill step on the rows of one data-parallel rank,
  the parameters placed by ``params_shardings`` and gathered into its
  replica with the serving compute copies;
- *decode*: the serve step on those rows against their cache, placed by
  ``cache_shardings`` and gathered to its whole length.

Microbatches of one step have one shape, so a device that runs more than
three counts three (the first creates the gradients, the second is the
steady one) and adds the second once for each further one, as
``hlo_cost`` multiplies a while body by its trip count.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR]

Each cell writes ``<out>/<arch>__<shape>__<mesh>.json`` with the memory,
the cost, the collective bytes and the roofline terms of its busiest
device.  ``--all`` drives one subprocess per cell (a pathological cell
cannot kill the sweep); completed cells are skipped, so the sweep is
resumable.

``memory``: ``shard_bytes`` (the blocks the device holds by the rules),
``replica_bytes`` (what its step holds on entry beyond them: the gathered
replica, serving's compute copies, the batch, a decode step's gathered
cache), ``activation_bytes`` (the step's peak above what it holds on
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


def _train(bundle, shape, mesh, specs):
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.steps import (MeshCompute, abstract_state,
                                          loss_and_grads)
    from repro_torch.optim.adamw import AdamWConfig, sharded_adamw_update

    state = abstract_state(bundle, mesh)
    compute = MeshCompute(bundle, mesh)
    mb = max(1, bundle.cfg.microbatches)
    owners = compute.owner_ranks(specs, mb)
    rank, runs = collections.Counter(owners).most_common(1)[0]
    coord = compute.rank_coord[rank]
    model = compute.bind(mesh.device(coord), state["params"])
    k = min(runs, 3)
    rows = shape.global_batch // mb
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
        marks.append(counter.totals())
        return bundle.loss(m, b)

    counted = dataclasses.replace(bundle, loss=loss)
    with rl.StepCounter(shards + rl.held_tensors(model, batch)) as counter:
        loss_and_grads(counted, model,
                       {n: t[:k * rows] for n, t in batch.items()}, k)
        grads = {n: p.grad for n, p in model.named_parameters()}
        sharded_adamw_update(grads, local_opt, local, AdamWConfig())
    out = counter.result()
    if runs > k:
        # the second microbatch's section is the steady one
        for i, key in enumerate(("flops", "bytes")):
            out[key] += (runs - k) * (marks[2][i] - marks[1][i])
    busiest = dict(coord=list(coord), microbatches=runs, rows=rows,
                   compute_devices=len(set(owners)))
    return (out, counter.top_bytes(5), rl.step_collectives(mesh, state),
            _nbytes(shards), busiest)


def _tree_cache(tree, specs, mesh, coord, placed, prefix=""):
    """The device's decode cache: each leaf of the full-batch cache placed
    by its spec into ``placed`` (path -> Sharded), and in the returned
    tree the block ``coord`` holds where that block is its rows' whole
    leaf, else a gathered (meta) leaf of that shape."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import roofline as rl
    if isinstance(tree, torch.Tensor):
        path = prefix[:-1]
        leaf = placed[path] = sharding.shard(tree, specs[path], mesh)
        block = leaf.local(coord)
        rows = rl.rows_shape(leaf)
        return (block if tuple(block.shape) == rows
                else _meta(rows, leaf.dtype))
    if isinstance(tree, dict):
        return {k: _tree_cache(v, specs, mesh, coord, placed,
                               f"{prefix}{k}.") for k, v in tree.items()}
    return [_tree_cache(v, specs, mesh, coord, placed, f"{prefix}{i}.")
            for i, v in enumerate(tree)]


def _serve(bundle, shape, mesh, specs, opts):
    from repro_torch.distributed import sharding
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.steps import (MeshCompute, make_prefill_step,
                                          make_serve_step)
    from repro_torch.models.layers import make_compute_copies

    cfg = bundle.cfg
    model = bundle.abstract_params()
    if "bf16_params" in opts:
        model.to(torch.bfloat16)
    pspecs = sharding.params_shardings(model, mesh,
                                       fsdp="infer_tp" not in opts)
    params = {n: sharding.shard(p, pspecs[n], mesh)
              for n, p in model.named_parameters()}
    compute = MeshCompute(bundle, mesh)
    coord = compute.rank_coord[0]
    replica = compute.bind(mesh.device(coord), params)
    make_compute_copies(replica, getattr(torch, cfg.dtype))
    # the rows of one data-parallel rank (``batch_spec``), all of them
    # on rank 0 where the dp axes do not divide the batch
    name, leaf = next(iter(specs.items()))
    split = sharding.batch_spec(name, tuple(leaf.shape), mesh)[0] is not None
    rows = leaf.shape[0] // (compute.n_dp if split else 1)
    batch = {n: _meta((rows, *t.shape[1:]) if t.ndim else (), t.dtype)
             for n, t in specs.items()}
    placed = {"params": params}
    shards = [leaf.local(coord) for leaf in params.values()]
    if shape.kind == "prefill":
        step, args = make_prefill_step(bundle), (replica, batch)
    else:
        full = bundle.abstract_cache(shape.global_batch, shape.seq_len)
        placed["cache"] = {}
        cache = _tree_cache(full, sharding.cache_shardings(full, mesh), mesh,
                            coord, placed["cache"])
        shards += [leaf.local(coord) for leaf in placed["cache"].values()]
        step, args = make_serve_step(bundle), (replica, cache, batch)
    with rl.StepCounter(shards + rl.held_tensors(*args)) as counter:
        step(*args)
    busiest = dict(coord=list(coord), rows=rows,
                   compute_devices=compute.n_dp if split else 1)
    return (counter.result(), counter.top_bytes(5),
            rl.step_collectives(mesh, placed), _nbytes(shards),
            busiest)


def count_cell(cfg, shape, mesh, opts=()) -> dict:
    """Count the busiest device's step of ``cfg`` at ``shape`` (a
    ``ShapeConfig``) on ``mesh`` (of meta coordinates): the result keys
    of :func:`run_cell` from ``n_chips`` on."""
    from repro_torch.launch import roofline as rl
    from repro_torch.models.registry import build_model, input_specs

    t0 = time.time()
    bundle = build_model(cfg)
    specs = input_specs(cfg, shape)
    train = shape.kind == "train"
    with torch.set_grad_enabled(train):
        cost, top, coll, shard_bytes, busiest = (
            _train(bundle, shape, mesh, specs) if train
            else _serve(bundle, shape, mesh, specs, opts))
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
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.save_hlo:
        print("[dryrun] --save-hlo: nothing written (the port runs its "
              "steps eagerly on the meta device; there is no HLO)")

    if args.all:
        cells = list(all_cells())
        done = failed = 0
        for arch, shape, mesh in cells:
            path = out_dir / f"{arch}__{shape}__{mesh}.json"
            if path.exists():
                done += 1
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--out", str(out_dir)]
            print(f"[dryrun] {arch} x {shape} x {mesh} ...", flush=True)
            try:
                rc = subprocess.run(cmd, timeout=args.timeout).returncode
            except subprocess.TimeoutExpired:
                rc = -9
            if rc != 0 and not path.exists():
                path.write_text(json.dumps(
                    {"arch": arch, "shape": shape, "mesh": mesh,
                     "status": "failed", "returncode": rc}, indent=1))
                failed += 1
            else:
                done += 1
        print(f"[dryrun] complete: {done} ok/skipped, {failed} failed "
              f"of {len(cells)}")
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
