"""Fault-tolerant training launcher: the port of ``repro/launch/train.py``.

``python -m repro_torch.launch.train --arch <id> [--steps N] [--ckpt-dir D]
[--ckpt-every K] [--mesh auto] [--reduced | --full] [--batch B] [--seq L]
[--lr LR] [--compress-grads] [--resume] [--device cpu]``

Wires together: config -> model bundle -> mesh -> training state placed
by the sharding rules -> AdamW train step (in place) -> ``TokenPipeline``
-> ``CheckpointManager`` (async, atomic) -> ``FaultMonitor`` heartbeats.
Reduced configs by default (``--reduced``), the published ones with
``--full``; on the card unless ``--device cpu``.  ``--mesh auto`` is the
reference's ``make_mesh_for_devices(n, model_parallel=1 if n < 4 else
2)`` over the ``n`` visible devices (one card, or the CPU: the ``(1, 1)``
mesh, whose steps equal the single-device step's bitwise); ``single`` and
``multi`` are ``make_production_mesh``'s 256- and 512-device meshes, which
raise its ``ValueError`` where fewer devices are visible.  The
reference's ``TPU_XLA_FLAGS`` (collective-overlap flags of the TPU
compiler) have no counterpart here and are not carried over.

As in the reference, ``--compress-grads`` replaces the step by one that
takes the loss and gradients of the whole batch at once (no
microbatching), passes the reduced gradients through int8 error-feedback
compression (``optim/compression.py``) and then AdamW; its error-feedback
state is ``state["ef"]`` and goes into the checkpoint.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path


def compressed_train_step(bundle, opt_cfg, mesh):
    """The reference's ``--compress-grads`` step on a state of
    ``init_state(..., mesh=mesh)``: one loss and backward over the whole
    batch, int8 + error feedback on the reduced gradients (each leaf's
    whole gradient, also where a model group computed it in blocks), then
    AdamW."""
    from repro_torch.distributed.tensor_parallel import Grad
    from repro_torch.launch.steps import MeshCompute, stored_grads
    from repro_torch.optim.adamw import sharded_adamw_update
    from repro_torch.optim.compression import compress_decompress

    compute = MeshCompute(bundle, mesh)

    def train_step(state, batch):
        loss, grads = compute.loss_and_grads(state["params"], batch)
        grads = {n: g.whole().to(state["ef"][n].device)
                 for n, g in grads.items()}
        grads, state["ef"] = compress_decompress(grads, state["ef"])
        grads, sq_sums = stored_grads(
            {n: Grad(tuple(g.shape), 0, [(0, g.shape[0], g)])
             for n, g in grads.items()}, state["params"])
        metrics = sharded_adamw_update(grads, sq_sums, state["opt"],
                                       state["params"], opt_cfg)
        return state, dict(metrics, loss=loss)
    return train_step


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir())
                                / "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--mesh", default="auto",
                    choices=("auto", "single", "multi"))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import (make_mesh_for_devices,
                                         make_production_mesh,
                                         visible_devices)
    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import ef_init

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduce_config(cfg)
    bundle = build_model(cfg)

    if args.mesh == "auto":
        n = visible_devices(dev.type)
        mesh = make_mesh_for_devices(n, model_parallel=1 if n < 4 else 2,
                                     device=dev)
    else:
        mesh = make_production_mesh(multi_pod=(args.mesh == "multi"),
                                    device=dev)

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=max(args.steps, 2))
    step_fn = (compressed_train_step(bundle, opt_cfg, mesh)
               if args.compress_grads
               else make_train_step(bundle, opt_cfg, mesh))

    with mesh:
        state = init_state(bundle, 0, dev, mesh=mesh)
        if args.compress_grads:
            state["ef"] = ef_init(state["params"])
        losses = _train(args, cfg, state, step_fn, dev)
    if len(losses) > 4:
        print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")
    return losses


def _train(args, cfg, state, step_fn, dev) -> list[float]:
    """The resume, step and checkpoint loop; returns the losses."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.distributed.fault import FaultMonitor

    ckpt = CheckpointManager(args.ckpt_dir, cfg=cfg)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        start, state = ckpt.restore(state)
        print(f"[train] resumed from step {start}")

    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch,
                         seq_len=args.seq, start_step=start)
    monitor = FaultMonitor(["host0"])
    losses = []
    try:
        for step in range(start, args.steps):
            t0 = time.time()
            batch = {k: torch.as_tensor(v, device=dev).long()
                     for k, v in next(pipe).items()}
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            monitor.heartbeat("host0", step_time=dt)
            losses.append(loss)
            print(f"[train] step {step:4d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{dt * 1e3:.0f}ms")
            if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
                ckpt.save(step + 1, state)
        ckpt.wait()
    finally:
        pipe.close()
    return losses


if __name__ == "__main__":
    main()
