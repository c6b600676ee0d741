"""Fault-tolerant training launcher: the port of ``repro/launch/train.py``.

``python -m repro_torch.launch.train --arch <id> [--steps N] [--ckpt-dir D]
[--ckpt-every K] [--mesh auto] [--reduced | --full] [--batch B] [--seq L]
[--lr LR] [--compress-grads] [--resume] [--device cpu]``

Wires together: config -> model bundle -> training state -> AdamW train
step (in place) -> ``TokenPipeline`` -> ``CheckpointManager`` (async,
atomic) -> ``FaultMonitor`` heartbeats.  Reduced configs by default
(``--reduced``), the published ones with ``--full``; on the card unless
``--device cpu``.  ``--mesh auto`` is the one device; the production
meshes (``single``, ``multi``) come with the distribution slice.  The
reference's ``TPU_XLA_FLAGS`` (collective-overlap flags of the TPU
compiler) have no counterpart here and are not carried over.

As in the reference, ``--compress-grads`` replaces the step by one that
takes the loss and gradients of the whole batch at once (no
microbatching), passes them through int8 error-feedback compression
(``optim/compression.py``) and then AdamW; its error-feedback state is
``state["ef"]`` and goes into the checkpoint.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path


def compressed_train_step(bundle, opt_cfg):
    """The reference's ``--compress-grads`` step: one loss and backward
    over the whole batch, int8 + error feedback, then AdamW."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.optim.compression import compress_decompress

    def train_step(state, batch):
        model = state["params"]
        loss = loss_and_grads(bundle, model, batch)
        params = dict(model.named_parameters())
        grads, state["ef"] = compress_decompress(
            {n: p.grad for n, p in params.items()}, state["ef"])
        metrics = adamw_update(grads, state["opt"], params, opt_cfg)
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

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ARCHS
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.device import resolve_device
    from repro_torch.distributed.fault import FaultMonitor
    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import ef_init

    if args.mesh != "auto":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the production meshes come with the "
            "distribution slice (ROADMAP queue 1, item 5c)")
    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduce_config(cfg)
    bundle = build_model(cfg)

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=max(args.steps, 2))
    step_fn = (compressed_train_step(bundle, opt_cfg) if args.compress_grads
               else make_train_step(bundle, opt_cfg))

    state = init_state(bundle, 0, dev)
    if args.compress_grads:
        state["ef"] = ef_init(dict(state["params"].named_parameters()))

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
    if len(losses) > 4:
        print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")
    return losses


if __name__ == "__main__":
    main()
