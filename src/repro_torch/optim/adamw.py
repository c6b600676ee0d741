"""AdamW with a cosine schedule and global-norm clipping: the reference's
``repro/optim/adamw.py`` on one device, updating in place.

The parameter "tree" is a dict of name -> tensor (a model's
``named_parameters()``); gradients are a dict of the same names, where
None stands for a zero gradient (the reference's tree has a gradient for
every leaf, so weight decay and the moments' decay still apply).  The
update runs under ``torch.no_grad()`` and writes the parameters, the
moments and the step in place: the counterpart of the reference's donated
state.  The step counter, the schedule, the norm and the clip scale stay
on the device, so a step reads nothing back to the host.
:func:`sharded_adamw_update` is the same step on a state stored by the
sharding rules (parameters and both moments by ``param_spec``, the
reference's ZeRO-3 layout), updating each shard in place.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def adamw_init(params: dict, moment_dtype=torch.float32) -> dict:
    """Zero moments in ``moment_dtype`` beside each parameter, and an int32
    step counter on the parameters' device."""
    dev = next(iter(params.values())).device
    zeros = {n: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
             for n, p in params.items()}
    return {"mu": zeros,
            "nu": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to 0 at ``total_steps``, in
    float32 from the device step."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def _step_scalars(cfg: AdamWConfig, opt_state: dict, sq_sums):
    """The reference's step + 1, learning rate, global norm (the square
    root of the sum of ``sq_sums``, each on the step's device, in order),
    clip scale and bias corrections."""
    step = opt_state["step"] + 1
    lr = _schedule(cfg, step)
    gnorm = torch.sqrt(sum(s.to(step.device) for s in sq_sums))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    return step, dict(lr=lr, scale=scale, b1c=b1c, b2c=b2c), gnorm


def _apply(cfg: AdamWConfig, p, g, mu, nu, k: dict) -> None:
    """One parameter's moments and decoupled decay, in place; the step's
    scalars ``k`` are moved to ``p``'s device (a no-op on its own)."""
    k = {n: v.to(p.device) for n, v in k.items()}
    g = g * k["scale"]
    mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g
    nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * g * g
    step_v = (mu32 / k["b1c"]) / (torch.sqrt(nu32 / k["b2c"]) + cfg.eps)
    p.copy_(p - k["lr"] * (step_v + cfg.weight_decay * p))
    mu.copy_(mu32)
    nu.copy_(nu32)


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params: dict,
                 cfg: AdamWConfig) -> dict:
    """One AdamW step, in place; returns the metrics ``{"grad_norm",
    "lr"}`` (0-d device tensors).  The reference's order: step + 1, the
    learning rate, the global norm of all gradients, the clip scale, the
    bias corrections, then per parameter the moments and the decoupled
    decay ``p - lr (step_v + wd p)``."""
    g32 = {n: (grads[n].float() if grads.get(n) is not None
               else torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device))
           for n, p in params.items()}
    step, k, gnorm = _step_scalars(
        cfg, opt_state, (torch.sum(torch.square(g)) for g in g32.values()))
    for n, p in params.items():
        _apply(cfg, p, g32.pop(n), opt_state["mu"][n], opt_state["nu"][n], k)
    opt_state["step"].copy_(step)
    return {"grad_norm": gnorm, "lr": k["lr"]}


@torch.no_grad()
def sharded_adamw_update(grads: dict, sq_sums, opt_state: dict,
                         params: dict, cfg: AdamWConfig) -> dict:
    """:func:`adamw_update` on a state placed by the sharding rules:
    ``params``, ``opt_state["mu"]`` and ``["nu"]`` map each name to a
    :class:`~repro_torch.distributed.sharding.Sharded` leaf, ``grads`` to
    ``{block index: the gradient of that stored block}`` (each block once,
    however many devices hold it) or None for a zero gradient.  The
    global norm is the square root of the sum of ``sq_sums``, the sums of
    squares of the whole gradient's distinct parts in a fixed order
    (``launch.steps.stored_grads``); then each copy of each stored block
    is updated on its own device from its block's gradient.  Where each
    part is a whole leaf's gradient, summed in ``params``' order, this is
    :func:`adamw_update`'s arithmetic, bitwise, however the leaves are
    cut."""
    step, k, gnorm = _step_scalars(cfg, opt_state, sq_sums)
    for n, leaf in params.items():
        g = grads.get(n)
        mu, nu = opt_state["mu"][n].tensors, opt_state["nu"][n].tensors
        for key, p in leaf.tensors.items():
            part = (g[key[0]].float() if g is not None
                    else torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device))
            _apply(cfg, p, part.to(p.device), mu[key], nu[key], k)
    opt_state["step"].copy_(step)
    return {"grad_norm": gnorm, "lr": k["lr"]}
