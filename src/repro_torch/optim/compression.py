"""Int8 error-feedback gradient compression: the reference's
``repro/optim/compression.py``.

Each gradient leaf is quantized to int8 against a per-leaf scale and
dequantized, and the quantization residual is kept as error-feedback
state (Seide et al. / EF-SGD) and added to the next step's gradient,
which restores convergence to the uncompressed trajectory.  Leaves are
dicts of name -> tensor; a None gradient is a zero one.  ``torch.round``
rounds half to even, as ``jnp.round`` does, so a leaf's result equals
the reference's bitwise.

:func:`psum8` is the reference's explicit int8 all-reduce (inside
``shard_map`` there) with one controller: it takes the per-rank tensors
of one mesh axis and gives every rank the dequantized sum on its own
device.
"""
from __future__ import annotations

import torch


def _quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.amax(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_decompress(grads: dict, ef: dict) -> tuple[dict, dict]:
    """Quantize and dequantize each leaf with error feedback.  Returns
    (the dequantized gradients to feed the optimizer, in each gradient's
    dtype; the new error-feedback state, in ``ef``'s dtypes)."""
    new_g, new_ef = {}, {}
    for n, e in ef.items():
        g = grads.get(n)
        g32 = (g.float() if g is not None else torch.zeros_like(
            e, dtype=torch.float32)) + e
        q, scale = _quant(g32)
        deq = q.float() * scale
        new_g[n] = deq.to(g.dtype if g is not None else torch.float32)
        new_ef[n] = (g32 - deq).to(e.dtype)
    return new_g, new_ef


def ef_init(params: dict) -> dict:
    """Zero float32 error-feedback state beside each leaf."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


@torch.no_grad()
def psum8(xs) -> list[torch.Tensor]:
    """Int8 all-reduce of the per-rank float32 tensors ``xs`` (one per
    rank of a mesh axis, each on its rank's device).  All ranks quantize
    against one shared scale, ``max_r max|x_r| / 127 + 1e-12`` (else the
    integer sum would mix units); each rank's payload is its int8
    quantization (round half to even, clipped to +-127), summed in int32
    in rank order on the first rank's device (exact up to 2^23 ranks);
    each rank gets ``sum * scale`` on its own device."""
    xs = list(xs)
    home = xs[0].device
    smax = torch.stack([torch.amax(torch.abs(x)).to(home) for x in xs])
    scale = torch.amax(smax) / 127.0 + 1e-12
    total = None
    for x in xs:
        q = torch.clamp(torch.round(x / scale.to(x.device)), -127, 127
                        ).to(torch.int8).to(home)
        total = q.to(torch.int32) if total is None else total + q
    out = total.to(torch.float32) * scale
    return [out.to(x.device) for x in xs]
