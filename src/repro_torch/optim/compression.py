"""Int8 error-feedback gradient compression: the reference's
``repro/optim/compression.py``.

Each gradient leaf is quantized to int8 against a per-leaf scale and
dequantized, and the quantization residual is kept as error-feedback
state (Seide et al. / EF-SGD) and added to the next step's gradient,
which restores convergence to the uncompressed trajectory.  Leaves are
dicts of name -> tensor; a None gradient is a zero one.  ``torch.round``
rounds half to even, as ``jnp.round`` does, so a leaf's result equals
the reference's bitwise.

The reference's ``psum8`` (the int8 all-reduce inside ``shard_map``)
comes with the distribution slice.
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
