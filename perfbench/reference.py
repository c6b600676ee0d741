"""The plain reference of the benchmark's configurations: GCN and GIN
forward passes in float32 over the raw edge list, in plain torch.

It works the normalized adjacency out itself from the edges
(``index_add_`` degree counts, ``D^-1/2 (A + I) D^-1/2`` with D the row
degrees of A + I) and aggregates with ``index_add_`` over blocks of
non-zeros, so it never densifies the adjacency.  Products keep the models'
published order: GCN transforms first where in_dim >= out_dim; GIN
aggregates the raw features.  Imports nothing of the program.

``tf32=True`` is the control: the same forward with every dense product
in TF32, the nearest precision below the configurations' float32 (on a
card through cuBLAS's TF32 mode, on the CPU by rounding the products'
operands to TF32's 10-bit mantissa).
"""
from __future__ import annotations

import contextlib

import torch

# non-zeros aggregated at once: bounds the gathered (block, width) operand
NNZ_BLOCK = 1 << 18


class Adjacency:
    """``D^-1/2 (A + I) D^-1/2`` of a directed edge list, kept as COO."""

    def __init__(self, n: int, src: torch.Tensor, dst: torch.Tensor):
        loops = torch.arange(n, device=src.device, dtype=src.dtype)
        self.n = n
        self.rows = torch.cat([src, loops])
        self.cols = torch.cat([dst, loops])
        ones = torch.ones(self.rows.shape[0], dtype=torch.float32,
                          device=src.device)
        deg = torch.zeros(n, dtype=torch.float32,
                          device=src.device).index_add_(0, self.rows, ones)
        dinv = deg.clamp(min=1.0).pow(-0.5)
        self.vals = dinv[self.rows] * dinv[self.cols]

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def __matmul__(self, y: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(self.n, y.shape[1], dtype=y.dtype, device=y.device)
        for a in range(0, self.nnz, NNZ_BLOCK):
            r = self.rows[a:a + NNZ_BLOCK]
            c = self.cols[a:a + NNZ_BLOCK]
            v = self.vals[a:a + NNZ_BLOCK]
            out.index_add_(0, r, v[:, None] * y[c])
        return out


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest-even at TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def precision(tf32: bool):
    """cuBLAS's TF32 mode as asked, restored on exit; float32 products
    otherwise (the card's default lets cuBLAS use TF32, so it is turned
    off explicitly)."""
    cuda = torch.backends.cuda.matmul
    was = (cuda.allow_tf32, torch.backends.cudnn.allow_tf32)
    cuda.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        cuda.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def _mm(x: torch.Tensor, w: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32 and x.device.type != "cuda":
        x, w = round_tf32(x), round_tf32(w)
    return x @ w


def gcn(adj: Adjacency, h: torch.Tensor, p: dict, tf32: bool = False):
    def layer(z, w):
        if w.shape[0] >= w.shape[1]:
            return adj @ _mm(z, w, tf32)
        return _mm(adj @ z, w, tf32)

    with precision(tf32):
        return layer(torch.relu(layer(h, p["W1"])), p["W2"])


def gin(adj: Adjacency, h: torch.Tensor, p: dict, eps: float = 0.0,
        tf32: bool = False):
    with precision(tf32):
        z = (1.0 + eps) * h + adj @ h
        z = torch.relu(_mm(z, p["M1a"], tf32))
        z = torch.relu(_mm(z, p["M1b"], tf32))
        z = (1.0 + eps) * z + adj @ z
        z = torch.relu(_mm(z, p["M2a"], tf32))
        return _mm(z, p["M2b"], tf32)


def forward(cfg: dict, adj: Adjacency, h: torch.Tensor, params: dict,
            tf32: bool = False) -> torch.Tensor:
    """Logits of configuration ``cfg`` on features ``h``."""
    if cfg["model"] == "GCN":
        return gcn(adj, h, params, tf32)
    if cfg["model"] == "GIN":
        return gin(adj, h, params, cfg.get("eps", 0.0), tf32)
    raise ValueError(f"no reference for model {cfg['model']!r}")
