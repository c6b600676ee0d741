"""The yardstick's FLOP and byte count of one inference.

The count reads the work the model defines, whatever implements it:

- products in the model's published order (GCN transforms first where
  in_dim >= out_dim; GIN aggregates the raw features);
- a dense product ``(m, k) x (k, n)`` counts ``2 m k n`` FLOPs, the
  features and activations counted as the dense matrices the model
  defines;
- ``A_hat . Y`` counts ``2 nnz(A_hat) n``, with ``nnz`` the edges plus the
  self-loops;
- bytes are each input read once and each output written once, float32,
  the adjacency as the benchmark hands it over: COO, 12 bytes a non-zero;
- ReLU and GIN's ``(1 + eps) h + A_hat h`` count their bytes and no FLOPs.
"""
from __future__ import annotations

import dataclasses

F32 = 4
COO_BYTES = 12          # int32 row, int32 col, float32 value

# one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at 700 W
PEAK_FLOPS = 67e12      # float32 without tensor cores
PEAK_BYTES = 3.35e12    # HBM3, bytes/s


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    flops: int
    bytes: int

    @property
    def bound_s(self) -> float:
        """The least time the card could take for this operation."""
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES)


def dense(name: str, m: int, k: int, n: int) -> Op:
    return Op(name, 2 * m * k * n, F32 * (m * k + k * n + m * n))


def aggregate(name: str, nnz: int, m: int, n: int) -> Op:
    return Op(name, 2 * nnz * n, COO_BYTES * nnz + F32 * 2 * m * n)


def elementwise(name: str, m: int, n: int, reads: int) -> Op:
    return Op(name, 0, F32 * m * n * (reads + 1))


def ops(cfg: dict, n: int | None = None, edges: int | None = None,
        features: int | None = None) -> list[Op]:
    """The operations of one inference of ``cfg`` (sizes from its graph
    unless given)."""
    g = cfg["graph"]
    n = g["vertices"] if n is None else n
    nnz = (g["edges"] if edges is None else edges) + n
    f = g["features"] if features is None else features
    h, c = cfg["hidden"], g["classes"]
    if cfg["model"] == "GCN":
        out = []
        for tag, k, m in (("l1", f, h), ("l2", h, c)):
            if k >= m:
                out += [dense(f"{tag}-update", n, k, m),
                        aggregate(f"{tag}-agg", nnz, n, m)]
            else:
                out += [aggregate(f"{tag}-agg", nnz, n, k),
                        dense(f"{tag}-update", n, k, m)]
            if tag == "l1":
                out.append(elementwise("l1-relu", n, h, 1))
        return out
    if cfg["model"] == "GIN":
        return [aggregate("l1-agg", nnz, n, f),
                elementwise("l1-combine", n, f, 2),
                dense("l1-mlp1", n, f, h), elementwise("l1-relu1", n, h, 1),
                dense("l1-mlp2", n, h, h), elementwise("l1-relu2", n, h, 1),
                aggregate("l2-agg", nnz, n, h),
                elementwise("l2-combine", n, h, 2),
                dense("l2-mlp1", n, h, h), elementwise("l2-relu1", n, h, 1),
                dense("l2-mlp2", n, h, c)]
    raise ValueError(f"no count for model {cfg['model']!r}")


def flops(cfg: dict, **sizes) -> int:
    return sum(o.flops for o in ops(cfg, **sizes))


def bound_s(cfg: dict, **sizes) -> float:
    """Sum over the operations of one inference of their least time."""
    return sum(o.bound_s for o in ops(cfg, **sizes))
