"""2-D data partitioning (paper §III-B) and task construction (Eq. 2/3).

A *kernel* is one matmul ``Z = X · Y`` (feature aggregation ``A·H`` or feature
transformation ``H·W``).  It is decomposed into independent *tasks*, one per
output partition ``Z_ij = X_{i,:} · Y_{:,j}`` — the unit the runtime system
schedules onto the dense or sparse engine.  (The mesh placement of the
reference, ``DevicePlacement`` / ``band_partition``, comes with the
multi-device slice of the port.)
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.perfmodel import Primitive, TaskShape


@dataclasses.dataclass
class Task:
    kernel: str
    i: int                    # output row-tile index
    j: int                    # output col-tile index
    shape: TaskShape          # m, n, d + stripe densities
    # filled by the analyzer:
    primitive: Primitive | None = None
    queue: str | None = None        # "STQ" | "DTQ"
    t_dense: float = 0.0
    t_sparse: float = 0.0
    device: int = 0                 # mesh placement (analyze_sharded)
    _sparse_prim: Primitive = "SpDMM"   # best sparse primitive (analyzer)

    @property
    def t_assigned(self) -> float:
        return self.t_sparse if self.queue == "STQ" else self.t_dense


@dataclasses.dataclass
class KernelPartition:
    """All tasks of one kernel, plus tile geometry for (re)assembly."""
    name: str
    M: int
    K: int
    N: int
    tile_m: int
    tile_n: int
    tasks: list[Task]

    @property
    def n_row_tiles(self) -> int:
        return -(-self.M // self.tile_m)

    @property
    def n_col_tiles(self) -> int:
        return -(-self.N // self.tile_n)

    def row_extent(self, i: int) -> int:
        """Logical row count of row-tile ``i`` (ragged tail aware)."""
        return min(self.tile_m, self.M - i * self.tile_m)

    def col_extent(self, j: int) -> int:
        """Logical column count of col-tile ``j`` (ragged tail aware)."""
        return min(self.tile_n, self.N - j * self.tile_n)


def make_tasks(
    name: str,
    M: int, K: int, N: int,
    row_density: Sequence[float],
    col_density: Sequence[float],
    tile_m: int,
    tile_n: int,
) -> KernelPartition:
    """Build the task grid from per-stripe densities.

    ``row_density[i]`` is α(X_{i,:}) over the FULL contraction dim (the
    concatenation of X_{ik} over k, Eq. 3); ``col_density[j]`` is α(Y_{:,j}).
    """
    nrt, nct = -(-M // tile_m), -(-N // tile_n)
    assert len(row_density) == nrt, (len(row_density), nrt)
    assert len(col_density) == nct, (len(col_density), nct)
    tasks = []
    for i in range(nrt):
        m = min(tile_m, M - i * tile_m)
        for j in range(nct):
            d = min(tile_n, N - j * tile_n)
            tasks.append(Task(
                kernel=name, i=i, j=j,
                shape=TaskShape(m=m, n=K, d=d,
                                alpha_x=float(row_density[i]),
                                alpha_y=float(col_density[j])),
            ))
    return KernelPartition(name=name, M=M, K=K, N=N,
                           tile_m=tile_m, tile_n=tile_n, tasks=tasks)


def choose_tile(M: int, N: int, target_tiles: int = 64,
                minimum: int = 128) -> tuple[int, int]:
    """Pick tile sizes giving roughly ``target_tiles`` tasks.

    Mirrors the paper's preprocessing choice: partitions must fit on-chip
    memory but be numerous enough to load-balance 8 ALU arrays + AIE.
    """
    def pick(dim):
        t = max(minimum, int(np.ceil(dim / np.sqrt(target_tiles))))
        # round up to a multiple of 128 for MXU alignment
        return -(-t // 128) * 128

    return min(pick(M), -(-M // 128) * 128), min(pick(N), -(-N // 128) * 128)
