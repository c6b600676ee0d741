"""2-D data partitioning (paper §III-B) and task construction (Eq. 2/3).

A *kernel* is one matmul ``Z = X · Y`` (feature aggregation ``A·H`` or feature
transformation ``H·W``).  It is decomposed into independent *tasks*, one per
output partition ``Z_ij = X_{i,:} · Y_{:,j}`` — the unit the runtime system
schedules onto the dense or sparse engine.

Placement (multi-device): on a mesh engine the Analyzer's queue assignment
becomes a TWO-level decision ``(device, queue)`` — each device owns a
contiguous band of row-stripes (:class:`DevicePlacement`, min-makespan over
the per-device hardware models via :func:`band_partition`), and within its
band the usual STQ/DTQ split applies.
"""
from __future__ import annotations

import bisect
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


@dataclasses.dataclass(frozen=True)
class DevicePlacement:
    """Assignment of contiguous row-stripe bands to mesh devices.

    ``band_starts`` has ``n_devices + 1`` monotone entries with
    ``band_starts[0] == 0`` and ``band_starts[-1] == n_row_tiles``; device
    ``d`` owns stripes ``[band_starts[d], band_starts[d+1])``.  Bands may be
    empty (more devices than stripes).
    """
    n_devices: int
    band_starts: tuple[int, ...]

    def __post_init__(self):
        bs = self.band_starts
        if len(bs) != self.n_devices + 1 or bs[0] != 0:
            raise ValueError(f"malformed band_starts {bs} for "
                             f"{self.n_devices} devices")
        if any(bs[d] > bs[d + 1] for d in range(self.n_devices)):
            raise ValueError(f"band_starts must be monotone, got {bs}")

    @property
    def n_row_tiles(self) -> int:
        return self.band_starts[-1]

    def device_of(self, stripe: int) -> int:
        if not 0 <= stripe < self.n_row_tiles:
            raise ValueError(f"stripe {stripe} outside [0, {self.n_row_tiles})")
        return bisect.bisect_right(self.band_starts, stripe) - 1

    def stripes_of(self, device: int) -> range:
        return range(self.band_starts[device], self.band_starts[device + 1])

    def band_sizes(self) -> tuple[int, ...]:
        bs = self.band_starts
        return tuple(bs[d + 1] - bs[d] for d in range(self.n_devices))


def band_partition(loads: np.ndarray, n_devices: int) -> tuple[int, ...]:
    """Min-makespan contiguous partition of stripes into device bands.

    ``loads[d, s]`` is the cost of stripe ``s`` when placed on device ``d``
    (devices may run different models, so the cost of one stripe differs
    per device).  Exact DP:
    ``f[d][b] = min_a max(f[d-1][a], sum(loads[d, a:b]))``, O(D·S²).
    Returns ``band_starts`` of length ``n_devices + 1``.
    """
    loads = np.asarray(loads, dtype=np.float64)
    if loads.ndim != 2 or loads.shape[0] != n_devices:
        raise ValueError(f"loads must be (n_devices, n_stripes), got "
                         f"{loads.shape} for {n_devices} devices")
    S = loads.shape[1]
    # prefix[d, b] = sum of loads[d, :b]
    prefix = np.concatenate(
        [np.zeros((n_devices, 1)), np.cumsum(loads, axis=1)], axis=1)
    f = prefix[0].copy()               # device 0 takes stripes [0, b)
    back = np.zeros((n_devices, S + 1), dtype=np.int64)
    for d in range(1, n_devices):
        nf = np.empty(S + 1)
        for b in range(S + 1):
            band = prefix[d, b] - prefix[d, : b + 1]     # cost of [a, b) on d
            cand = np.maximum(f[: b + 1], band)
            a = int(np.argmin(cand))
            nf[b] = cand[a]
            back[d, b] = a
        f = nf
    starts = [S]
    for d in range(n_devices - 1, 0, -1):
        starts.append(int(back[d, starts[-1]]))
    starts.append(0)
    return tuple(reversed(starts))


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
