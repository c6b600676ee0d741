"""What a traffic driver hands back from its measured window, and the
seeded sample of the window's answers that the check compares."""
from __future__ import annotations

import dataclasses
import random

import numpy as np
import torch

SAMPLE = 32      # answers kept from a window for the check


@dataclasses.dataclass
class Window:
    t_start: float                  # host clock, seconds
    t_end: float                    # the last answer's arrival
    attempted: int
    failed: int
    latencies: list[float]          # seconds, one per completed unit
    counters: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start

    @property
    def completed(self) -> int:
        return len(self.latencies)

    @property
    def in_window(self) -> int:
        """Units completed before the window closed (all of them, unless
        the driver counts answers that came after its close)."""
        return self.counters.get("done_in_window", self.completed)

    def p95_ms(self) -> float | None:
        """The 95th percentile of every latency in the window, ms."""
        if not self.latencies:
            return None
        return 1e3 * float(np.percentile(self.latencies, 95))


class Sampler:
    """A uniform sample of at most ``size`` of the answers offered, drawn
    from ``seed`` (reservoir sampling): each kept answer is
    ``(pool index, logits)``."""

    def __init__(self, seed: int, size: int = SAMPLE):
        self.rng = random.Random(int(seed))
        self.size = size
        self.seen = 0
        self.kept: list[tuple[int, torch.Tensor]] = []

    def offer(self, pool_index: int, logits: torch.Tensor) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((pool_index, logits))
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            self.kept[j] = (pool_index, logits)


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
