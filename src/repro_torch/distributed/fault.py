"""Failure & straggler detection hooks for the launcher AND the serving
dispatch workers.

This is the host-side control plane: it never enters device code.  On a real
cluster each host runs a heartbeat thread; the coordinator aggregates and
triggers the elastic re-mesh (distributed/elastic.py).  In-process, the
serving layer runs one :class:`FaultMonitor` over its dispatch worker(s):
every micro-batch heartbeats with its step time, and
``ServingEngine.dispatch_stats()["health"]`` surfaces :meth:`snapshot` — the
liveness/straggler view an operator (or the chaos bench) reads.  The
detector logic is fully testable off-cluster.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque


@dataclasses.dataclass
class HostState:
    last_heartbeat: float
    step_times: deque        # recent per-step wall times


class FaultMonitor:
    """Tracks per-host heartbeats and per-step times.

    - ``dead_hosts``: no heartbeat for ``timeout`` seconds.
    - ``stragglers``: hosts whose rolling median step time exceeds
      ``straggler_factor`` x the cluster median (persistent slowness — the
      launcher responds by excluding the host at the next re-mesh, the
      standard mitigation when checkpoint-restart is cheap).
    """

    def __init__(self, hosts: list[str], *, timeout: float = 60.0,
                 straggler_factor: float = 2.0, window: int = 16):
        self.timeout = timeout
        self.straggler_factor = straggler_factor
        self.window = window
        now = time.monotonic()
        self.hosts = {h: HostState(now, deque(maxlen=window)) for h in hosts}

    def ensure_host(self, host: str, now: float | None = None) -> None:
        """Start tracking ``host`` if it is new (elastic join / a serving
        engine growing its dispatch-worker pool)."""
        if host not in self.hosts:
            now = time.monotonic() if now is None else now
            self.hosts[host] = HostState(now, deque(maxlen=self.window))

    def heartbeat(self, host: str, step_time: float | None = None,
                  now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        self.ensure_host(host, now=now)
        st = self.hosts[host]
        st.last_heartbeat = now
        if step_time is not None:
            st.step_times.append(step_time)

    def dead_hosts(self, now: float | None = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return [h for h, st in self.hosts.items()
                if now - st.last_heartbeat > self.timeout]

    @staticmethod
    def _median(xs) -> float:
        xs = sorted(xs)
        return xs[len(xs) // 2] if xs else 0.0

    def stragglers(self) -> list[str]:
        medians = {h: self._median(st.step_times)
                   for h, st in self.hosts.items() if st.step_times}
        if len(medians) < 2:
            return []
        cluster = self._median(list(medians.values()))
        if cluster <= 0:
            return []
        return [h for h, m in medians.items()
                if m > self.straggler_factor * cluster]

    def healthy_hosts(self, now: float | None = None) -> list[str]:
        dead = set(self.dead_hosts(now=now)) | set(self.stragglers())
        return [h for h in self.hosts if h not in dead]

    def snapshot(self, now: float | None = None) -> dict:
        """One JSON-able view of the monitored fleet: per-host heartbeat age
        and rolling median step time, plus the dead/straggler/healthy
        classification — the ``dispatch_stats()["health"]`` surface."""
        now = time.monotonic() if now is None else now
        return {
            "hosts": {
                h: {
                    "heartbeat_age_s": now - st.last_heartbeat,
                    "median_step_s": self._median(st.step_times),
                    "steps": len(st.step_times),
                }
                for h, st in self.hosts.items()
            },
            "dead": self.dead_hosts(now=now),
            "stragglers": self.stragglers(),
            "healthy": self.healthy_hosts(now=now),
        }
