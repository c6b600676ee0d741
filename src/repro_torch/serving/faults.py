"""FaultInjector — seedable, deterministic chaos for the serving stack.

Production serving must *degrade*, not crash: a poison request should fail
alone, a flaky compiled program should fall back to the eager executor, a
truncated snapshot should cold-start.  None of those paths is trustworthy
unless it runs in CI, and none of them runs in CI unless failures can be
produced on demand.  This module is that switch: every layer of the stack
carries named probe points, and an armed :class:`FaultInjector` decides —
deterministically, from a seed — which probes raise an
:class:`InjectedFault` (or stall, for straggler/deadline testing).

Instrumented sites (``KNOWN_SITES``):

====================  ====================================================
``plan``              ``DynasparseEngine.plan`` entry (analysis phase)
``lower``             single-device descriptor lowering (``build_dispatch``)
``pack``              structure/activation packing
                      (``_packed_structure`` build,
                      ``build_activation_dispatch``)
``execute``           ``DynasparseEngine.execute`` entry (eager execute)
``shard_lower``       sharded descriptor lowering + halo-exchange schedule
                      compilation (``build_sharded_dispatch``)
``shard_exec``        sharded compiled execute entry
                      (``shard_exec.execute_sharded``, a mesh engine's
                      literal adjacency kernel)
``compiled``          ``CompiledModel.__call__`` (whole-model compiled
                      execute: a CUDA-graph replay on the card)
``request``           per-request probe inside the serving dispatch — the
                      poison-request site (``detail`` carries
                      ``req:<request_id>;``; pair with ``match="req:7;"`` —
                      the ``;`` terminator keeps id 7 from matching 71)
``dispatch``          serving dispatch-worker entry (use ``delay_s`` here
                      to manufacture stragglers/deadline misses)
``snapshot_save``     ``SharedPlanCache.save`` (before the atomic rename —
                      a fault here must never corrupt the target file)
``snapshot_load``     ``SharedPlanCache.load`` (must degrade to a logged
                      cold start, never crash the restart path)
====================  ====================================================

Determinism: each site owns an independent ``numpy`` Generator seeded from
``(seed, site)``, consumed once per rate draw — with a fixed seed and a
deterministic probe order (serving dispatch is single-worker), the same
faults fire at the same probes on every run, so a chaos scenario is
reproducible and its gates are not flaky.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from collections import Counter

import numpy as np

KNOWN_SITES = frozenset({
    "plan", "lower", "pack", "execute", "compiled",
    "shard_lower", "shard_exec",
    "request", "dispatch", "snapshot_save", "snapshot_load",
})


class InjectedFault(RuntimeError):
    """A failure manufactured by a :class:`FaultInjector` probe."""

    def __init__(self, site: str, detail: str = "", n: int = 0):
        self.site = site
        self.detail = detail
        self.n = n           # per-site probe index the fault fired at
        msg = f"injected fault at site {site!r}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg + f" [probe #{n}]")


class DeadlineExceeded(RuntimeError):
    """A request missed its ``ServingConfig.request_timeout`` deadline.

    Raised to the submitter by ``ServingEngine.infer``; the request's
    ``RequestStats.error`` carries the same message, so stragglers are
    observable in the stats instead of hanging ``serve()``."""


@dataclasses.dataclass
class _Arm:
    """One armed failure rule on a site."""
    rate: float = 1.0           # firing probability per eligible probe
    count: int | None = None    # max fires (None = unlimited)
    after: int = 0              # skip the first `after` eligible probes
    delay_s: float = 0.0        # > 0: stall instead of raising
    match: str | None = None    # substring filter on the probe's detail
    fired: int = 0
    seen: int = 0               # eligible (match-passing) probes observed


class FaultInjector:
    """Deterministic, seedable failure/delay injection at named sites.

    Arm failure rules with :meth:`arm`, thread the injector through the
    stack (``DynasparseEngine(faults=...)``, ``ServingConfig(faults=...)``,
    ``SharedPlanCache(faults=...)``), and every instrumented layer will
    consult it via :meth:`probe`.  Thread-safe: the serving dispatch worker
    and the event loop may probe concurrently.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._arms: dict[str, list[_Arm]] = {}
        self._rngs: dict[str, np.random.Generator] = {}
        self._lock = threading.RLock()
        self.probes: Counter = Counter()   # probes observed per site
        self.fired: Counter = Counter()    # faults raised per site
        self.delayed: Counter = Counter()  # delays served per site

    # --------------------------------------------------------------- setup
    def arm(self, site: str, *, rate: float = 1.0, count: int | None = None,
            after: int = 0, delay_s: float = 0.0,
            match: str | None = None) -> "FaultInjector":
        """Arm one failure rule; returns ``self`` for chaining.

        ``rate`` is the per-probe firing probability (1.0 = every eligible
        probe); ``count`` bounds total fires; ``after`` skips the first N
        eligible probes (lets a warmup pass run clean); ``delay_s > 0``
        sleeps instead of raising (straggler injection); ``match`` restricts
        the rule to probes whose detail contains the substring (poison
        requests: ``match="req:7;"``).
        """
        if site not in KNOWN_SITES:
            raise ValueError(
                f"unknown fault site {site!r} (instrumented sites: "
                f"{sorted(KNOWN_SITES)})")
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        with self._lock:
            self._arms.setdefault(site, []).append(_Arm(
                rate=rate, count=count, after=after, delay_s=delay_s,
                match=match))
        return self

    def disarm(self, site: str | None = None) -> None:
        """Drop every rule on ``site`` (or on all sites)."""
        with self._lock:
            if site is None:
                self._arms.clear()
            else:
                self._arms.pop(site, None)

    # --------------------------------------------------------------- probe
    def _rng(self, site: str) -> np.random.Generator:
        rng = self._rngs.get(site)
        if rng is None:
            # independent, reproducible stream per site: the firing pattern
            # at one site never shifts because another site probed more
            rng = np.random.default_rng(
                (self.seed, zlib.crc32(site.encode())))
            self._rngs[site] = rng
        return rng

    def probe(self, site: str, detail: str = "") -> None:
        """Consult the injector at an instrumented site.

        Raises :class:`InjectedFault` (or sleeps, for delay rules) when an
        armed rule fires; a no-op otherwise (and always a no-op on an
        injector with nothing armed — the probes are cheap enough to leave
        in production code paths).
        """
        with self._lock:
            self.probes[site] += 1
            n = self.probes[site]
            arms = self._arms.get(site)
            if not arms:
                return
            for a in arms:
                if a.match is not None and a.match not in detail:
                    continue
                a.seen += 1
                if a.seen <= a.after:
                    continue
                if a.count is not None and a.fired >= a.count:
                    continue
                if a.rate < 1.0 and self._rng(site).random() >= a.rate:
                    continue
                a.fired += 1
                if a.delay_s > 0.0:
                    self.delayed[site] += 1
                    delay = a.delay_s
                    break
                self.fired[site] += 1
                raise InjectedFault(site, detail=detail, n=n)
            else:
                return
        # sleep OUTSIDE the lock: a stalled dispatch worker must not block
        # other threads' probes (that would serialize the chaos)
        time.sleep(delay)

    # ----------------------------------------------------------- telemetry
    def summary(self) -> dict:
        """Per-site probe/fire/delay counts (the bench/test observable)."""
        with self._lock:
            sites = set(self.probes) | set(self.fired) | set(self.delayed)
            return {
                site: {"probes": self.probes[site],
                       "fired": self.fired[site],
                       "delayed": self.delayed[site]}
                for site in sorted(sites)
            }

    @property
    def total_fired(self) -> int:
        with self._lock:
            return sum(self.fired.values())


def probe(faults: "FaultInjector | None", site: str, detail: str = "") -> None:
    """Null-safe probe helper: every instrumented layer calls this with its
    (possibly ``None``) injector, keeping call sites one line."""
    if faults is not None:
        faults.probe(site, detail)
