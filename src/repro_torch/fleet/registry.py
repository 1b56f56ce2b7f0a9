"""Instance registry for the fleet router (``repro_torch.fleet``).

One serving instance = one ``serve --http-port`` process (a full
``SchedulerCore`` with its own workers, admission controller, and KV
pool).  The registry is the router's *only* view of the fleet: it polls
each instance's ``/healthz`` — which exports the full placement-input
vector (the Eq. 10–11 load terms, free/retained/shared block counts,
resident session count; see ``HTTPFrontend._snapshot``) — into a typed
:class:`InstanceSnapshot` that the :class:`~repro_torch.fleet.placement.Placer`
policies consume.

Lifecycle mirrors a real fleet:

  * ``join(url)`` — register a new instance (the router's ``POST
    /fleet/join`` endpoint lands here);
  * ``drain(url)`` — stop placing on it; already-proxied streams run on
    sockets the registry never touches, so they finish on their own;
  * ``remove(url)`` — drain + forget;
  * crash detection — a failed poll immediately marks the snapshot
    unhealthy (the placer skips it on the very next decision); after
    ``max_failures`` *consecutive* failures the instance is evicted and
    every ``on_evict`` callback fires (the router uses this to unpin
    sessions so their next turn re-places with a deliberate re-prefill).

Determinism: the registry holds no RNG and iterates instances in sorted
URL order everywhere, so a router driven by a fixed request sequence
against fixed snapshots makes a reproducible placement sequence.

The port's copy of ``repro.fleet.registry``, the same code with its imports
moved to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Mapping, Optional

__all__ = ["InstanceSnapshot", "InstanceRecord", "InstanceRegistry"]

#: instance lifecycle states (``removed`` instances simply leave the map)
ACTIVE = "active"
DRAINING = "draining"


@dataclasses.dataclass(frozen=True)
class InstanceSnapshot:
    """One poll of one instance's ``/healthz`` — the placement inputs.

    ``queue_delay_est`` is the instance's own Eq. 10–11 predicted queue
    delay (``repro_torch.serving.admission.predicted_queue_delay``): the
    min-load across its workers plus the backlog its pool would add.
    ``worker_loads`` / ``min_load`` are the raw Eq. 11 terms underneath
    it.  The block and session fields feed the ``retention_affinity``
    migration-cost term.
    """

    instance: str                    # registry key: the base URL
    healthy: bool
    polled_at: float                 # wall-clock time of the poll
    in_flight: int = 0               # live request handles
    queue_depth: int = 0             # queued + pending slices
    in_flight_slices: int = 0
    worker_loads: tuple = ()         # Eq. 11 per-worker loads (core s)
    min_load: float = 0.0            # Eq. 11 min over workers
    queue_delay_est: float = 0.0     # Eq. 10–11 predicted queue delay
    free_blocks: Optional[tuple] = None      # paged backend only
    retained_blocks: Optional[tuple] = None  # kv_retain=request only
    shared_blocks: int = 0           # COW prefix pages currently shared
    n_sessions: int = 0              # resident session anchors
    n_submitted: int = 0             # admission counters (cumulative)
    n_rejected: int = 0

    @classmethod
    def from_healthz(cls, instance: str, payload: Mapping[str, Any],
                     polled_at: float) -> "InstanceSnapshot":
        """Parse one ``/healthz`` body; absent keys keep their defaults
        (an older instance or a dense backend simply exports less)."""

        def _i(key: str, default: int = 0) -> int:
            v = payload.get(key, default)
            return int(v) if isinstance(v, (int, float)) else default

        def _f(key: str) -> float:
            v = payload.get(key, 0.0)
            return float(v) if isinstance(v, (int, float)) else 0.0

        def _blocks(key: str) -> Optional[tuple]:
            v = payload.get(key)
            return tuple(int(b) for b in v) if isinstance(v, list) else None

        loads = payload.get("worker_loads")
        return cls(
            instance=instance, healthy=payload.get("status") == "ok",
            polled_at=polled_at, in_flight=_i("in_flight"),
            queue_depth=_i("queue_depth"),
            in_flight_slices=_i("in_flight_slices"),
            worker_loads=(tuple(float(x) for x in loads)
                          if isinstance(loads, list) else ()),
            min_load=_f("min_load"), queue_delay_est=_f("queue_delay_est"),
            free_blocks=_blocks("free_blocks"),
            retained_blocks=_blocks("retained_blocks"),
            shared_blocks=_i("shared_blocks"), n_sessions=_i("n_sessions"),
            n_submitted=_i("n_submitted"), n_rejected=_i("n_rejected"))

    @classmethod
    def unreachable(cls, instance: str,
                    polled_at: float) -> "InstanceSnapshot":
        return cls(instance=instance, healthy=False, polled_at=polled_at)


@dataclasses.dataclass
class InstanceRecord:
    """Registry bookkeeping for one instance."""

    url: str
    state: str = ACTIVE              # ACTIVE | DRAINING
    snapshot: Optional[InstanceSnapshot] = None
    consecutive_failures: int = 0

    @property
    def placeable(self) -> bool:
        return (self.state == ACTIVE and self.snapshot is not None
                and self.snapshot.healthy)

    def summary(self) -> Dict[str, Any]:
        """The router's ``/healthz`` row for this instance."""
        out: Dict[str, Any] = dict(
            url=self.url, state=self.state,
            healthy=bool(self.snapshot and self.snapshot.healthy),
            consecutive_failures=self.consecutive_failures)
        if self.snapshot is not None and self.snapshot.healthy:
            out.update(queue_depth=self.snapshot.queue_depth,
                       in_flight=self.snapshot.in_flight,
                       queue_delay_est=self.snapshot.queue_delay_est,
                       n_sessions=self.snapshot.n_sessions)
        return out


class InstanceRegistry:
    """Polls instance ``/healthz`` into snapshots — module docstring.

    ``fetch`` is injectable for tests (``url -> healthz dict``, raising
    on an unreachable instance); the default issues a real HTTP GET.
    """

    def __init__(self, instances: tuple = (), *, poll_timeout: float = 2.0,
                 max_failures: int = 3,
                 fetch: Optional[Callable[[str], Mapping[str, Any]]] = None):
        if max_failures < 1:
            raise ValueError(f"max_failures must be >= 1, "
                             f"got {max_failures}")
        self.poll_timeout = float(poll_timeout)
        self.max_failures = int(max_failures)
        self._fetch = fetch if fetch is not None else self._fetch_healthz
        self._lock = threading.Lock()
        self._records: Dict[str, InstanceRecord] = {}
        self._on_evict: List[Callable[[str], None]] = []
        self._poll_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        for url in instances:
            self.join(url)

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------
    @staticmethod
    def normalize(url: str) -> str:
        url = url.strip().rstrip("/")
        if not url.startswith(("http://", "https://")):
            raise ValueError(f"instance url must be http(s), got {url!r}")
        return url

    def join(self, url: str) -> bool:
        """Register an instance; returns False if already present (a
        rejoin of a draining instance reactivates it)."""
        url = self.normalize(url)
        with self._lock:
            rec = self._records.get(url)
            if rec is not None:
                fresh = rec.state != ACTIVE
                rec.state = ACTIVE
                rec.consecutive_failures = 0
                return fresh
            self._records[url] = InstanceRecord(url=url)
            return True

    def drain(self, url: str) -> bool:
        """Stop placing on ``url``; in-flight proxied streams finish on
        their own sockets.  Returns False for an unknown instance."""
        url = self.normalize(url)
        with self._lock:
            rec = self._records.get(url)
            if rec is None:
                return False
            rec.state = DRAINING
            return True

    def remove(self, url: str) -> bool:
        url = self.normalize(url)
        with self._lock:
            return self._records.pop(url, None) is not None

    def on_evict(self, cb: Callable[[str], None]) -> None:
        """Register a crash-eviction callback (called with the url,
        outside the registry lock)."""
        self._on_evict.append(cb)

    # ------------------------------------------------------------------
    # views (always sorted by url — placement determinism)
    # ------------------------------------------------------------------
    def records(self) -> List[InstanceRecord]:
        with self._lock:
            return [self._records[u] for u in sorted(self._records)]

    def placeable(self) -> List[InstanceSnapshot]:
        """Healthy, non-draining snapshots in sorted-url order — the
        candidate list every placement decision sees."""
        with self._lock:
            return [r.snapshot for u, r in sorted(self._records.items())
                    if r.placeable and r.snapshot is not None]

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def __contains__(self, url: str) -> bool:
        with self._lock:
            return self.normalize(url) in self._records

    # ------------------------------------------------------------------
    # polling / crash detection
    # ------------------------------------------------------------------
    def _fetch_healthz(self, url: str) -> Mapping[str, Any]:
        with urllib.request.urlopen(f"{url}/healthz",
                                    timeout=self.poll_timeout) as resp:
            payload = json.loads(resp.read())
        if not isinstance(payload, dict):
            raise ValueError(f"{url}/healthz returned non-object JSON")
        return payload

    def note_failure(self, url: str) -> bool:
        """One observed failure (poll *or* proxy) for ``url``; returns
        True when this failure crossed the eviction threshold."""
        url = self.normalize(url)
        evicted = False
        with self._lock:
            rec = self._records.get(url)
            if rec is None:
                return False
            rec.consecutive_failures += 1
            rec.snapshot = InstanceSnapshot.unreachable(url, time.time())
            if rec.consecutive_failures >= self.max_failures:
                del self._records[url]
                evicted = True
        if evicted:
            for cb in self._on_evict:
                cb(url)
        return evicted

    def poll_once(self) -> int:
        """Poll every registered instance once; returns the number of
        healthy snapshots.  Crash path: failures mark the snapshot
        unhealthy immediately and evict past ``max_failures``."""
        healthy = 0
        for url in sorted(u for u in self._urls()):
            try:
                payload = self._fetch(url)
            except Exception:
                self.note_failure(url)
                continue
            snap = InstanceSnapshot.from_healthz(url, payload, time.time())
            with self._lock:
                rec = self._records.get(url)
                if rec is None:  # removed while polling
                    continue
                rec.snapshot = snap
                rec.consecutive_failures = 0
            if snap.healthy:
                healthy += 1
        return healthy

    def _urls(self) -> List[str]:
        with self._lock:
            return list(self._records)

    def poll_instance(self, url: str) -> bool:
        """Poll a single instance now (used right after ``join`` so it
        becomes placeable without waiting for the next poll tick)."""
        url = self.normalize(url)
        try:
            payload = self._fetch(url)
        except Exception:
            self.note_failure(url)
            return False
        snap = InstanceSnapshot.from_healthz(url, payload, time.time())
        with self._lock:
            rec = self._records.get(url)
            if rec is None:
                return False
            rec.snapshot = snap
            rec.consecutive_failures = 0
        return snap.healthy

    # ------------------------------------------------------------------
    # background poll loop
    # ------------------------------------------------------------------
    def start(self, interval: float) -> None:
        if self._poll_thread is not None:
            return
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(interval):
                self.poll_once()

        self._poll_thread = threading.Thread(
            target=_loop, name="fleet-registry-poll", daemon=True)
        self._poll_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5.0)
            self._poll_thread = None
