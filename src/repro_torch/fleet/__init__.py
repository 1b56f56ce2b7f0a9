"""``repro_torch.fleet`` — multi-instance serving: a router over N instances.

The layer above ``repro_torch.serving``: each instance is one full serving
stack (``serve --http-port`` — SchedulerCore, admission, KV pool, HTTP
front end), and the fleet router plays the paper's Eq. 10–11 load game
*one level up*, placing whole requests on instances the way the
offloader places batches on workers:

  * :mod:`repro_torch.fleet.registry` — :class:`InstanceRegistry` polls each
    instance's ``/healthz`` placement-input vector into typed
    :class:`InstanceSnapshot` rows; join/drain/leave lifecycle and
    crash eviction;
  * :mod:`repro_torch.fleet.placement` — the pluggable :class:`Placer`
    protocol with ``round_robin``, ``least_load``, and
    ``retention_affinity`` policies;
  * :mod:`repro_torch.fleet.router` — :class:`FleetRouter`, the stdlib HTTP
    proxy (SSE passthrough, verbatim 429 ``Retry-After``, session
    pinning with override, exactly-once crash re-placement).

Launch with ``python -m repro_torch.launch.route``.

The port's copy of ``repro.fleet``, the same code with its imports moved to
``repro_torch``.
"""
from repro_torch.fleet.placement import (PLACERS, LeastLoadPlacer,
                                         Placement, PlacementRequest, Placer,
                                         RetentionAffinityPlacer,
                                         RoundRobinPlacer, imbalance,
                                         make_placer)
from repro_torch.fleet.registry import (InstanceRecord, InstanceRegistry,
                                        InstanceSnapshot)
from repro_torch.fleet.router import FleetRouter, NoInstanceAvailable

__all__ = [
    "FleetRouter", "NoInstanceAvailable",
    "InstanceRegistry", "InstanceRecord", "InstanceSnapshot",
    "Placer", "Placement", "PlacementRequest", "PLACERS",
    "RoundRobinPlacer", "LeastLoadPlacer", "RetentionAffinityPlacer",
    "make_placer", "imbalance",
]
