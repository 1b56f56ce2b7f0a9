"""Fleet router launcher: one HTTP front door over N serve instances.

  # two instances + the router on one box (three terminals):
  PYTHONPATH=src python -m repro_torch.launch.serve --backend sim \\
      --http-host 127.0.0.1 --http-port 8001 --time-scale 8 --duration 0
  PYTHONPATH=src python -m repro_torch.launch.serve --backend sim \\
      --http-host 127.0.0.1 --http-port 8002 --time-scale 8 --duration 0
  PYTHONPATH=src python -m repro_torch.launch.route --port 8000 \\
      --instance http://127.0.0.1:8001 --instance http://127.0.0.1:8002

  # clients talk to the router exactly as to a single instance:
  curl -s localhost:8000/v1/completions -H 'Content-Type: application/json' \\
      -d '{"prompt": "hello fleet", "max_tokens": 16}'

  # late instances join; drains stop placement but finish streams:
  curl -s localhost:8000/fleet/join -d '{"url": "http://127.0.0.1:8003"}'
  curl -s localhost:8000/fleet/drain -d '{"url": "http://127.0.0.1:8001"}'

Placement policies (``--placer``): ``round_robin`` (count baseline),
``least_load`` (the paper's Eq. 10–11 load signal one level up), and
``retention_affinity`` (default; least-load with an epsilon-bounded
preference for the instance retaining the request's session pages —
migrating a session costs its history in re-prefill tokens, §3.3).

The port's copy of ``repro.launch.route``, the same code with its imports
moved to ``repro_torch``.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

from repro_torch.fleet import PLACERS, FleetRouter
from repro_torch.fleet.placement import DEFAULT_TOKEN_TIME


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--instance", action="append", default=[],
                    metavar="URL",
                    help="serving instance base url (repeatable); more "
                         "can join later via POST /fleet/join")
    ap.add_argument("--placer", default="retention_affinity",
                    choices=list(PLACERS))
    ap.add_argument("--poll-interval", type=float, default=1.0,
                    help="seconds between /healthz polls of every "
                         "instance")
    ap.add_argument("--poll-timeout", type=float, default=2.0)
    ap.add_argument("--max-failures", type=int, default=3,
                    help="consecutive poll/proxy failures before an "
                         "instance is evicted")
    ap.add_argument("--epsilon", type=float, default=0.25,
                    help="retention_affinity load-slack factor (the "
                         "MaxMinOffloader tiebreak, one level up)")
    ap.add_argument("--token-time", type=float, default=DEFAULT_TOKEN_TIME,
                    help="router-side per-token cost estimate (seconds)")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="seconds to serve (<= 0 = forever)")
    ap.add_argument("--audit-capacity", type=int, default=1024)
    args = ap.parse_args(argv)

    router = FleetRouter(
        tuple(args.instance), placer=args.placer, host=args.host,
        port=args.port, poll_interval=args.poll_interval,
        poll_timeout=args.poll_timeout, max_failures=args.max_failures,
        epsilon=args.epsilon, token_time=args.token_time,
        audit_capacity=args.audit_capacity)
    router.start()
    health = router.health()
    print(f"[route] fleet router listening on {router.url} "
          f"(placer={args.placer}, {health['n_placeable']}/"
          f"{health['n_instances']} instances placeable)", flush=True)
    try:
        if args.duration > 0:
            time.sleep(args.duration)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    stats = router.stats()
    router.shutdown()
    print(f"[route] routed {stats['n_requests']} requests "
          f"across {len(stats['placements'])} instances; "
          f"reprefill {stats['reprefill_tokens']} tokens, "
          f"{stats['retries']} retries, {stats['evictions']} evictions")
    print(json.dumps(stats, indent=2))


if __name__ == "__main__":
    main()
