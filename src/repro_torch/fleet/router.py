"""Fleet router: one HTTP front door over N serving instances.

Stdlib only, mirroring the ``HTTPFrontend`` (``http.server`` +
threads); the router holds *no scheduler* — it polls instance
``/healthz`` into an :class:`~repro_torch.fleet.registry.InstanceRegistry`,
places each request with a pluggable
:class:`~repro_torch.fleet.placement.Placer`, and proxies the OpenAI surface:

  * ``POST /v1/completions`` / ``POST /v1/chat/completions`` — placed,
    then streamed through byte-for-byte: SSE chunks forward line by line
    as the instance emits them, a 429 forwards with the instance's
    ``Retry-After`` verbatim (the admission decision is the instance's
    to make, not the router's);
  * ``DELETE /v1/sessions/<id>`` — forwarded to the session's pinned
    instance; the pin and history bookkeeping drop with it;
  * ``GET /healthz`` — the fleet view: per-instance state rows,
    ``n_instances`` (registered), ``n_placeable``;
  * ``GET /metrics`` — the router's own Prometheus registry
    (placements, served tokens, re-prefill tokens, retries, evictions
    — all labeled per instance where it makes sense);
  * ``GET /metrics.json`` — one-shot JSON stats;
  * ``GET /debug/placements`` — the placement audit ring (per-decision
    policy, chosen instance, decision-time loads, migration info) —
    the fleet-level sibling of ``/debug/decisions``;
  * ``POST /fleet/join`` / ``/fleet/drain`` / ``/fleet/leave`` —
    instance lifecycle (see the registry module).

Sessions are **pinned with override**: a ``session`` turn prefers the
instance whose pages hold its history, but any policy (or a drain /
crash eviction) may place it elsewhere — the router then counts the
resident history as ``reprefill_tokens`` (§3.3: those prompt tokens
recompute on the new instance instead of joining shared pages).  The
accounting lives in the router, so it measures placement quality
identically over sim and real instances.

Crash handling is exactly-once: if the proxy connection to the placed
instance fails *before any response byte reached the client*, the
failure is noted in the registry (contributing to eviction) and the
request is re-placed **once** on the remaining instances.  Once bytes
have flowed, the router never resubmits — the client sees the truncated
stream and retries on its own terms (no duplicate generation).

The port's copy of ``repro.fleet.router``, the same code with its imports
moved to ``repro_torch``.
"""
from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple, Union

from repro_torch.fleet.placement import (DEFAULT_TOKEN_TIME, Placement,
                                         PlacementRequest, Placer,
                                         make_placer)
from repro_torch.fleet.registry import InstanceRegistry
from repro_torch.obs.audit import DecisionLog
from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["FleetRouter", "NoInstanceAvailable"]

#: request headers the proxy forwards upstream
_FORWARD_REQ_HEADERS = ("Content-Type",)
#: response headers the proxy forwards back verbatim
_FORWARD_RESP_HEADERS = ("Content-Type", "Retry-After")
_PROXY_PATHS = ("/v1/completions", "/v1/chat/completions")


class NoInstanceAvailable(RuntimeError):
    """No healthy, non-draining instance to place on (503 upstream)."""


class FleetRouter:
    """Route OpenAI-surface requests across instances — module docstring."""

    def __init__(self, instances: tuple = (), *,
                 placer: Union[str, Placer] = "retention_affinity",
                 host: str = "127.0.0.1", port: int = 0,
                 poll_interval: float = 1.0, poll_timeout: float = 2.0,
                 max_failures: int = 3, epsilon: float = 0.25,
                 token_time: float = DEFAULT_TOKEN_TIME,
                 audit_capacity: int = 1024,
                 request_timeout: float = 300.0):
        self.registry = InstanceRegistry(instances,
                                         poll_timeout=poll_timeout,
                                         max_failures=max_failures)
        self.placer: Placer = (make_placer(placer, token_time=token_time,
                                           epsilon=epsilon)
                               if isinstance(placer, str) else placer)
        self.poll_interval = float(poll_interval)
        self.request_timeout = float(request_timeout)
        self.audit = DecisionLog(max(1, audit_capacity))
        # placement + session state share one lock (handler threads)
        self._lock = threading.Lock()
        self._rid = 0
        self._sessions: Dict[int, str] = {}        # session -> pinned url
        self._session_tokens: Dict[int, int] = {}  # resident history est.
        self._served_tokens: Dict[str, int] = {}   # per-instance usage sum
        self._placements: Dict[str, int] = {}      # per-instance count
        self.reprefill_tokens = 0                  # migration-induced §3.3
        self._build_metrics()
        self.registry.on_evict(self._on_evict)
        self._httpd = ThreadingHTTPServer((host, port),
                                          self._handler_class())
        self.host, self.port = self._httpd.server_address[:2]
        self._http_thread: Optional[threading.Thread] = None
        self._started = False

    def _build_metrics(self) -> None:
        self.metrics = MetricsRegistry()
        self._m_requests = self.metrics.counter(
            "scls_fleet_requests", "Requests routed, by instance and "
            "outcome", labelnames=("instance", "code"))
        self._m_served = self.metrics.counter(
            "scls_fleet_served_tokens", "Prompt+completion tokens served "
            "per instance (from proxied usage)", labelnames=("instance",))
        self._m_reprefill = self.metrics.counter(
            "scls_fleet_reprefill_tokens", "Resident session history "
            "re-prefilled because a turn was placed off its pinned "
            "instance (migration cost, §3.3)")
        self._m_migrations = self.metrics.counter(
            "scls_fleet_session_migrations", "Session turns placed off "
            "their pinned instance")
        self._m_retries = self.metrics.counter(
            "scls_fleet_retries", "Requests re-placed after a proxy "
            "failure before first byte (exactly-once)")
        self._m_evictions = self.metrics.counter(
            "scls_fleet_evictions", "Instances evicted after consecutive "
            "poll/proxy failures")
        self._m_instances = self.metrics.gauge(
            "scls_fleet_instances", "Registered instances")

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "FleetRouter":
        if self._started:
            return self
        self._started = True
        # synchronous first poll: placement works before the first tick
        self.registry.poll_once()
        self.placer.observe(self.registry.placeable())
        self.registry.start(self.poll_interval)
        self._poll_observer_start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-router-listener",
            daemon=True)
        self._http_thread.start()
        return self

    def _poll_observer_start(self) -> None:
        """Feed each poll tick's placeable set to the placer (prunes
        charge-ledger rows for evicted/drained instances) and refresh
        the instance-count gauge."""
        self._observer_stop = threading.Event()

        def _loop() -> None:
            while not self._observer_stop.wait(self.poll_interval):
                with self._lock:
                    self.placer.observe(self.registry.placeable())
                self._m_instances.set(len(self.registry))

        self._observer_thread = threading.Thread(
            target=_loop, name="fleet-router-observe", daemon=True)
        self._observer_thread.start()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self.registry.stop()
        if self._started:
            self._observer_stop.set()
            self._observer_thread.join(timeout=5.0)
        if self._http_thread is not None:
            self._http_thread.join(timeout=5.0)

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.shutdown()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def _estimate_tokens(self, body: Dict[str, Any], chat: bool) -> int:
        """Prompt-size estimate for placement (whitespace words — the
        same pseudo-tokenization the instances use on strings)."""
        if chat:
            messages = body.get("messages")
            if isinstance(messages, list):
                return sum(len(str(m.get("content", "")).split())
                           for m in messages if isinstance(m, dict)) or 1
            return 1
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            return len(prompt.split()) or 1
        if isinstance(prompt, int) and not isinstance(prompt, bool):
            return max(1, prompt)
        if isinstance(prompt, list):
            return max(1, len(prompt))
        return 1

    def _place(self, body: Dict[str, Any], chat: bool,
               exclude: Optional[str] = None
               ) -> Tuple[PlacementRequest, Placement]:
        """One placement decision under the router lock; raises
        :class:`NoInstanceAvailable` when the fleet has no candidate."""
        session = body.get("session") if chat else None
        if not (isinstance(session, int) and not isinstance(session, bool)
                and session > 0):
            session = None
        max_tokens = body.get("max_tokens", 16)
        if not isinstance(max_tokens, int) or isinstance(max_tokens, bool):
            max_tokens = 16
        input_tokens = self._estimate_tokens(body, chat)
        with self._lock:
            candidates = [s for s in self.registry.placeable()
                          if s.instance != exclude]
            if not candidates:
                raise NoInstanceAvailable(
                    "no healthy instance available for placement")
            self._rid += 1
            pinned = self._sessions.get(session) if session else None
            if pinned is not None and all(s.instance != pinned
                                          for s in candidates):
                pinned = None  # pin target drained/evicted: override
            preq = PlacementRequest(
                rid=self._rid, input_tokens=input_tokens,
                max_tokens=max(1, max_tokens), session_id=session,
                pinned=pinned,
                history_tokens=self._session_tokens.get(session, 0)
                if session else 0)
            placement = self.placer.place(candidates, preq)
            migrated = False
            reprefill = 0
            if session is not None:
                prev = self._sessions.get(session)
                if prev is not None and prev != placement.instance:
                    # pinned-with-override: the move re-prefills the
                    # resident history on the new instance (§3.3)
                    migrated = True
                    reprefill = self._session_tokens.get(session, 0)
                    self.reprefill_tokens += reprefill
                self._sessions[session] = placement.instance
            self._placements[placement.instance] = \
                self._placements.get(placement.instance, 0) + 1
            self.audit.record(
                "fleet_place", time.time(), rid=preq.rid,
                policy=placement.policy, instance=placement.instance,
                session=session, pinned=pinned, migrated=migrated,
                reprefill_tokens=reprefill,
                input_tokens=preq.input_tokens,
                max_tokens=preq.max_tokens,
                loads=dict(placement.loads),
                retried_from=exclude)
        if migrated:
            self._m_migrations.inc()
            self._m_reprefill.inc(reprefill)
        return preq, placement

    def _on_complete(self, instance: str, preq: PlacementRequest,
                     usage: Optional[Dict[str, Any]]) -> None:
        with self._lock:
            self.placer.on_complete(instance, preq)
            if usage is not None:
                total = usage.get("total_tokens")
                if isinstance(total, (int, float)) and total > 0:
                    self._served_tokens[instance] = \
                        self._served_tokens.get(instance, 0) + int(total)
                    self._m_served.inc(int(total), instance=instance)
                if preq.session_id is not None:
                    # the session's resident prefix after this turn: the
                    # whole rendered conversation so far
                    self._session_tokens[preq.session_id] = \
                        int(usage.get("total_tokens", 0))

    def _on_evict(self, url: str) -> None:
        """Crash eviction: unpin every session held there — the next
        turn re-places with a deliberate re-prefill."""
        with self._lock:
            stale = [sid for sid, inst in self._sessions.items()
                     if inst == url]
            for sid in stale:
                del self._sessions[sid]
            self.audit.record("fleet_evict", time.time(), instance=url,
                              unpinned_sessions=len(stale))
        self._m_evictions.inc()

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """The ``/metrics.json`` body (what ``bench_fleet`` reads)."""
        with self._lock:
            return dict(
                placer=self.placer.name,
                n_requests=self._rid,
                placements=dict(sorted(self._placements.items())),
                served_tokens=dict(sorted(self._served_tokens.items())),
                reprefill_tokens=self.reprefill_tokens,
                migrations=int(self._m_migrations.value()),
                retries=int(self._m_retries.value()),
                evictions=int(self._m_evictions.value()),
                sessions=len(self._sessions))

    def health(self) -> Dict[str, Any]:
        records = self.registry.records()
        with self._lock:
            n_sessions = len(self._sessions)
        return dict(
            status="ok", role="router", placer=self.placer.name,
            n_instances=len(records),
            n_placeable=sum(1 for r in records if r.placeable),
            instances=[r.summary() for r in records],
            sessions=n_sessions)

    # ------------------------------------------------------------------
    # proxying
    # ------------------------------------------------------------------
    def _open_upstream(self, instance: str, path: str, body: bytes,
                       headers: Dict[str, str],
                       method: str = "POST") -> Any:
        req = urllib.request.Request(f"{instance}{path}", data=body,
                                     headers=headers, method=method)
        # 4xx/5xx must forward verbatim, not raise — catch HTTPError,
        # which quacks like an HTTPResponse (.status/.headers/.read)
        try:
            return urllib.request.urlopen(req,
                                          timeout=self.request_timeout)
        except urllib.error.HTTPError as err:
            return err

    # ------------------------------------------------------------------
    # the handler class (closure over this router)
    # ------------------------------------------------------------------
    def _handler_class(self) -> type:
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            server_version = "FleetRouter/1.0"

            def log_message(self, fmt: str, *args: Any) -> None:
                pass  # quiet CI logs (same as HTTPFrontend)

            # -- plumbing ----------------------------------------------
            def _json(self, code: int, obj: Dict[str, Any],
                      headers: Optional[Dict[str, str]] = None) -> None:
                payload = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def _error(self, code: int, message: str, etype: str,
                       headers: Optional[Dict[str, str]] = None) -> None:
                self._json(code, {"error": {"message": message,
                                            "type": etype, "code": code}},
                           headers)

            def _read_body(self) -> bytes:
                n = int(self.headers.get("Content-Length") or 0)
                return self.rfile.read(n) if n > 0 else b""

            def _query_params(self) -> Dict[str, str]:
                parts = self.path.split("?", 1)
                if len(parts) == 1:
                    return {}
                return {k: v[-1] for k, v in
                        urllib.parse.parse_qs(parts[1]).items()}

            # -- routes -------------------------------------------------
            def do_GET(self) -> None:  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    self._json(200, router.health())
                elif path == "/metrics":
                    payload = router.metrics.render().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                elif path == "/metrics.json":
                    self._json(200, router.stats())
                elif path == "/debug/placements":
                    q = self._query_params()
                    try:
                        limit = int(q["n"]) if "n" in q else None
                    except ValueError:
                        self._error(400, "n must be an integer",
                                    "invalid_request_error")
                        return
                    self._json(200, dict(
                        enabled=True, n_recorded=router.audit.n_recorded,
                        events=router.audit.query(kind=q.get("kind"),
                                                  limit=limit)))
                else:
                    self._error(404, f"no route {path}",
                                "invalid_request_error")

            def do_POST(self) -> None:  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                if path in _PROXY_PATHS:
                    self._proxy_completion(path)
                elif path in ("/fleet/join", "/fleet/drain",
                              "/fleet/leave"):
                    self._lifecycle(path)
                else:
                    self._error(404, f"no route {path}",
                                "invalid_request_error")

            def do_DELETE(self) -> None:  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                if not path.startswith("/v1/sessions/"):
                    self._error(404, f"no route {path}",
                                "invalid_request_error")
                    return
                try:
                    sid = int(path[len("/v1/sessions/"):])
                except ValueError:
                    self._error(400, "session id must be an integer",
                                "invalid_request_error")
                    return
                with router._lock:
                    pinned = router._sessions.pop(sid, None)
                    router._session_tokens.pop(sid, None)
                if pinned is None:
                    self._json(200, {"object": "session", "id": sid,
                                     "released": False})
                    return
                try:
                    resp = router._open_upstream(
                        pinned, path, b"", {}, method="DELETE")
                    resp.read()
                except OSError:
                    pass  # pin dropped either way; instance may be gone
                self._json(200, {"object": "session", "id": sid,
                                 "released": True})

            # -- instance lifecycle ------------------------------------
            def _lifecycle(self, path: str) -> None:
                try:
                    body = json.loads(self._read_body() or b"{}")
                    url = body["url"]
                except (json.JSONDecodeError, KeyError, TypeError):
                    self._error(400, "body must be JSON with a 'url'",
                                "invalid_request_error")
                    return
                try:
                    url = router.registry.normalize(url)
                except ValueError as e:
                    self._error(400, str(e), "invalid_request_error")
                    return
                if path == "/fleet/join":
                    router.registry.join(url)
                    ok = router.registry.poll_instance(url)
                    self._json(200, {"object": "fleet.join", "url": url,
                                     "healthy": ok})
                    return
                if path == "/fleet/drain":
                    known = router.registry.drain(url)
                else:  # /fleet/leave
                    known = router.registry.remove(url)
                    if known:
                        router._on_evict(url)  # unpin; count as removal
                if not known:
                    self._error(404, f"unknown instance {url}",
                                "invalid_request_error")
                    return
                if path == "/fleet/drain":
                    # draining stops placement but keeps the record; the
                    # placer must stop seeing it immediately
                    with router._lock:
                        router.placer.observe(router.registry.placeable())
                self._json(200, {"object": f"fleet.{path.rsplit('/')[-1]}",
                                 "url": url})

            # -- completion proxy --------------------------------------
            def _proxy_completion(self, path: str) -> None:
                raw = self._read_body()
                try:
                    body = json.loads(raw or b"")
                    if not isinstance(body, dict):
                        raise ValueError
                except ValueError:
                    self._error(400, "request body must be a JSON object",
                                "invalid_request_error")
                    return
                chat = path == "/v1/chat/completions"
                headers = {k: v for k in _FORWARD_REQ_HEADERS
                           if (v := self.headers.get(k))}
                headers.setdefault("Content-Type", "application/json")
                tried: Optional[str] = None
                for attempt in (0, 1):   # exactly one re-placement
                    try:
                        preq, placement = router._place(
                            body, chat, exclude=tried)
                    except NoInstanceAvailable as e:
                        self._error(503, str(e), "server_error",
                                    {"Retry-After": "1"})
                        return
                    try:
                        resp = router._open_upstream(
                            placement.instance, path, raw, headers)
                    except OSError:
                        # nothing reached the client yet: note the
                        # failure (counts toward eviction) and re-place
                        # once on the remaining instances
                        router.registry.note_failure(placement.instance)
                        tried = placement.instance
                        if attempt == 0:
                            router._m_retries.inc()
                            continue
                        self._error(502, "placed instance unreachable",
                                    "server_error")
                        return
                    self._forward(resp, placement.instance, preq)
                    return

            def _forward(self, resp: Any, instance: str,
                         preq: PlacementRequest) -> None:
                """Stream the upstream response through byte-faithfully;
                harvest usage for served-token accounting."""
                code = resp.status
                ctype = resp.headers.get("Content-Type", "")
                streaming = "text/event-stream" in ctype
                router._m_requests.inc(instance=instance, code=str(code))
                # accounting (charge release + served-token counters) must
                # land BEFORE the client can observe completion — a caller
                # that reads its response and then stats() must see this
                # request counted.  SSE: account when [DONE] arrives,
                # before forwarding it; non-stream: before the body write.
                usage: Optional[Dict[str, Any]] = None
                accounted = False
                if streaming:
                    self.send_response(code)
                    for k in _FORWARD_RESP_HEADERS:
                        v = resp.headers.get(k)
                        if v is not None:
                            self.send_header(k, v)
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    try:
                        while True:
                            line = resp.readline()
                            if not line:
                                break
                            if line.startswith(b"data: {"):
                                try:
                                    obj = json.loads(line[6:])
                                    usage = obj.get("usage") or usage
                                except ValueError:
                                    pass
                            elif (not accounted
                                  and line.startswith(b"data: [DONE]")):
                                router._on_complete(instance, preq, usage)
                                accounted = True
                            self.wfile.write(line)
                            if line == b"\n":
                                self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        pass  # client went away; instance cancels itself
                    finally:
                        resp.close()
                        if not accounted:   # truncated stream / no [DONE]
                            router._on_complete(instance, preq, usage)
                else:
                    payload = resp.read()
                    resp.close()
                    try:
                        obj = json.loads(payload)
                        if isinstance(obj, dict):
                            usage = obj.get("usage")
                    except ValueError:
                        pass
                    router._on_complete(instance, preq, usage)
                    self.send_response(code)
                    for k in _FORWARD_RESP_HEADERS:
                        v = resp.headers.get(k)
                        if v is not None:
                            self.send_header(k, v)
                    self.send_header("Content-Length",
                                     str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)

        return Handler
