"""OpenAI-compatible HTTP front end over :class:`AsyncSliceServer`.

Stdlib only (``http.server`` + threads on the wire side, the server's own
asyncio loop on the scheduling side) — no new dependencies:

  * ``POST /v1/completions`` — OpenAI completions shape: ``prompt``
    (string, token-id list, or an integer input length), ``max_tokens``,
    ``stream``; extensions: ``slo_ms`` (SLO-aware admission) and
    ``allow_degrade`` (admit with a shorter budget instead of rejecting).
    ``stream=true`` emits Server-Sent Events with **one chunk per
    completed slice** — the slice is the scheduling atom, so chunk
    boundaries are exactly the moments tokens actually materialize.
  * ``POST /v1/chat/completions`` — OpenAI chat shape: ``messages``
    (stateless role/content list) rendered through the fixed chat
    template (``repro_torch.serving.tokenizer.render_chat``) and tokenized
    with the invertible byte-level codec when the vocabulary fits.
    Extension field ``session`` (positive int) tags the request as a
    turn of a multi-turn conversation: the retain-mode real backend
    anchors the finished turn's KV pages, so the next turn's rendered
    history joins the shared prefix pages (COW, refcounted) instead of
    re-prefilling; ``DELETE /v1/sessions/<id>`` drops the anchor.
  * ``GET /healthz`` — liveness + a scheduler snapshot (strategy, worker
    count, in-flight requests, live queue depth and in-flight slice
    count from the observability gauges, free KV blocks on a paged real
    backend).
  * ``GET /metrics`` — Prometheus text exposition from the
    ``repro_torch.obs`` registry (counters/gauges/histograms; see
    ``docs/observability.md``); falls back to the legacy JSON dump when
    the server was built without a metrics registry.
  * ``GET /metrics.json`` — the legacy one-shot JSON dump (the full
    :class:`RunMetrics` row so far plus the admission counters).
  * ``GET /debug/decisions?rid=&kind=&n=`` — the scheduler decision
    audit ring (admission verdicts with their Eq. 1–2/10–11 inputs,
    ``dp_batch`` compositions, offloader placements with decision-time
    Eq. 11 loads).
  * Admission rejections map to **429** with a ``Retry-After`` header
    derived from the predicted queue delay (converted to wall seconds
    when the server is paced).

Threading model: handler threads never touch the scheduler — every
operation is shipped to the server's event loop with
``asyncio.run_coroutine_threadsafe`` and the core stays single-threaded
(the AsyncSliceServer invariant).  Streaming iterates the handle's
``slices()`` async generator one ``__anext__`` at a time from the handler
thread, so a slow client only blocks its own thread, never the pacer.

There is no tokenizer in this reproduction: string prompts are
pseudo-tokenized (one id per whitespace word, stable hashing into the
vocabulary) and completions are rendered as space-joined token ids.  The
scheduling, admission, streaming, and cancellation paths are the real
thing; only the text codec is a stand-in.

The port's copy of ``repro.serving.http``, the same code with its imports
moved to ``repro_torch``.
"""
from __future__ import annotations

import asyncio
import json
import math
import threading
import time
import urllib.parse
import zlib
from concurrent.futures import TimeoutError as FuturesTimeout
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Coroutine, Dict, List, Optional

import numpy as np

from repro_torch.serving.admission import (AdmissionRejected,
                                           predicted_queue_delay)
from repro_torch.serving.aio import AsyncRequestHandle, AsyncSliceServer
from repro_torch.serving.backends import RealBackend, SimBackend
from repro_torch.serving.tokenizer import for_vocab, render_chat

#: default bound on request bodies (1 MiB of JSON is plenty for prompts)
MAX_BODY_BYTES = 1 << 20


class _BadRequest(ValueError):
    pass


def encode_prompt(prompt: Any, vocab_size: int) -> Dict[str, Any]:
    """Normalize the OpenAI ``prompt`` field into submit() kwargs.

    Strings are pseudo-tokenized one id per whitespace word (stable CRC32
    hash into the vocabulary — there is no tokenizer in this repo);
    integer lists are taken as token ids; a bare integer is an input
    length (load-generator extension).  On the sim backend
    (``vocab_size == 0``) only the length matters.
    """
    if isinstance(prompt, bool):
        raise _BadRequest("prompt must be a string, token-id list, or length")
    if isinstance(prompt, str):
        words = prompt.split() or [prompt or "?"]
        if vocab_size > 0:
            ids = [zlib.crc32(w.encode()) % vocab_size for w in words]
            return dict(prompt=np.asarray(ids, np.int32))
        return dict(input_len=len(words))
    if isinstance(prompt, int):
        if prompt <= 0:
            raise _BadRequest(f"prompt length must be positive, got {prompt}")
        if vocab_size > 0:
            # a real backend needs actual token ids, not just a length —
            # synthesize deterministic filler so load generators can still
            # say "a prompt of N tokens"
            return dict(prompt=(np.arange(prompt, dtype=np.int64)
                                * 2654435761 % vocab_size).astype(np.int32))
        return dict(input_len=prompt)
    if isinstance(prompt, list):
        if not prompt or not all(isinstance(t, int) and not isinstance(t, bool)
                                 for t in prompt):
            raise _BadRequest("prompt list must be non-empty token ids")
        if vocab_size > 0:
            return dict(prompt=np.asarray(prompt, np.int32) % vocab_size)
        return dict(input_len=len(prompt))
    raise _BadRequest(f"unsupported prompt type {type(prompt).__name__}")


def _detok(tokens: List[int]) -> str:
    """Debug detokenization: space-joined token ids."""
    return "".join(f" {t}" for t in tokens)


class HTTPFrontend:
    """Serve an :class:`AsyncSliceServer` over HTTP — module docstring."""

    def __init__(self, server: AsyncSliceServer, host: str = "127.0.0.1",
                 port: int = 0, model_name: str = "scls",
                 vocab_size: int = 0, request_timeout: float = 300.0):
        self.aserver = server
        self.model_name = model_name
        self.vocab_size = int(vocab_size)
        self.tokenizer = for_vocab(self.vocab_size)
        self.request_timeout = float(request_timeout)
        self._loop = asyncio.new_event_loop()
        self._loop_thread: Optional[threading.Thread] = None
        self._http_thread: Optional[threading.Thread] = None
        self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self.host, self.port = self._httpd.server_address[:2]
        self._started = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "HTTPFrontend":
        """Start the scheduler loop thread and the HTTP listener."""
        if self._started:
            return self
        self._started = True
        self._loop_thread = threading.Thread(
            target=self._run_loop, name="slice-http-loop", daemon=True)
        self._loop_thread.start()
        self._call(self._start_pacer())  # pacer lives on the loop thread
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="slice-http-listener",
            daemon=True)
        self._http_thread.start()
        return self

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = 60.0) -> None:
        """Stop accepting connections, optionally drain in-flight work,
        and stop the scheduler loop."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._loop_thread is not None and self._loop_thread.is_alive():
            try:
                fut = asyncio.run_coroutine_threadsafe(
                    self._shutdown_async(drain), self._loop)
                fut.result(timeout)
            finally:
                self._loop.call_soon_threadsafe(self._loop.stop)
                self._loop_thread.join(timeout=5.0)
        if self._http_thread is not None:
            self._http_thread.join(timeout=5.0)

    def __enter__(self) -> "HTTPFrontend":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.shutdown(drain=exc == (None, None, None))

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _run_loop(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()

    async def _start_pacer(self) -> None:
        self.aserver._ensure_running()

    async def _shutdown_async(self, drain: bool) -> None:
        self.aserver._closed = True  # refuse new submissions first
        if drain:
            while self.aserver.core._events \
                    and self.aserver._pacer_exc is None:
                self.aserver._idle.clear()
                await self.aserver._idle.wait()
        if self.aserver._task is not None:
            self.aserver._task.cancel()
            try:
                await self.aserver._task
            except asyncio.CancelledError:
                pass
            self.aserver._task = None

    def _call(self, coro: Coroutine[Any, Any, Any],
              timeout: Optional[float] = None) -> Any:
        """Run ``coro`` on the scheduler loop from a handler thread."""
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result(self.request_timeout if timeout is None else timeout)

    # ------------------------------------------------------------------
    # scheduler-side coroutines (everything that touches the core)
    # ------------------------------------------------------------------
    async def _submit(self, kw: Dict[str, Any]) -> AsyncRequestHandle:
        return self.aserver.submit(**kw)

    async def _snapshot(self) -> Dict[str, Any]:
        core = self.aserver.core
        in_flight = sum(1 for h in self.aserver._handles.values()
                        if not h.finished)
        snap = dict(status="ok", model=self.model_name,
                    strategy=core.s.name, workers=core.n_workers,
                    backend=type(core.backend).__name__,
                    now=core.now, in_flight=in_flight,
                    **self.aserver.admission_stats)
        # live load signals, sourced from the same gauges the registry
        # exports at /metrics (the fleet-router placement inputs); fall
        # back to reading the scheduler directly when obs is off
        if core.obs.ins is not None:
            snap["queue_depth"] = int(core.obs.ins.queue_depth.value())
            snap["in_flight_slices"] = int(core.obs.ins.in_flight.value())
        else:
            snap["queue_depth"] = len(core.pool) + sum(
                len(w.pending) + sum(b.size for b in w.queue)
                for w in core.workers)
            snap["in_flight_slices"] = sum(1 for w in core.workers if w.busy)
        # the full placement-input vector the fleet router's
        # InstanceSnapshot parses (repro_torch.fleet.registry): the Eq. 11
        # per-worker loads and the Eq. 10–11 predicted queue delay the
        # admission controller itself uses, plus memory/session
        # residency for the retention_affinity migration-cost term
        loads = core.offloader.snapshot()
        snap["worker_loads"] = [loads[w] for w in sorted(loads)]
        snap["min_load"] = core.offloader.min_load()
        snap["queue_delay_est"] = predicted_queue_delay(core)
        anchors = getattr(core.backend, "_session_anchor", None)
        snap["n_sessions"] = len(anchors) if anchors is not None else 0
        if core.obs.ins is not None:
            snap["shared_blocks"] = int(core.obs.ins.shared_blocks.value())
        if isinstance(core.backend, RealBackend) \
                and core.backend.allocators is not None:
            snap["free_blocks"] = core.backend.free_blocks()
            snap["kv_retain"] = core.backend.kv_retain
            if core.backend.kv_retain == "request":
                # prefix pages resident across slices (reclaimable on
                # demand — see PagedMemoryEstimator.retained_blocks)
                snap["retained_blocks"] = [a.used_blocks
                                           for a in core.backend.allocators]
        return snap

    async def _metrics(self) -> Dict[str, Any]:
        m = asdict(self.aserver.metrics())
        m.update(self.aserver.admission_stats)
        return m

    async def _metrics_text(self) -> Optional[str]:
        """Prometheus text exposition, or None when the server was built
        without a metrics registry (legacy JSON keeps serving /metrics)."""
        registry = self.aserver.core.obs.registry
        return None if registry is None else registry.render()

    async def _decisions(self, rid: Optional[int], kind: Optional[str],
                         limit: Optional[int]) -> Dict[str, Any]:
        audit = self.aserver.core.obs.audit
        if audit is None:
            return dict(enabled=False, events=[])
        events = audit.query(rid=rid, kind=kind, limit=limit)
        return dict(enabled=True, n_recorded=audit.n_recorded,
                    capacity=audit.capacity, events=events)

    # ------------------------------------------------------------------
    # request parsing / response shaping
    # ------------------------------------------------------------------
    def _gen_opts(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """The generation/admission knobs shared by both POST endpoints."""
        kw: Dict[str, Any] = {}
        max_tokens = body.get("max_tokens", 16)
        if not isinstance(max_tokens, int) or isinstance(max_tokens, bool) \
                or max_tokens <= 0:
            raise _BadRequest(f"max_tokens must be a positive integer, "
                              f"got {max_tokens!r}")
        kw["max_gen"] = max_tokens
        slo_ms = body.get("slo_ms")
        if slo_ms is not None:
            if not isinstance(slo_ms, (int, float)) or slo_ms <= 0:
                raise _BadRequest(f"slo_ms must be a positive number, "
                                  f"got {slo_ms!r}")
            kw["slo_ms"] = float(slo_ms)
        kw["allow_degrade"] = bool(body.get("allow_degrade", False))
        return kw

    def _parse_completion(self, body: Dict[str, Any]) -> Dict[str, Any]:
        if "prompt" not in body:
            raise _BadRequest("missing required field 'prompt'")
        kw = encode_prompt(body["prompt"], self.vocab_size)
        kw.update(self._gen_opts(body))
        return kw

    def _parse_chat(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """``/v1/chat/completions``: render the stateless OpenAI message
        list through the fixed chat template and tokenize.  The
        ``session`` extension field tags the request so the retain-mode
        real backend anchors its pages — the next turn of the same
        session (whose rendered prompt extends this one) then joins the
        shared prefix pages instead of re-prefilling the history."""
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise _BadRequest("messages must be a non-empty list")
        try:
            text = render_chat(messages)
        except ValueError as e:
            raise _BadRequest(str(e)) from None
        if self.tokenizer is not None:
            kw: Dict[str, Any] = dict(
                prompt=np.asarray(self.tokenizer.encode(text), np.int32))
        else:  # length-only sim backend
            kw = dict(input_len=max(1, len(text.split())))
        kw.update(self._gen_opts(body))
        session = body.get("session")
        if session is not None:
            if not isinstance(session, int) or isinstance(session, bool) \
                    or session <= 0:
                raise _BadRequest(f"session must be a positive integer, "
                                  f"got {session!r}")
            kw["session_id"] = session
        return kw

    def _decode_text(self, tokens: List[int]) -> str:
        """Completion text: real detokenization when the codec round-trips,
        else the debug space-joined ids."""
        if self.tokenizer is not None and self.tokenizer.invertible:
            return self.tokenizer.decode(tokens)
        return _detok(tokens)

    def _completion_obj(self, handle: AsyncRequestHandle, text: str,
                        finish_reason: Optional[str],
                        usage: bool = False) -> Dict[str, Any]:
        obj: Dict[str, Any] = dict(
            id=f"cmpl-{handle.rid}", object="text_completion",
            created=int(time.time()), model=self.model_name,
            choices=[dict(index=0, text=text, logprobs=None,
                          finish_reason=finish_reason)])
        if usage:
            req = handle.request
            obj["usage"] = dict(prompt_tokens=req.input_len,
                                completion_tokens=req.generated,
                                total_tokens=req.input_len + req.generated)
        return obj

    def _chat_obj(self, handle: AsyncRequestHandle, content: str,
                  finish_reason: Optional[str], usage: bool = False,
                  chunk: bool = False) -> Dict[str, Any]:
        if chunk:
            delta = dict(role="assistant", content=content) if content else {}
            choice = dict(index=0, delta=delta, finish_reason=finish_reason)
            obj_type = "chat.completion.chunk"
        else:
            choice = dict(index=0,
                          message=dict(role="assistant", content=content),
                          finish_reason=finish_reason)
            obj_type = "chat.completion"
        obj: Dict[str, Any] = dict(
            id=f"chatcmpl-{handle.rid}", object=obj_type,
            created=int(time.time()), model=self.model_name,
            choices=[choice])
        if usage:
            req = handle.request
            obj["usage"] = dict(prompt_tokens=req.input_len,
                                completion_tokens=req.generated,
                                total_tokens=req.input_len + req.generated)
        if handle.request.session_id is not None:
            obj["session"] = handle.request.session_id
        return obj

    def _finish_reason(self, handle: AsyncRequestHandle) -> str:
        if handle.cancelled:
            return "cancelled"
        req = handle.request
        if req.gen_len is None and req.generated < req.max_gen:
            return "stop"    # the model's own EOS ended the stream
        return "length"

    def _retry_after_s(self, exc: AdmissionRejected) -> float:
        ra = exc.decision.retry_after or 1.0
        scale = self.aserver._time_scale
        if scale is not None:
            # core seconds -> wall seconds, the same mapping the pacer
            # applies to submissions; a paced run legitimately suggests
            # sub-second wall backoffs, so don't floor them to 1 —
            # clamp to 1 ms and keep millisecond resolution instead
            return round(max(ra / scale, 1e-3), 3)
        if isinstance(self.aserver.core.backend, SimBackend):
            # unpaced sim: virtual backlog clears in ~zero wall time, so
            # a virtual-seconds header would over-throttle clients
            ra = 1.0
        return max(1, math.ceil(ra))

    # ------------------------------------------------------------------
    # the handler class (closure over this frontend)
    # ------------------------------------------------------------------
    def _handler_class(self) -> type:
        front = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            server_version = "SliceServer/1.0"

            def log_message(self, fmt, *args):  # noqa: D102 — quiet CI logs
                pass

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
                self._json(code, {"error": {"message": message, "type": etype,
                                            "code": code}}, headers)

            def _read_body(self) -> Dict[str, Any]:
                n = int(self.headers.get("Content-Length") or 0)
                if n <= 0:
                    raise _BadRequest("empty request body")
                if n > MAX_BODY_BYTES:
                    raise _BadRequest(f"request body exceeds "
                                      f"{MAX_BODY_BYTES} bytes")
                try:
                    body = json.loads(self.rfile.read(n))
                except json.JSONDecodeError as e:
                    raise _BadRequest(f"invalid JSON: {e}") from None
                if not isinstance(body, dict):
                    raise _BadRequest("request body must be a JSON object")
                return body

            def _text(self, code: int, body: str, content_type: str) -> None:
                payload = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

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
                    self._json(200, front._call(front._snapshot()))
                elif path == "/metrics":
                    text = front._call(front._metrics_text())
                    if text is None:  # no registry: legacy JSON dump
                        self._json(200, front._call(front._metrics()))
                    else:
                        self._text(200, text,
                                   "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/metrics.json":
                    self._json(200, front._call(front._metrics()))
                elif path == "/debug/decisions":
                    q = self._query_params()
                    try:
                        rid = int(q["rid"]) if "rid" in q else None
                        limit = int(q["n"]) if "n" in q else None
                    except ValueError:
                        self._error(400, "rid and n must be integers",
                                    "invalid_request_error")
                        return
                    self._json(200, front._call(
                        front._decisions(rid, q.get("kind"), limit)))
                elif path == "/v1/models":
                    # the reference's body, owner included: a client sees
                    # one API whichever package serves it
                    self._json(200, {"object": "list", "data": [
                        {"id": front.model_name, "object": "model",
                         "owned_by": "repro.serving"}]})
                else:
                    self._error(404, f"no route {path}", "invalid_request_error")

            def do_POST(self) -> None:  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                if path not in ("/v1/completions", "/v1/chat/completions"):
                    self._error(404, f"no route {path}", "invalid_request_error")
                    return
                chat = path == "/v1/chat/completions"
                try:
                    body = self._read_body()
                    kw = (front._parse_chat(body) if chat
                          else front._parse_completion(body))
                except _BadRequest as e:
                    self._error(400, str(e), "invalid_request_error")
                    return
                stream = bool(body.get("stream", False))
                try:
                    handle = front._call(front._submit(kw))
                except AdmissionRejected as e:
                    self._error(
                        429, str(e), "rate_limit_exceeded",
                        {"Retry-After": str(front._retry_after_s(e))})
                    return
                except RuntimeError as e:  # server closed / draining
                    self._error(503, str(e), "server_error",
                                {"Retry-After": "1"})
                    return
                if stream:
                    self._stream(handle, chat)
                else:
                    self._complete(handle, chat)

            def do_DELETE(self) -> None:  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                if not path.startswith("/v1/sessions/"):
                    self._error(404, f"no route {path}", "invalid_request_error")
                    return
                try:
                    sid = int(path[len("/v1/sessions/"):])
                except ValueError:
                    self._error(400, "session id must be an integer",
                                "invalid_request_error")
                    return
                front._call(front._release_session(sid))
                self._json(200, {"object": "session", "id": sid,
                                 "released": True})

            # -- completion bodies -------------------------------------
            def _body_obj(self, chat: bool, handle: AsyncRequestHandle,
                          text: str, finish_reason: Optional[str],
                          usage: bool = False,
                          chunk: bool = False) -> Dict[str, Any]:
                if chat:
                    return front._chat_obj(handle, text, finish_reason,
                                           usage=usage, chunk=chunk)
                return front._completion_obj(handle, text, finish_reason,
                                             usage=usage)

            def _complete(self, handle: AsyncRequestHandle,
                          chat: bool = False) -> None:
                try:
                    front._call(handle.result())
                except FuturesTimeout:
                    # stop spending slices on a response nobody will get
                    front._call(front._cancel(handle))
                    self._error(504, "request timed out", "server_error")
                    return
                text = (front._decode_text(handle.output_tokens) if chat
                        else _detok(handle.output_tokens))
                self._json(200, self._body_obj(
                    chat, handle, text, front._finish_reason(handle),
                    usage=True))

            def _stream(self, handle: AsyncRequestHandle,
                        chat: bool = False) -> None:
                """SSE: one ``data:`` chunk per completed slice."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                agen = handle.slices()
                try:
                    while True:
                        try:
                            chunk = front._call(agen.__anext__())
                        except StopAsyncIteration:
                            break
                        text = (front._decode_text(chunk) if chat
                                else _detok(chunk))
                        obj = self._body_obj(chat, handle, text, None,
                                             chunk=True)
                        self.wfile.write(b"data: " + json.dumps(obj).encode()
                                         + b"\n\n")
                        self.wfile.flush()
                    final = self._body_obj(
                        chat, handle, "", front._finish_reason(handle),
                        usage=True, chunk=True)
                    self.wfile.write(b"data: " + json.dumps(final).encode()
                                     + b"\n\n")
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError,
                        FuturesTimeout):
                    # client went away (or stalled past the timeout)
                    # mid-stream: cancel so the scheduler stops spending
                    # slices on it (next boundary frees the page envelope)
                    front._call(front._cancel(handle))

        return Handler

    async def _release_session(self, session_id: int) -> None:
        self.aserver.release_session(session_id)

    async def _cancel(self, handle: AsyncRequestHandle) -> bool:
        return handle.cancel()
