"""The port's OpenAI-compatible HTTP front end (``repro_torch.serving.http``)
and its tokenizer against the JAX package's.

Every case of ``tests/test_http.py`` and the chat half of
``tests/test_sessions.py`` runs once against a JAX ``HTTPFrontend`` and once
against the port's, over the same sim ``ServingConfig``; a scripted session
through every endpoint gets equal JSON bodies from both (ids, ``created``
times and wall-clock fields aside); ``encode_prompt``, ``for_vocab`` and
``render_chat`` agree on seeded inputs; and on the reduced float32
llama3.2-1b (paged, ``kv_retain="request"``, pages of 4 and of 32, the
JAX weights carried over by ``repro_torch.weights.params_from_jax``) three
chat turns with ``session`` give JAX's tokens.  Every server listens on an
ephemeral port and every client call has a timeout.
"""
import http.client
import importlib
import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest

from torch_port import assert_same_stream, shared_models

SLICE = 8
PKGS = ("repro", "repro_torch")
#: seconds a client waits for one response
TIMEOUT = 60


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _sim_server(pkg, **kw):
    cfg = dict(strategy="scls", workers=2, slice_len=SLICE, gamma=0.25)
    cfg.update(kw)
    return _mod(pkg, "serving").ServingConfig(**cfg).build_sim()


@pytest.fixture(scope="module", params=PKGS)
def frontend(request):
    server = _sim_server(request.param)
    front = _mod(request.param, "serving").HTTPFrontend(
        server.aio, port=0, model_name="scls-sim").start()
    yield front
    front.shutdown()


def _request(front, method, path, body=None):
    conn = http.client.HTTPConnection(front.host, front.port,
                                      timeout=TIMEOUT)
    headers = {"Content-Type": "application/json"} if body is not None else {}
    conn.request(method, path,
                 json.dumps(body) if body is not None else None, headers)
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp, raw


def _post(url, path, body):
    req = urllib.request.Request(url + path, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return json.loads(resp.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=TIMEOUT) as resp:
        return json.loads(resp.read())


def _validate_obs():
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "validate_obs_torch_http",
        pathlib.Path(__file__).parent.parent / "scripts" / "validate_obs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the cases of tests/test_http.py, on both packages
# ---------------------------------------------------------------------------
def test_healthz_and_models(frontend):
    resp, raw = _request(frontend, "GET", "/healthz")
    assert resp.status == 200
    snap = json.loads(raw)
    assert snap["status"] == "ok" and snap["strategy"] == "SCLS"
    assert snap["backend"] == "SimBackend" and snap["workers"] == 2
    assert isinstance(snap["queue_depth"], int) and snap["queue_depth"] >= 0
    assert isinstance(snap["in_flight_slices"], int)
    assert 0 <= snap["in_flight_slices"] <= snap["workers"]
    resp, raw = _request(frontend, "GET", "/v1/models")
    assert resp.status == 200
    assert json.loads(raw)["data"][0]["id"] == "scls-sim"


def test_completion_non_streamed(frontend):
    resp, raw = _request(frontend, "POST", "/v1/completions",
                         {"model": "scls-sim",
                          "prompt": "tell me about slice level scheduling",
                          "max_tokens": 20})
    assert resp.status == 200
    out = json.loads(raw)
    assert out["object"] == "text_completion"
    choice = out["choices"][0]
    assert choice["finish_reason"] == "length"
    assert [int(t) for t in choice["text"].split()] == list(range(20))
    assert out["usage"] == {"prompt_tokens": 6, "completion_tokens": 20,
                            "total_tokens": 26}


def test_sse_emits_one_chunk_per_completed_slice(frontend):
    max_tokens = 40
    resp, raw = _request(frontend, "POST", "/v1/completions",
                         {"prompt": "stream this", "max_tokens": max_tokens,
                          "stream": True})
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    events = [e[len("data: "):] for e in raw.decode().split("\n\n")
              if e.startswith("data: ")]
    assert events[-1] == "[DONE]"
    final = json.loads(events[-2])
    assert final["choices"][0]["finish_reason"] == "length"
    content = [json.loads(e) for e in events[:-2]]
    assert len(content) >= math.ceil(max_tokens / SLICE)
    toks = [int(t) for c in content for t in c["choices"][0]["text"].split()]
    assert toks == list(range(max_tokens))
    assert all(len(c["choices"][0]["text"].split()) <= SLICE
               for c in content)


def test_unmeetable_slo_rejected_with_429_before_any_work(frontend):
    core = frontend.aserver.core
    n_requests_before = len(core.requests)
    batches_before = len(core.batch_log)
    resp, raw = _request(frontend, "POST", "/v1/completions",
                         {"prompt": 512, "max_tokens": 900, "slo_ms": 1})
    assert resp.status == 429
    assert int(resp.getheader("Retry-After")) >= 1
    err = json.loads(raw)["error"]
    assert err["type"] == "rate_limit_exceeded"
    assert "deadline" in err["message"]
    assert len(core.requests) == n_requests_before
    assert len(core.batch_log) == batches_before
    resp, raw = _request(frontend, "GET", "/metrics.json")
    m = json.loads(raw)
    assert m["n_rejected"] >= 1
    assert m["reject_reasons"].get("deadline", 0) >= 1


def test_healthz_exports_fleet_placement_vector(frontend):
    resp, raw = _request(frontend, "GET", "/healthz")
    snap = json.loads(raw)
    assert len(snap["worker_loads"]) == snap["workers"]
    assert all(isinstance(x, float) and x >= 0
               for x in snap["worker_loads"])
    assert snap["min_load"] == min(snap["worker_loads"])
    assert isinstance(snap["queue_delay_est"], float)
    assert snap["queue_delay_est"] >= snap["min_load"]
    assert snap["n_sessions"] == 0
    assert snap["shared_blocks"] == 0
    assert snap["n_submitted"] >= 0 and snap["n_rejected"] >= 0


@pytest.mark.parametrize("pkg", PKGS)
def test_paced_retry_after_keeps_subsecond_hints(pkg):
    server = _sim_server(pkg, time_scale=1000.0)
    front = _mod(pkg, "serving").HTTPFrontend(server.aio, port=0).start()
    try:
        resp, raw = _request(front, "POST", "/v1/completions",
                             {"prompt": 512, "max_tokens": 900,
                              "slo_ms": 1})
        assert resp.status == 429
        ra = float(resp.getheader("Retry-After"))
        assert 0 < ra < 1
    finally:
        front.shutdown()


def test_meetable_slo_accepted(frontend):
    resp, raw = _request(frontend, "POST", "/v1/completions",
                         {"prompt": "quick one", "max_tokens": 8,
                          "slo_ms": 600_000})
    assert resp.status == 200
    assert json.loads(raw)["usage"]["completion_tokens"] == 8


#: request bodies every endpoint must answer with 400
BAD_COMPLETIONS = ({}, {"prompt": "x", "max_tokens": 0},
                   {"prompt": "x", "max_tokens": "lots"},
                   {"prompt": True}, {"prompt": []},
                   {"prompt": "x", "slo_ms": -5})


def test_bad_requests_get_400_not_500(frontend):
    for body in BAD_COMPLETIONS:
        resp, raw = _request(frontend, "POST", "/v1/completions", body)
        assert resp.status == 400, body
        assert json.loads(raw)["error"]["type"] == "invalid_request_error"
    resp, _ = _request(frontend, "GET", "/nope")
    assert resp.status == 404
    resp, raw = _request(frontend, "POST", "/v1/chat/completions",
                         {"prompt": "x"})
    assert resp.status == 400
    assert json.loads(raw)["error"]["type"] == "invalid_request_error"


def test_metrics_json_endpoint_reports_run_metrics(frontend):
    resp, raw = _request(frontend, "GET", "/metrics.json")
    assert resp.status == 200
    m = json.loads(raw)
    for key in ("n_completed", "throughput", "ttft_mean", "p99_response",
                "slo_attainment", "n_rejected", "n_submitted",
                "reprefill_tokens", "n_rejected_memory",
                "n_rejected_deadline"):
        assert key in m
    assert m["n_completed"] >= 1


def test_metrics_endpoint_serves_prometheus_text(frontend):
    resp, raw = _request(frontend, "GET", "/metrics")
    assert resp.status == 200
    assert resp.getheader("Content-Type").startswith("text/plain")
    assert "version=0.0.4" in resp.getheader("Content-Type")
    text = raw.decode()
    vo = _validate_obs()
    assert vo.validate_prometheus(text) == []
    fams = vo.parse_prometheus(text)
    assert fams["scls_slices_dispatched_total"]["samples"][
        "scls_slices_dispatched_total"] >= 1
    assert fams["scls_requests_total"]["type"] == "counter"
    assert any(k.startswith("scls_ttft_seconds_bucket")
               for k in fams["scls_ttft_seconds"]["samples"])
    assert fams["scls_admission_total"]["samples"][
        'scls_admission_total{action="reject",reason="deadline"}'] >= 1


def test_debug_decisions_endpoint(frontend):
    resp, raw = _request(frontend, "GET", "/debug/decisions")
    assert resp.status == 200
    out = json.loads(raw)
    assert out["enabled"] and out["n_recorded"] >= 1
    kinds = {e["kind"] for e in out["events"]}
    assert kinds <= {"admission", "batch", "offload"}
    assert {"batch", "offload"} <= kinds
    resp, raw = _request(frontend, "GET", "/debug/decisions?kind=batch&n=2")
    batches = json.loads(raw)["events"]
    assert len(batches) <= 2
    assert all(e["kind"] == "batch" for e in batches)
    rid = batches[-1]["rids"][0]
    resp, raw = _request(frontend, "GET", f"/debug/decisions?rid={rid}")
    mine = json.loads(raw)["events"]
    assert mine and all(e.get("rid") == rid or rid in e.get("rids", [])
                        for e in mine)
    resp, _ = _request(frontend, "GET", "/debug/decisions?rid=abc")
    assert resp.status == 400


@pytest.mark.parametrize("pkg", PKGS)
def test_encode_prompt_shapes(pkg):
    http_mod = _mod(pkg, "serving.http")
    encode_prompt, bad = http_mod.encode_prompt, http_mod._BadRequest
    assert encode_prompt("three word prompt", 0) == {"input_len": 3}
    assert encode_prompt(17, 0) == {"input_len": 17}
    filler = encode_prompt(7, 100)["prompt"]
    assert filler.shape == (7,) and 0 <= filler.min() <= filler.max() < 100
    out = encode_prompt("hash these words", 1000)
    assert out["prompt"].shape == (3,) and out["prompt"].max() < 1000
    assert list(encode_prompt([5, 6, 7], 4)["prompt"]) == [1, 2, 3]
    for prompt in (0, [1, "a"], {"not": "supported"}):
        with pytest.raises(bad):
            encode_prompt(prompt, 0)


# ---------------------------------------------------------------------------
# the chat half of tests/test_sessions.py, on both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", PKGS)
def test_http_chat_completions_sim(pkg):
    serving = _mod(pkg, "serving")
    true_lat, est, mem = serving.default_sim_environment("hf")
    server = serving.ServingConfig(strategy="scls", workers=2, max_gen=16,
                                   slice_len=8).build_sim(true_lat, est, mem)
    with serving.HTTPFrontend(server.aio, port=0, vocab_size=512) as front:
        msgs = [{"role": "user", "content": "hello there"}]
        r = _post(front.url, "/v1/chat/completions",
                  dict(messages=msgs, max_tokens=6, session=7))
        assert r["object"] == "chat.completion"
        assert r["choices"][0]["message"]["role"] == "assistant"
        assert r["choices"][0]["finish_reason"] in ("stop", "length")
        assert r["session"] == 7
        assert r["usage"]["completion_tokens"] > 0
        req = urllib.request.Request(
            front.url + "/v1/chat/completions",
            json.dumps(dict(messages=msgs, max_tokens=4,
                            stream=True)).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            lines = [ln for ln in resp.read().decode().splitlines()
                     if ln.startswith("data: ")]
        assert lines[-1] == "data: [DONE]"
        first = json.loads(lines[0][len("data: "):])
        assert first["object"] == "chat.completion.chunk"
        assert "content" in first["choices"][0]["delta"]
        dreq = urllib.request.Request(front.url + "/v1/sessions/7",
                                      method="DELETE")
        with urllib.request.urlopen(dreq, timeout=TIMEOUT) as resp:
            assert json.loads(resp.read())["released"]
        for body in (dict(messages=[]),
                     dict(messages=[{"role": "user"}]),
                     dict(messages=msgs, session=0),
                     dict(messages=msgs, max_tokens=0)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(front.url, "/v1/chat/completions", body)
            assert ei.value.code == 400


@pytest.mark.parametrize("pkg", PKGS)
def test_chat_tokenizer_round_trip_and_template_prefix_stability(pkg):
    tk = _mod(pkg, "serving.tokenizer")
    bt = tk.for_vocab(512)
    assert isinstance(bt, tk.ByteTokenizer) and bt.invertible
    text = "hello été"
    assert bt.decode(bt.encode(text)) == text
    assert min(bt.encode(text)) >= 2
    assert bt.decode([0, 1, 300] + bt.encode("ok")) == "ok"
    ht = tk.for_vocab(64)
    assert isinstance(ht, tk.HashTokenizer) and not ht.invertible
    assert ht.encode("a b") == ht.encode("a  b")
    assert tk.for_vocab(0) is None
    with pytest.raises(ValueError):
        tk.ByteTokenizer(100)
    msgs = [{"role": "user", "content": "hi"}]
    r1 = tk.render_chat(msgs)
    msgs += [{"role": "assistant", "content": "yo"},
             {"role": "user", "content": "more"}]
    r2 = tk.render_chat(msgs)
    assert r2.startswith(r1[:-len("<|assistant|>\n")])
    assert r2.startswith(tk.render_chat(msgs[:2],
                                        add_generation_prompt=False))
    for bad in ([{"role": "", "content": "x"}],
                [{"role": "user", "content": 3}]):
        with pytest.raises(ValueError):
            tk.render_chat(bad)


# ---------------------------------------------------------------------------
# the port equals the JAX package
# ---------------------------------------------------------------------------
def _seeded_texts(seed=0, n=12):
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefgh ij\tklmn\nopé€z") + ["  ", "日本"]
    return ["".join(rng.choice(alphabet, size=int(rng.integers(0, 40))))
            for _ in range(n)]


def test_tokenizer_and_prompt_codec_equal_jax():
    """``encode_prompt``, ``for_vocab`` (both codecs, encode and decode)
    and ``render_chat`` give JAX's results on seeded inputs."""
    rng = np.random.default_rng(1)
    texts = _seeded_texts()
    for vocab in (0, 64, 300, 512, 128256):
        want = _mod("repro", "serving.tokenizer").for_vocab(vocab)
        got = _mod("repro_torch", "serving.tokenizer").for_vocab(vocab)
        assert type(got).__name__ == type(want).__name__
        if want is None:
            assert got is None
            continue
        assert got.invertible == want.invertible
        for text in texts:
            ids = want.encode(text)
            assert got.encode(text) == ids
            noisy = ids + [int(t) for t in rng.integers(0, vocab, size=5)]
            assert got.decode(noisy) == want.decode(noisy)
    for seed in range(4):
        srng = np.random.default_rng(seed)
        roles = ["system", "user", "assistant", "tool"]
        msgs = [{"role": str(srng.choice(roles)), "content": t}
                for t in _seeded_texts(seed, n=int(srng.integers(1, 6)))]
        for gen_prompt in (True, False):
            assert _mod("repro_torch", "serving.tokenizer").render_chat(
                msgs, gen_prompt) == _mod(
                    "repro", "serving.tokenizer").render_chat(msgs,
                                                              gen_prompt)
    prompts = texts + [int(n) for n in rng.integers(1, 3000, size=6)] + [
        [int(t) for t in rng.integers(0, 10 ** 6, size=int(k))]
        for k in rng.integers(1, 20, size=6)]
    for vocab in (0, 100, 32000, 128256):
        for prompt in prompts:
            want = _mod("repro", "serving.http").encode_prompt(prompt, vocab)
            got = _mod("repro_torch", "serving.http").encode_prompt(prompt,
                                                                    vocab)
            assert got.keys() == want.keys()
            for k in want:
                assert np.array_equal(np.asarray(got[k]),
                                      np.asarray(want[k])), (prompt, vocab)
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype


#: keys of a response body that name the call rather than its result
_VOLATILE = ("id", "created")


def _normalize(obj):
    if isinstance(obj, dict):
        return {k: _normalize(v) for k, v in obj.items()
                if k not in _VOLATILE}
    if isinstance(obj, list):
        return [_normalize(v) for v in obj]
    return obj


def _parsed(resp, raw):
    """(status, Retry-After, normalized body) of one response: JSON, SSE
    events (each JSON but the last), or text."""
    ctype = resp.getheader("Content-Type") or ""
    text = raw.decode()
    if ctype.startswith("application/json"):
        body = _normalize(json.loads(text))
    elif ctype == "text/event-stream":
        events = [e[len("data: "):] for e in text.split("\n\n")
                  if e.startswith("data: ")]
        body = [_normalize(json.loads(e)) for e in events[:-1]] + \
            events[-1:]
    else:
        body = text
    return resp.status, resp.getheader("Retry-After"), body


#: a session through every endpoint: (method, path, body)
SCRIPT = (
    ("GET", "/healthz", None),
    ("GET", "/v1/models", None),
    ("POST", "/v1/completions",
     {"prompt": "tell me about slice level scheduling", "max_tokens": 20}),
    ("POST", "/v1/completions",
     {"prompt": "stream this", "max_tokens": 40, "stream": True}),
    ("POST", "/v1/completions", {"prompt": [5, 9, 300, 7], "max_tokens": 9}),
    ("POST", "/v1/completions", {"prompt": 512, "max_tokens": 900,
                                 "slo_ms": 1}),
    ("POST", "/v1/completions", {"prompt": "quick one", "max_tokens": 8,
                                 "slo_ms": 600_000}),
    ("POST", "/v1/completions", {"prompt": 40, "max_tokens": 30,
                                 "slo_ms": 2_000, "allow_degrade": True}),
) + tuple(("POST", "/v1/completions", b) for b in BAD_COMPLETIONS) + (
    ("GET", "/nope", None),
    ("POST", "/v1/chat/completions", {"prompt": "x"}),
    ("POST", "/v1/chat/completions",
     {"messages": [{"role": "user", "content": "hello there"}],
      "max_tokens": 6, "session": 7}),
    ("POST", "/v1/chat/completions",
     {"messages": [{"role": "user", "content": "hello there"},
                   {"role": "assistant", "content": "hi"},
                   {"role": "user", "content": "and again"}],
      "max_tokens": 5, "session": 7}),
    ("POST", "/v1/chat/completions",
     {"messages": [{"role": "user", "content": "stream me"}],
      "max_tokens": 12, "stream": True}),
    ("DELETE", "/v1/sessions/7", None),
    ("DELETE", "/v1/sessions/x", None),
    ("GET", "/healthz", None),
    ("GET", "/metrics.json", None),
    ("GET", "/metrics", None),
    ("GET", "/debug/decisions", None),
    ("GET", "/debug/decisions?kind=batch&n=2", None),
    ("GET", "/debug/decisions?rid=abc", None),
)


def _run_script(pkg):
    server = _sim_server(pkg, slo_ms=None)
    front = _mod(pkg, "serving").HTTPFrontend(
        server.aio, port=0, model_name="scls-sim", vocab_size=512).start()
    try:
        return [_parsed(*_request(front, m, p, b)) for m, p, b in SCRIPT]
    finally:
        front.shutdown()


def test_every_endpoint_answers_as_jax():
    """One scripted session through every endpoint (completions plain,
    streamed, by token ids and by length, a 429, an SLO met, a degraded
    admission, every malformed body, chat turns of a session, a streamed
    chat, session release, health, metrics in JSON and Prometheus text,
    the decision audit) on a fresh sim server of each package: equal
    status codes, ``Retry-After`` headers and bodies, ids and
    ``created`` times aside (the sim backend's clock is virtual, so no
    field reads the wall clock)."""
    want, got = _run_script("repro"), _run_script("repro_torch")
    assert len(got) == len(want) == len(SCRIPT)
    for step, a, b in zip(SCRIPT, want, got):
        assert b == a, step


# ---------------------------------------------------------------------------
# real engines: chat sessions over the paged retain-mode backend
# ---------------------------------------------------------------------------
POOL_TOKENS = 1024


def _real_chat_server(pkg, model, params, pg):
    serving = _mod(pkg, "serving")
    engine = _mod(pkg, "engine.static_engine")
    estimator = _mod(pkg, "core.estimator")
    dev = {"device": "cpu"} if pkg == "repro_torch" else {}
    cfg = serving.ServingConfig(strategy="scls", backend="real", workers=1,
                                kv_layout="paged", kv_retain="request",
                                page_tokens=pg, slice_len=8, max_gen=8,
                                gamma=0.25, mem_bucket=8, **dev)
    delta = model.kv_bytes_per_token()
    pages = POOL_TOKENS // pg
    mem = cfg.memory_estimator(delta,
                               m_available=pages * pg * delta / cfg.zeta + 1)
    assert mem.total_blocks == pages
    eng = engine.StaticEngine(model, params, eos_id=1, len_bucket=8,
                              kv_layout="paged", page_tokens=pg,
                              kv_pool_tokens=POOL_TOKENS, **dev)
    est = serving.fitted_estimator(estimator.a100_llama13b_profile())
    return cfg.build_real([eng], est, mem)


def _chat_run(pkg, model, params, pg, vocab):
    """Three chat turns of one session, the one-shot replay of the whole
    conversation, then the session's release; what the test compares."""
    server = _real_chat_server(pkg, model, params, pg)
    serving = _mod(pkg, "serving")
    with serving.HTTPFrontend(server.aio, port=0, vocab_size=vocab) as front:
        msgs, replies = [], []
        for content in ("alpha bravo charlie delta echo foxtrot golf",
                        "hotel india", "juliet"):
            msgs.append({"role": "user", "content": content})
            r = _post(front.url, "/v1/chat/completions",
                      dict(messages=msgs, max_tokens=6, session=1))
            reply = r["choices"][0]["message"]["content"]
            replies.append(reply)
            msgs.append({"role": "assistant", "content": reply})
        oneshot = _post(front.url, "/v1/chat/completions",
                        dict(messages=msgs[:-1], max_tokens=6))
        m = _get(front.url, "/metrics.json")
        held = _get(front.url, "/healthz")["free_blocks"]
        dreq = urllib.request.Request(front.url + "/v1/sessions/1",
                                      method="DELETE")
        with urllib.request.urlopen(dreq, timeout=TIMEOUT) as resp:
            released = json.loads(resp.read())["released"]
        free = _get(front.url, "/healthz")["free_blocks"]
    reqs = sorted(server.core.requests, key=lambda r: r.rid)
    return dict(replies=replies, oneshot=oneshot["choices"][0]["message"],
                prompts=[np.asarray(r.prompt) for r in reqs],
                tokens=[list(r.output_tokens) for r in reqs],
                hits=m["prefix_hit_tokens"], completed=m["n_completed"],
                held=held, free=free, released=released,
                owners=server.core.backend.allocators[0].owners())


@pytest.mark.parametrize("pg", [4, 32])
def test_real_chat_session_tokens_equal_jax(pg):
    """The reduced float32 llama3.2-1b behind each package's front end
    (paged, ``kv_retain="request"``, prefix sharing, pages of ``pg``):
    three chat turns with ``session`` give JAX's tokens (near-tie rule;
    past a recorded tie the next turn's prompt may part and is not
    compared), the one-shot replay of the conversation equals the last
    turn, later turns join the history's pages as JAX's do, and releasing
    the session gives every page back."""
    jm, jp, tm, tp = shared_models()
    vocab = tm.cfg.vocab_size
    want = _chat_run("repro", jm, jp, pg, vocab)
    got = _chat_run("repro_torch", tm, tp, pg, vocab)
    assert got["completed"] == want["completed"] == 4
    for p_want, p_got, a, b in zip(want["prompts"], got["prompts"],
                                   want["tokens"], got["tokens"]):
        if not np.array_equal(p_want, p_got):
            break
        assert_same_stream(p_got, a, b)
    if want["tokens"] == got["tokens"]:
        assert got["replies"] == want["replies"]
        assert got["hits"] == want["hits"]
    assert got["oneshot"]["content"] == got["replies"][-1]
    assert np.array_equal(got["prompts"][3], got["prompts"][2])
    assert_same_stream(got["prompts"][3], got["tokens"][2], got["tokens"][3])
    assert got["hits"] > 0 and want["hits"] > 0
    assert got["released"] and want["released"]
    assert sum(got["held"]) < sum(got["free"]) == POOL_TOKENS // pg
    assert not got["owners"]
