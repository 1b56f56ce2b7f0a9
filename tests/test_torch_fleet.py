"""The port's fleet layer (``repro_torch.fleet``, ``repro_torch.launch.
route``) against the JAX package's: the three placers and ``imbalance`` on
seeded snapshot sequences, the registry's lifecycle (crash eviction,
drain, rejoin), the router launcher's flags, and the port's
``FleetRouter`` over two of the port's sim instances (round robin, 429
passthrough, join, drain with an SSE stream in flight, exactly-once
re-placement after a crash, session pinning, 503), whose answers equal a
JAX router's over JAX instances.  Every server listens on an ephemeral
port and every client call has a timeout."""
import http.client
import importlib
import json

import numpy as np
import pytest

SLICE = 8
PKGS = ("repro", "repro_torch")
#: seconds a client waits for one response
TIMEOUT = 60


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _snap(pkg, url, delay=0.0, **kw):
    return _mod(pkg, "fleet").InstanceSnapshot(
        instance=url, healthy=True, polled_at=0.0, queue_delay_est=delay,
        **kw)


def _preq(pkg, rid, inp=8, gen=16, session=None, pinned=None, history=0):
    return _mod(pkg, "fleet").PlacementRequest(
        rid=rid, input_tokens=inp, max_tokens=gen, session_id=session,
        pinned=pinned, history_tokens=history)


# ---------------------------------------------------------------------------
# placement: the port's placers give JAX's placements
# ---------------------------------------------------------------------------
def _placement_run(pkg, policy, seed):
    """A seeded sequence of polls and requests through one placer: each
    step draws each of four instances' snapshot (queue delay, worker
    loads, block gauges, sessions; one instance unhealthy now and then),
    then places a request (every other one a session turn pinned where
    its last turn went, with its history) and completes an earlier one.
    Returns every placement's (instance, policy, loads)."""
    fleet = _mod(pkg, "fleet")
    rng = np.random.default_rng(seed)
    urls = [f"http://10.0.0.{i}:800{i}" for i in range(4)]
    placer = fleet.make_placer(policy, token_time=0.015, epsilon=0.3)
    pins, history, placed, out = {}, {}, [], []
    for i in range(40):
        cands = []
        for u in urls:
            if rng.random() < 0.1:
                continue
            n_workers = int(rng.integers(1, 4))
            loads = tuple(float(x) for x in rng.random(n_workers) * 3.0)
            cands.append(fleet.InstanceSnapshot(
                instance=u, healthy=True, polled_at=float(i),
                queue_delay_est=float(rng.random() * 4.0),
                worker_loads=loads, min_load=min(loads),
                free_blocks=(int(rng.integers(0, 500)),),
                shared_blocks=int(rng.integers(0, 20)),
                n_sessions=int(rng.integers(0, 4))))
        placer.observe(cands)
        if not cands:
            continue
        session = int(rng.integers(1, 6)) if i % 2 else None
        pinned = pins.get(session)
        req = fleet.PlacementRequest(
            rid=i, input_tokens=int(rng.integers(1, 400)),
            max_tokens=int(rng.integers(1, 256)), session_id=session,
            pinned=pinned, history_tokens=history.get(session, 0))
        got = placer.place(cands, req)
        out.append((got.instance, got.policy, dict(got.loads)))
        placed.append((got.instance, req))
        if session is not None:
            pins[session] = got.instance
            history[session] = history.get(session, 0) + req.input_tokens
        if placed and rng.random() < 0.5:
            inst, done = placed.pop(int(rng.integers(0, len(placed))))
            placer.on_complete(inst, done)
    return out


@pytest.mark.parametrize("policy", ["round_robin", "least_load",
                                    "retention_affinity"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_placers_give_jax_placements(policy, seed):
    want = _placement_run("repro", policy, seed)
    got = _placement_run("repro_torch", policy, seed)
    assert len(want) > 30
    assert got == want


def test_placers_are_the_reference_set():
    assert sorted(_mod("repro_torch", "fleet").PLACERS) == \
        sorted(_mod("repro", "fleet").PLACERS)
    assert _mod("repro_torch", "fleet").__all__ == \
        _mod("repro", "fleet").__all__


def _seeded_registry_run(pkg):
    """tests/test_fleet.py's seeded-registry sequence: fixed polls, twelve
    requests (every other one a session turn pinned where it went three
    requests before)."""
    fleet = _mod(pkg, "fleet")
    reg = fleet.InstanceRegistry(
        ("http://a", "http://c", "http://b"),
        fetch=lambda url: {"status": "ok", "queue_delay_est":
                           {"http://a": 1.0, "http://b": 0.3,
                            "http://c": 0.7}[url]})
    reg.poll_once()
    out = {}
    for policy in ("round_robin", "least_load", "retention_affinity"):
        p = fleet.make_placer(policy, token_time=0.02)
        seq = []
        for i in range(12):
            session = (i % 3) + 1 if i % 2 else None
            pin = seq[-3][1] if session and len(seq) >= 3 else None
            got = p.place(reg.placeable(),
                          _preq(pkg, i, inp=4 * i + 1, gen=8 * (i % 4 + 1),
                                session=session, pinned=pin,
                                history=16 * i))
            seq.append((i, got.instance, got.policy, dict(got.loads)))
        out[policy] = seq
    return out


def test_seeded_registry_placements_equal_jax():
    want = _seeded_registry_run("repro")
    got = _seeded_registry_run("repro_torch")
    assert got == want
    assert got["least_load"][0][1] == "http://b"
    assert [u for _, u, _, _ in got["round_robin"][:3]] == [
        "http://a", "http://b", "http://c"]


def test_imbalance_equals_jax():
    rng = np.random.default_rng(3)
    cases = [{}, {"a": 100, "b": 100}, {"a": 300, "b": 0}, {"a": 0, "b": 0}]
    cases += [{f"u{j}": int(x) for j, x in enumerate(
        rng.integers(0, 1000, size=int(rng.integers(1, 6))))}
        for _ in range(20)]
    for served in cases:
        assert _mod("repro_torch", "fleet").imbalance(served) == \
            _mod("repro", "fleet").imbalance(served)
    imb = _mod("repro_torch", "fleet").imbalance
    assert imb({"a": 300, "b": 100}) == 3.0
    assert imb({"a": 300, "b": 0}) == float("inf")


@pytest.mark.parametrize("pkg", PKGS)
def test_least_load_prefers_idle_and_decays_charges(pkg):
    p = _mod(pkg, "fleet").LeastLoadPlacer(token_time=0.01)
    cands = [_snap(pkg, "http://a", delay=5.0),
             _snap(pkg, "http://b", delay=0.0)]
    r = _preq(pkg, 1, inp=100, gen=100)
    picks = [p.place(cands, r).instance]
    picks += [p.place(cands, _preq(pkg, i, inp=100, gen=100)).instance
              for i in (2, 3, 4)]
    assert picks == ["http://b"] * 3 + ["http://a"]
    for _ in range(3):
        p.on_complete("http://b", r)
    assert p.place(cands, _preq(pkg, 5, inp=100, gen=100)).instance == \
        "http://b"
    p.observe([_snap(pkg, "http://a", delay=5.0)])
    assert "http://b" not in p._charges


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("delay_a,epsilon,want", [(0.4, 0.5, "http://a"),
                                                  (9.0, 0.25, "http://b")])
def test_retention_affinity_pins_within_epsilon(pkg, delay_a, epsilon,
                                                want):
    p = _mod(pkg, "fleet").RetentionAffinityPlacer(token_time=0.01,
                                                   epsilon=epsilon)
    cands = [_snap(pkg, "http://a", delay=delay_a),
             _snap(pkg, "http://b", delay=0.0)]
    got = p.place(cands, _preq(pkg, 1, inp=50, gen=50, session=9,
                               pinned="http://a", history=60))
    assert got.instance == want


# ---------------------------------------------------------------------------
# the registry's lifecycle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", PKGS)
def test_registry_crash_eviction_after_consecutive_failures(pkg):
    def fetch(url):
        if url == "http://dead":
            raise OSError("connection refused")
        return {"status": "ok"}

    reg = _mod(pkg, "fleet").InstanceRegistry(("http://live", "http://dead"),
                                              max_failures=2, fetch=fetch)
    evicted = []
    reg.on_evict(evicted.append)
    assert reg.poll_once() == 1
    assert [s.instance for s in reg.placeable()] == ["http://live"]
    assert "http://dead" in reg and not evicted
    reg.poll_once()
    assert evicted == ["http://dead"]
    assert "http://dead" not in reg and len(reg) == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_registry_drain_and_rejoin(pkg):
    reg = _mod(pkg, "fleet").InstanceRegistry(
        ("http://a", "http://b"), fetch=lambda url: {"status": "ok"})
    reg.poll_once()
    assert reg.drain("http://a")
    assert [s.instance for s in reg.placeable()] == ["http://b"]
    assert len(reg) == 2
    assert reg.join("http://a")
    assert [s.instance for s in reg.placeable()] == ["http://a",
                                                     "http://b"]
    assert not reg.drain("http://nope")


def test_snapshot_from_healthz_equals_jax():
    """``InstanceSnapshot.from_healthz`` reads the same fields from a sim
    instance's ``/healthz`` body, and from malformed ones alike."""
    front = _instance("repro_torch")
    try:
        _, body = _rjson(front, "GET", "/healthz")
    finally:
        front.shutdown()
    bodies = [body, {"status": "ok"}, {"status": "ok", "worker_loads": [],
                                       "free_blocks": [3, 4]},
              {"status": "draining", "queue_delay_est": "x"}]
    for b in bodies:
        got = _mod("repro_torch", "fleet").InstanceSnapshot.from_healthz(
            "http://x", b, polled_at=1.0)
        want = _mod("repro", "fleet").InstanceSnapshot.from_healthz(
            "http://x", b, polled_at=1.0)
        assert vars(got) == vars(want)


# ---------------------------------------------------------------------------
# the router launcher
# ---------------------------------------------------------------------------
class _FakeRouter:
    """Stands in for FleetRouter in ``launch.route.main``: records how it
    was built."""
    built = []

    def __init__(self, instances, **kw):
        self.built.append((instances, kw))
        self.url = "http://127.0.0.1:0"

    def start(self):
        return self

    def health(self):
        return {"n_placeable": 0, "n_instances": 0}

    def stats(self):
        return {"n_requests": 0, "placements": {}, "reprefill_tokens": 0,
                "retries": 0, "evictions": 0}

    def shutdown(self):
        pass


@pytest.mark.parametrize("argv", [
    [],
    ["--host", "0.0.0.0", "--port", "0", "--instance", "http://a:1",
     "--instance", "http://b:2", "--placer", "least_load",
     "--poll-interval", "0.5", "--poll-timeout", "1.5",
     "--max-failures", "4", "--epsilon", "0.1", "--token-time", "0.03",
     "--audit-capacity", "16"],
    ["--placer", "round_robin", "--instance", "http://c:3"],
])
def test_route_main_parses_the_jax_flags(argv, monkeypatch, capsys):
    """``repro_torch.launch.route.main`` builds its router from the same
    flags as JAX's, and prints the same help."""
    built = {}
    for pkg in PKGS:
        route = _mod(pkg, "launch.route")
        _FakeRouter.built = []
        monkeypatch.setattr(route, "FleetRouter", _FakeRouter)
        route.main(argv + ["--duration", "0.01"])
        built[pkg] = _FakeRouter.built
    assert built["repro_torch"] == built["repro"] and built["repro"]
    helps = {}
    for pkg in PKGS:
        capsys.readouterr()
        with pytest.raises(SystemExit):
            _mod(pkg, "launch.route").main(["--help"])
        helps[pkg] = capsys.readouterr().out
    assert helps["repro_torch"] == helps["repro"]
    with pytest.raises(SystemExit):
        _mod("repro_torch", "launch.route").main(["--placer", "nope"])


# ---------------------------------------------------------------------------
# the port's router over the port's sim instances
# ---------------------------------------------------------------------------
def _instance(pkg, seed=0, time_scale=None):
    cfg = _mod(pkg, "serving").ServingConfig(
        strategy="scls", workers=2, slice_len=SLICE, gamma=0.25, seed=seed,
        time_scale=time_scale)
    return _mod(pkg, "serving").HTTPFrontend(cfg.build_sim().aio,
                                             port=0).start()


def _router(pkg, urls, **kw):
    return _mod(pkg, "fleet").FleetRouter(tuple(urls), **kw)


@pytest.fixture(scope="module")
def pair():
    fronts = [_instance("repro_torch", seed=i) for i in range(2)]
    yield fronts
    for f in fronts:
        f.shutdown()


def _request(host, port, method, path, body=None):
    conn = http.client.HTTPConnection(host, port, timeout=TIMEOUT)
    headers = {"Content-Type": "application/json"} if body is not None else {}
    conn.request(method, path,
                 json.dumps(body) if body is not None else None, headers)
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp, raw


def _rjson(server, method, path, body=None):
    resp, raw = _request(server.host, server.port, method, path, body)
    return resp, json.loads(raw)


def test_router_routes_and_reports(pair):
    with _router("repro_torch", [f.url for f in pair], placer="round_robin",
                 poll_interval=0.2) as router:
        for i in range(4):
            resp, out = _rjson(router, "POST", "/v1/completions",
                               {"prompt": f"req {i}", "max_tokens": 8})
            assert resp.status == 200
            assert out["object"] == "text_completion"
        resp, health = _rjson(router, "GET", "/healthz")
        assert health["role"] == "router"
        assert health["n_instances"] == health["n_placeable"] == 2
        rows = {r["url"]: r for r in health["instances"]}
        assert set(rows) == {f.url for f in pair}
        assert all("queue_delay_est" in r for r in rows.values())
        resp, stats = _rjson(router, "GET", "/metrics.json")
        assert sorted(stats["placements"].values()) == [2, 2]
        assert sum(stats["served_tokens"].values()) > 0
        resp, raw = _request(router.host, router.port, "GET", "/metrics")
        assert b"scls_fleet_requests_total" in raw
        resp, audit = _rjson(router, "GET", "/debug/placements")
        assert audit["n_recorded"] == 4
        assert all(ev["kind"] == "fleet_place" for ev in audit["events"])


def test_router_passes_429_retry_after_verbatim(pair):
    body = {"prompt": 512, "max_tokens": 900, "slo_ms": 1}
    direct, _ = _request(pair[0].host, pair[0].port, "POST",
                         "/v1/completions", body)
    assert direct.status == 429
    with _router("repro_torch", [pair[0].url], placer="round_robin",
                 poll_interval=5.0) as router:
        resp, out = _rjson(router, "POST", "/v1/completions", body)
        assert resp.status == 429
        assert out["error"]["type"] == "rate_limit_exceeded"
        assert resp.getheader("Retry-After") == \
            direct.getheader("Retry-After")


def test_router_join_endpoint_adds_instance(pair):
    extra = _instance("repro_torch", seed=5)
    try:
        with _router("repro_torch", [pair[0].url], placer="round_robin",
                     poll_interval=5.0) as router:
            _, health = _rjson(router, "GET", "/healthz")
            assert health["n_instances"] == 1
            resp, out = _rjson(router, "POST", "/fleet/join",
                               {"url": extra.url})
            assert resp.status == 200 and out["healthy"]
            _, health = _rjson(router, "GET", "/healthz")
            assert health["n_instances"] == health["n_placeable"] == 2
            for _ in range(2):
                resp, _ = _rjson(router, "POST", "/v1/completions",
                                 {"prompt": "after join", "max_tokens": 4})
                assert resp.status == 200
            _, stats = _rjson(router, "GET", "/metrics.json")
            assert extra.url in stats["placements"]
    finally:
        extra.shutdown()


def test_drain_finishes_inflight_sse_and_stops_placement():
    fronts = [_instance("repro_torch", seed=i, time_scale=4.0)
              for i in range(2)]
    try:
        with _router("repro_torch", [f.url for f in fronts],
                     placer="round_robin", poll_interval=0.2) as router:
            conn = http.client.HTTPConnection(router.host, router.port,
                                              timeout=TIMEOUT)
            conn.request("POST", "/v1/completions",
                         json.dumps({"prompt": "drain me",
                                     "max_tokens": 48, "stream": True}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            first = resp.fp.readline()
            assert first.startswith(b"data: ")
            _, audit = _rjson(router, "GET", "/debug/placements")
            placed = audit["events"][0]["instance"]
            r2, _ = _rjson(router, "POST", "/fleet/drain", {"url": placed})
            assert r2.status == 200
            rest = resp.read()
            conn.close()
            assert b"data: [DONE]" in first + rest
            events = [e for e in (first + rest).decode().split("\n\n")
                      if e.startswith("data: ")]
            toks = [int(t) for e in events[:-2]
                    for t in json.loads(e[6:])["choices"][0]["text"].split()]
            assert toks == list(range(48))
            other = next(f.url for f in fronts if f.url != placed)
            for _ in range(3):
                r3, _ = _rjson(router, "POST", "/v1/completions",
                               {"prompt": "post drain", "max_tokens": 4})
                assert r3.status == 200
            _, stats = _rjson(router, "GET", "/metrics.json")
            assert stats["placements"][other] == 3
            assert stats["placements"].get(placed, 0) == 1
            _, health = _rjson(router, "GET", "/healthz")
            assert health["n_instances"] == 2
            assert health["n_placeable"] == 1
    finally:
        for f in fronts:
            f.shutdown()


def test_crash_evict_replaces_exactly_once():
    fronts = [_instance("repro_torch", seed=i) for i in range(2)]
    by_url = {f.url: f for f in fronts}
    dead_url = sorted(by_url)[0]
    live = by_url[sorted(by_url)[1]]
    try:
        with _router("repro_torch", list(by_url), placer="round_robin",
                     poll_interval=30.0, max_failures=1) as router:
            by_url[dead_url]._httpd.shutdown()
            by_url[dead_url]._httpd.server_close()
            resp, _ = _rjson(router, "POST", "/v1/completions",
                             {"prompt": "crash path", "max_tokens": 8})
            assert resp.status == 200
            _, stats = _rjson(router, "GET", "/metrics.json")
            assert stats["retries"] == 1
            assert stats["evictions"] == 1
            assert stats["placements"][live.url] == 1
            assert list(stats["served_tokens"]) == [live.url]
            _, health = _rjson(router, "GET", "/healthz")
            assert health["n_instances"] == 1
            _, snap = _rjson(live, "GET", "/healthz")
            assert snap["n_submitted"] == 1
    finally:
        for f in fronts:
            f.shutdown()


def test_session_pinning_and_migration_reprefill(pair):
    with _router("repro_torch", [f.url for f in pair],
                 placer="retention_affinity", poll_interval=0.2) as router:
        msgs = [{"role": "user", "content": "first turn of the chat"}]
        for turn in range(2):
            resp, out = _rjson(router, "POST", "/v1/chat/completions",
                               {"messages": msgs, "max_tokens": 8,
                                "session": 42})
            assert resp.status == 200
            msgs.append(out["choices"][0]["message"])
            msgs.append({"role": "user", "content": f"turn {turn + 2}"})
        _, audit = _rjson(router, "GET", "/debug/placements")
        turns = [ev for ev in audit["events"] if ev["session"] == 42]
        assert len(turns) == 2
        assert turns[0]["instance"] == turns[1]["instance"]
        assert turns[1]["pinned"] == turns[0]["instance"]
        assert not turns[1]["migrated"]
        _, stats = _rjson(router, "GET", "/metrics.json")
        assert stats["reprefill_tokens"] == 0
        _rjson(router, "POST", "/fleet/drain",
               {"url": turns[0]["instance"]})
        resp, _ = _rjson(router, "POST", "/v1/chat/completions",
                         {"messages": msgs, "max_tokens": 8,
                          "session": 42})
        assert resp.status == 200
        _, stats = _rjson(router, "GET", "/metrics.json")
        assert stats["migrations"] == 1
        assert stats["reprefill_tokens"] > 0
        _, audit = _rjson(router, "GET", "/debug/placements")
        last = audit["events"][-1]
        assert last["migrated"] and last["instance"] != turns[0]["instance"]
        resp, out = _rjson(router, "DELETE", "/v1/sessions/42")
        assert resp.status == 200 and out["released"]
        _, stats = _rjson(router, "GET", "/metrics.json")
        assert stats["sessions"] == 0


def test_router_503_when_no_instance():
    with _router("repro_torch", [], placer="least_load",
                 poll_interval=5.0) as router:
        resp, _ = _rjson(router, "POST", "/v1/completions",
                         {"prompt": "nowhere to go", "max_tokens": 4})
        assert resp.status == 503
        assert resp.getheader("Retry-After") == "1"
        resp, _ = _rjson(router, "POST", "/fleet/drain",
                         {"url": "http://127.0.0.1:1"})
        assert resp.status == 404


def _fleet_run(pkg):
    """Round robin over two fresh sim instances of ``pkg``: completions
    plain, streamed and by length, a chat turn and the router's stats;
    instances named by their place in the sorted URL list."""
    fronts = [_instance(pkg, seed=i) for i in range(2)]
    names = {u: f"i{j}" for j, u in enumerate(sorted(f.url for f in fronts))}
    bodies = [{"prompt": "alpha beta", "max_tokens": 9},
              {"prompt": 30, "max_tokens": 17, "stream": True},
              {"prompt": [4, 5, 6], "max_tokens": 5},
              {"prompt": "gamma", "max_tokens": 12, "stream": True}]
    out = []
    try:
        with _router(pkg, [f.url for f in fronts], placer="round_robin",
                     poll_interval=5.0) as router:
            for body in bodies:
                _, raw = _request(router.host, router.port, "POST",
                                  "/v1/completions", body)
                if body.get("stream"):
                    events = [e for e in raw.decode().split("\n\n")
                              if e.startswith("data: ")]
                    out.append([json.loads(e[6:])["choices"]
                                for e in events[:-1]])
                else:
                    obj = json.loads(raw)
                    out.append((obj["choices"], obj["usage"]))
            _, chat = _rjson(router, "POST", "/v1/chat/completions",
                             {"messages": [{"role": "user",
                                            "content": "hi there"}],
                              "max_tokens": 6, "session": 3})
            out.append((chat["choices"], chat["usage"], chat["session"]))
            _, stats = _rjson(router, "GET", "/metrics.json")
            _, audit = _rjson(router, "GET", "/debug/placements")
    finally:
        for f in fronts:
            f.shutdown()
    stats["placements"] = {names[u]: n
                           for u, n in stats["placements"].items()}
    stats["served_tokens"] = {names[u]: n
                              for u, n in stats["served_tokens"].items()}
    places = [(names[e["instance"]], e["policy"], e["session"],
               e["input_tokens"], e["max_tokens"]) for e in audit["events"]]
    return out, stats, places


def test_router_answers_as_the_jax_router():
    """The same requests through a JAX router over JAX sim instances and
    through the port's over the port's: equal bodies (ids and times
    aside), equal stats and the same placement sequence."""
    assert _fleet_run("repro_torch") == _fleet_run("repro")
