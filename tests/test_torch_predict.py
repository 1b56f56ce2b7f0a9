"""The port's length prediction (``repro_torch.predict``) and the
prediction-aware mode of its core against the JAX package's: the
histogram, perfect and calibration code answers scripted request streams
exactly as JAX's; ``scls-pred`` with the perfect and the histogram
predictor, and ``oracle``, give JAX's dispatch log bit for bit on a
CodeFuse trace; the proxy MLP, with JAX's parameters carried across,
matches JAX's ``_forward`` within ``PROXY_TOL`` before and after 64
``observe`` calls, and its dispatch log equals JAX's but for recorded cap
ties; a proxy asked for the card without one raises."""
import copy

import jax
import numpy as np
import pytest
import torch

#: |z_port - z_jax| on the proxy's log1p(remaining) scale (float32 sums of
#: 4 and 16 terms in another order, through 64 SGD steps)
PROXY_TOL = 1e-5
#: a calibrated cap x = raw * scale is a tie when the two packages' x lie
#: within this relative distance of each other and round to different
#: integers (a float32 difference in the proxy moved x across a .5 edge)
CAP_TIE = 1e-4
#: proxy cap ties met by ``test_proxy_batch_log_matches_jax``:
#: (sigma, cap index, x_jax, x_port)
cap_ties = []


def _request(pkg, rid, input_len, gen_len, generated=0, prompt=None,
             max_gen=1024):
    import importlib
    req = importlib.import_module(f"{pkg}.core.request")
    return req.Request(rid=rid, arrival=0.0, input_len=input_len,
                       gen_len=gen_len, generated=generated, prompt=prompt,
                       max_gen=max_gen)


def _stream(seed=0, n=300):
    """(input_len, total, prompt) of a lognormal request stream."""
    rng = np.random.default_rng(seed)
    totals = np.clip(np.round(rng.lognormal(4.6, 1.0, n)), 1, 1024)
    return [(int(rng.integers(4, 64)), int(t),
             rng.integers(2, 500, size=int(rng.integers(4, 40))))
            for t in totals]


def _scripted_predictions(pkg, name):
    """Feed one stream to ``pkg``'s predictor ``name`` and its calibrator:
    completions, in-flight evidence and predictions interleaved."""
    import importlib
    predict = importlib.import_module(f"{pkg}.predict")
    pred = predict.make_predictor(name, max_gen=1024, coverage=0.7)
    cal = predict.QuantileCalibrator(coverage=0.7)
    out = []
    for i, (inp, total, prompt) in enumerate(_stream()):
        alive = _request(pkg, 10_000 + i, inp, total + 50,
                         generated=total // 2, prompt=prompt)
        pred.observe_alive(alive)
        raw = pred.predict_remaining(alive)
        out.append((raw, cal.cap(alive, raw)))
        alive.generated = total + 50
        cal.observe(alive)
        pred.observe(_request(pkg, i, inp, total, generated=total,
                              prompt=prompt))
    return out, cal.scale, cal.empirical_coverage()


@pytest.mark.parametrize("name", ["histogram", "perfect"])
def test_host_predictors_and_calibrator_match_jax(name):
    """The histogram (Kaplan-Meier over decayed bins) and perfect
    predictors and the quantile calibrator give JAX's raw predictions,
    caps, scale and coverage exactly on one scripted stream."""
    assert _scripted_predictions("repro_torch", name) == \
        _scripted_predictions("repro", name)


#: (strategy, predictor, kv_layout, packing) of the pred-mode parity runs
PRED_CASES = [("scls-pred", "perfect", "dense", "batch-max"),
              ("scls-pred", "histogram", "dense", "batch-max"),
              ("oracle", None, "dense", "batch-max"),
              ("scls-pred", "histogram", "paged", "envelope")]


def _pred_core(pkg, strategy, predictor, kv_layout, packing, sigma,
               pred=None, caps=None):
    """``pkg``'s SchedulerCore over its SimBackend on the paper testbed, a
    memory-constrained A100 budget so batch sizes bind (the S^3 regime),
    and a CodeFuse trace, with the predictor ``pred`` if given and every
    calibrated cap recorded into ``caps`` if given; returns (core,
    metrics)."""
    import importlib
    ctrace = importlib.import_module(f"{pkg}.cluster.trace")
    estimator = importlib.import_module(f"{pkg}.core.estimator")
    memory = importlib.import_module(f"{pkg}.core.memory")
    schedulers = importlib.import_module(f"{pkg}.core.schedulers")
    serving = importlib.import_module(f"{pkg}.serving")
    true_lat = estimator.a100_llama13b_profile()
    est = serving.fitted_estimator(true_lat, seed=0)
    if kv_layout == "paged":
        mem = memory.PagedMemoryEstimator(
            delta_bytes=memory.LLAMA2_13B_DELTA, m_available=5e9, zeta=0.9,
            page_tokens=16)
    else:
        mem = memory.AnalyticMemoryEstimator(
            delta_bytes=memory.LLAMA2_13B_DELTA, m_available=5e9, zeta=0.9)
    kw = {} if predictor is None else dict(predictor=predictor)
    s = schedulers.make_strategy(strategy, slice_len=128, gamma=3.0,
                                 coverage=0.7, kv_layout=kv_layout,
                                 packing=packing, **kw)
    core = serving.SchedulerCore(
        s, serving.SimBackend(true_lat, noise_sigma=sigma, seed=2), 4, est,
        mem, predictor=pred)
    if caps is not None:
        _recording_caps(core, caps)
    trace = ctrace.generate_trace(12.0, 40.0, ctrace.CODEFUSE, seed=3)
    return core, core.run(copy.deepcopy(trace), 40.0)


@pytest.mark.parametrize("sigma", [0.0, 0.05])
@pytest.mark.parametrize("strategy, predictor, kv_layout, packing",
                         PRED_CASES)
def test_pred_mode_batch_log_matches_jax(strategy, predictor, kv_layout,
                                         packing, sigma):
    """The port's ``pred`` mode (observe -> predict -> calibrate ->
    bucketed DP batch, completion feedback) reproduces JAX's dispatch log,
    metrics and calibration bit for bit."""
    import dataclasses
    args = (strategy, predictor, kv_layout, packing, sigma)
    jcore, jm = _pred_core("repro", *args)
    core, m = _pred_core("repro_torch", *args)
    assert m.n_completed == m.n_requests == jm.n_requests > 100
    assert core.batch_log == jcore.batch_log
    assert dataclasses.asdict(m) == dataclasses.asdict(jm)
    assert core.calibrator.scale == jcore.calibrator.scale
    assert core.predictor.name == jcore.predictor.name


def _proxy_pair(max_gen=1024, seed=0):
    """(JAX ProxyPredictor, the port's on the CPU with JAX's parameters)."""
    from repro.predict.proxy import ProxyPredictor as JaxProxy
    from repro_torch.predict.proxy import ProxyPredictor
    from repro_torch.weights import load_proxy_params
    jp = JaxProxy(max_gen=max_gen, seed=seed)
    tp = ProxyPredictor(max_gen=max_gen, seed=seed, device="cpu")
    load_proxy_params(tp, jax.tree.map(np.asarray, jp.params))
    return jp, tp


def _z_gap(jp, tp, x):
    from repro.predict.proxy import _forward
    want = np.asarray(_forward(jp.params, jax.numpy.asarray(x)))
    with torch.no_grad():
        got = tp.mlp(torch.from_numpy(x)).numpy()
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_proxy_forward_matches_jax_before_and_after_training(seed):
    """With JAX's parameters carried across, the port's MLP gives JAX's
    log1p(remaining) within PROXY_TOL on 64 random feature rows, and still
    does after both sides ``observe`` the same 64 completions (one
    weighted-MSE SGD step each, gradients from autograd vs jax.grad); the
    predictions agree to the same relative tolerance."""
    jp, tp = _proxy_pair(seed=seed)
    x = np.random.default_rng(seed).uniform(
        0.0, 1.0, (64, 4)).astype(np.float32)
    assert _z_gap(jp, tp, x) < PROXY_TOL
    for i, (inp, total, prompt) in enumerate(_stream(seed + 5, n=64)):
        jp.observe(_request("repro", i, inp, total, generated=total,
                            prompt=prompt))
        tp.observe(_request("repro_torch", i, inp, total, generated=total,
                            prompt=prompt))
    assert tp.n_observed == jp.n_observed == 64
    assert len(tp._buf) == len(jp._buf) > 64
    assert _z_gap(jp, tp, x) < PROXY_TOL
    for inp, total, prompt in _stream(seed + 9, n=16):
        for gen in (0, total // 2):
            want = jp.predict_remaining(_request("repro", 0, inp, total,
                                                 generated=gen,
                                                 prompt=prompt))
            got = tp.predict_remaining(_request("repro_torch", 0, inp, total,
                                                generated=gen,
                                                prompt=prompt))
            assert got == pytest.approx(want, rel=2 * PROXY_TOL)


def test_proxy_trains_online():
    """The port of JAX's online-training check: after 300 lognormal
    completions (median ~100) a fresh request's prediction is of that
    order, not a cold-start extreme."""
    from repro_torch.predict import make_predictor
    proxy = make_predictor("proxy", max_gen=1024, device="cpu")
    rng = np.random.default_rng(0)
    totals = np.clip(np.round(np.random.default_rng(3).lognormal(
        4.6, 1.0, 300)), 1, 1024).astype(int)
    for i, t in enumerate(totals):
        proxy.observe(_request("repro_torch", i, int(rng.integers(4, 64)),
                               int(t), generated=int(t)))
    pred = proxy.predict_remaining(_request("repro_torch", 9999, 16, 100))
    assert 20.0 <= pred <= 600.0


def _recording_caps(core, log):
    """Record, at every calibrated cap, (rid, raw * scale, cap, dispatches
    so far)."""
    cal = core.calibrator
    cap = cal.cap

    def rec(req, raw):
        c = cap(req, raw)
        log.append((req.rid, float(raw) * cal.scale, c, len(core.batch_log)))
        return c

    cal.cap = rec


@pytest.mark.parametrize("sigma", [0.0, 0.05])
def test_proxy_batch_log_matches_jax(sigma):
    """``scls-pred`` with the proxy (JAX's parameters carried across) on
    the sim backend: every calibrated cap and the whole dispatch log equal
    JAX's, except after a cap tie (the two packages' raw * scale within
    CAP_TIE of each other on two sides of a rounding edge), which is
    recorded in ``cap_ties``; the logs must then agree up to the
    scheduling round of the tie.  The parameters stay within PROXY_TOL of
    JAX's after the run's online training."""
    jp, tp = _proxy_pair(max_gen=1024)
    logs = {"repro": [], "repro_torch": []}
    jcore, _ = _pred_core("repro", "scls-pred", "proxy", "dense",
                          "batch-max", sigma, pred=jp, caps=logs["repro"])
    core, _ = _pred_core("repro_torch", "scls-pred", "proxy", "dense",
                         "batch-max", sigma, pred=tp,
                         caps=logs["repro_torch"])
    want, got = logs["repro"], logs["repro_torch"]
    assert len(want) > 100
    tie = None
    for i, (a, b) in enumerate(zip(want, got)):
        assert a[0] == b[0] and a[3] == b[3]
        if a[2] != b[2]:
            edge = np.floor(max(a[1], b[1]) - 0.5) + 0.5
            assert abs(a[1] - b[1]) <= CAP_TIE * max(a[1], b[1]) and \
                min(a[1], b[1]) <= edge <= max(a[1], b[1]), (i, a, b)
            tie = i
            cap_ties.append((sigma, i, a[1], b[1]))
            break
    if tie is None:
        assert len(got) == len(want)
        assert core.batch_log == jcore.batch_log
        x = np.random.default_rng(1).uniform(0, 1, (32, 4)).astype(np.float32)
        assert _z_gap(jp, tp, x) < PROXY_TOL
    else:
        n = want[tie][3]
        assert core.batch_log[:n] == jcore.batch_log[:n]


def test_proxy_on_the_card_without_one_raises(monkeypatch):
    """No fall-back to the CPU: a proxy left to the default device (the
    card) or asked for ``cuda`` raises without a card, from the factory
    and from ``ServingConfig``; host predictors ignore the device."""
    from repro_torch.predict import make_predictor
    from repro_torch.serving import ServingConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_predictor("proxy", device=device)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingConfig(strategy="scls-pred", predictor="proxy").build_sim()
    assert make_predictor("histogram", device="cuda").name == "histogram"
    server = ServingConfig(strategy="scls-pred", predictor="proxy",
                           device="cpu").build_sim()
    assert server.core.predictor.mlp.w1.device.type == "cpu"
