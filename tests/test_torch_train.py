"""The port's training path against the JAX package's, at the reduced
float32 configs of every family (llama3.2-1b, mamba2-130m,
deepseek-v2-lite-16b, mixtral-8x22b, recurrentgemma-9b,
seamless-m4t-large-v2, paligemma-3b), on the same weights
(``params_from_jax``) and the same numpy batches.

Tolerances: ``softmax_xent`` within 1e-6; ``Model.loss`` within 1e-5
relative; the loss's gradient, every leaf within 1e-4 of its largest
|g| (sums in another order; an indexing fault moves O(1) of it); the
optimiser's schedule, norm, clip and three updates within 1e-6; three
train steps, loss and every parameter within 1e-4 (relative to the
leaf's largest |value|).  Mamba-2's JAX forward calls the oracle
``ssd_scan_ref``, which overflows to NaN once a chunk's sum of dt·|A|
passes ~88.7 (ROADMAP C2); the reduced model's 12-token batches stay far
below it, and only there is the oracle's gradient the reference.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import shared_models

ARCHS = ("llama3.2-1b", "mamba2-130m", "deepseek-v2-lite-16b",
         "mixtral-8x22b", "recurrentgemma-9b", "seamless-m4t-large-v2",
         "paligemma-3b")
MOE = ("deepseek-v2-lite-16b", "mixtral-8x22b")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_FRAMES = 16


def _batch(cfg, B=2, T=12, seed=0):
    """A numpy batch of the family's inputs: tokens, and the frontend
    embeddings (the encoder-decoder's with a row of invalid frames)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(2, cfg.vocab_size,
                                size=(B, T)).astype(np.int32)}
    if cfg.family == "encdec":
        b["src_embeds"] = rng.standard_normal(
            (B, SRC_FRAMES, cfg.d_model)).astype(np.float32)
        valid = np.ones((B, SRC_FRAMES), bool)
        valid[-1, SRC_FRAMES * 2 // 3:] = False
        b["src_valid"] = valid
    if cfg.family == "vlm":
        b["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return b


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _port_grads(model, tp, batch):
    """(loss, {name: grad}) of ``model``'s loss by autograd."""
    named = list(tp.named_parameters())
    for _, p in named:
        p.requires_grad_(True)
    try:
        loss = model.loss(tp, batch)
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
    finally:
        for _, p in named:
            p.requires_grad_(False)
    return loss.detach(), {n: g for (n, _), g in zip(named, grads)}


def _assert_leaves_close(got, want, tol, what):
    """Every tensor of ``got`` (by name) within ``tol`` of the same leaf
    of ``want``, relative to that leaf's largest |value|."""
    assert set(got) == set(want), what
    for name, w in want.items():
        g = got[name]
        assert g is not None, f"{what}: no value for {name}"
        scale = max(w.abs().max().item(), 1e-30)
        err = (g.float() - w.float()).abs().max().item() / scale
        assert err <= tol, f"{what} {name}: {err:.3e} > {tol}"


def _jax_tree_as_port(tree):
    from repro_torch.weights import params_from_jax
    return params_from_jax(jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_jax(masked):
    from repro.models.common import softmax_xent as jax_xent
    from repro_torch.models.common import softmax_xent
    rng = np.random.default_rng(1)
    logits = (4 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = float(jax_xent(jnp.asarray(logits), jnp.asarray(labels),
                          None if mask is None else jnp.asarray(mask)))
    got = float(softmax_xent(torch.from_numpy(logits),
                             torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask)))
    assert abs(got - want) <= 1e-6
    if masked:  # an all-zero mask: the mean over max(sum, 1)
        zero = np.zeros_like(mask)
        assert float(softmax_xent(torch.from_numpy(logits),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(zero))) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    jm, jp, tm, tp = shared_models(arch)
    b = _batch(jm.cfg)
    b["loss_mask"] = np.ones((2, 11), np.float32)
    b["loss_mask"][0, :4] = 0.0
    want = float(jm.loss(jp, _jax(b)))
    with torch.no_grad():
        got = float(tm.loss(tp, _torch(b)))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradient_matches_jax(arch):
    """``jax.grad(model.loss)`` against autograd through the port's plain
    forward: every parameter gets a gradient, each leaf (mapped through
    ``params_from_jax``'s naming) within 1e-4 of its largest |g|."""
    jm, jp, tm, tp = shared_models(arch)
    b = _batch(jm.cfg)
    want_loss, want = jax.value_and_grad(jm.loss)(jp, _jax(b))
    loss, got = _port_grads(tm, tp, _torch(b))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    _assert_leaves_close(got, _jax_tree_as_port(want), 1e-4, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_equal_plain_ones(arch):
    """``remat=True`` recomputes every layer in the backward pass (the
    checkpoint runs once a layer) and gives the gradients of the plain
    forward."""
    from repro_torch.models import common
    from repro_torch.models.registry import get_model
    jm, jp, tm, tp = shared_models(arch)
    b = _torch(_batch(jm.cfg))
    _, plain = _port_grads(tm, tp, b)
    calls = []
    real = common.checkpoint

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    remat = get_model(tm.cfg.replace(remat=True))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "checkpoint", counting)
        _, got = _port_grads(remat, tp, b)
    assert len(calls) > 0
    _assert_leaves_close(got, plain, 1e-6, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_forwards_reach_no_kernel_wrapper(arch, monkeypatch):
    """Every kernel wrapper of ``kernels.ops`` patched to raise: the
    family's loss and its backward still run (the training forwards are
    plain torch, so the kernels' missing backward never matters)."""
    from repro_torch.kernels import ops
    for name in ("paged_prefill_write", "paged_decode_attention",
                 "fused_rope_prefill_write", "fused_rope_decode_append",
                 "flash_prefill", "decode_attention", "ssd_chunked_scan"):
        def refuse(*a, _name=name, **kw):
            raise AssertionError(f"training reached kernels.ops.{_name}")
        monkeypatch.setattr(ops, name, refuse)
    jm, jp, tm, tp = shared_models(arch)
    loss, grads = _port_grads(tm, tp, _torch(_batch(jm.cfg)))
    assert torch.isfinite(loss)
    assert all(g is not None for g in grads.values())


def test_kernel_guard_refuses_grad_inputs_on_any_device():
    """``kernels.ops._refuse_grad`` (each CUDA branch's first step):
    raises with grad mode on and an input that requires grad, passes
    under ``no_grad`` and for inputs that require none."""
    from repro_torch.kernels import ops
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops._refuse_grad("flash_prefill", torch.zeros(2), x)
    with torch.no_grad():
        ops._refuse_grad("flash_prefill", x)
    ops._refuse_grad("flash_prefill", torch.zeros(2))


# ---------------------------------------------------------------------------
# the families' training forwards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_moe_aux_loss_matches_jax(arch):
    """The Switch-style load-balance loss, of one MoE layer (two dispatch
    groups, one padded) and averaged over the layers of ``forward``; the
    default ``forward`` still returns the logits alone."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    jm, jp, tm, tp = shared_models(arch)
    jcfg, tcfg = jm.cfg, tm.cfg
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 400, jcfg.d_model)).astype(np.float32)
    layer = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    _, want = jmoe.moe_apply(layer, jnp.asarray(x), jcfg)
    with torch.no_grad():
        _, got = tmoe.moe_apply(tp.layers[0].moe, torch.from_numpy(x), tcfg,
                                with_aux=True)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    tokens = _batch(jcfg)["tokens"]
    jl, jaux = jmoe.forward(jp, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        tl, taux = tmoe.forward(tp, tcfg, torch.from_numpy(tokens),
                                with_aux=True)
        plain = tmoe.forward(tp, tcfg, torch.from_numpy(tokens))
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    assert torch.equal(plain, tl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5)


def test_mamba_forward_matches_jax_with_pads_and_takes_no_kernel():
    """``mamba2.forward`` with left pads (``valid``) and a length that is
    no multiple of the chunk against JAX's, through the plain scan only;
    prefill still goes through ``kernels.ops.ssd_chunked_scan``, once a
    layer."""
    from repro.models import mamba2 as jmamba
    from repro_torch.kernels import ops
    from repro_torch.models import mamba2 as tmamba
    jm, jp, tm, tp = shared_models("mamba2-130m")
    cfg = tm.cfg
    rng = np.random.default_rng(5)
    T = cfg.ssm_chunk + 7
    tokens = rng.integers(2, cfg.vocab_size, size=(2, T)).astype(np.int32)
    valid = np.ones((2, T), bool)
    valid[1, :9] = False
    want = np.asarray(jmamba.forward(jp, jm.cfg, jnp.asarray(tokens),
                                     jnp.asarray(valid)))
    ops.reset_counts()
    with torch.no_grad():
        got = tmamba.forward(tp, cfg, torch.from_numpy(tokens),
                             torch.from_numpy(valid)).numpy()
        assert ops.plain_calls["ssd_scan"] == 0
        tmamba.prefill(tp, cfg, torch.from_numpy(tokens),
                       torch.tensor([T, T - 9], dtype=torch.int32))
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert ops.plain_calls["ssd_scan"] == cfg.n_layers


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def test_lr_schedule_matches_jax_over_every_step():
    """The schedule over steps 0..total (warm-up, cosine, floor), and the
    config's defaults equal JAX's."""
    import dataclasses
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw
    assert dataclasses.asdict(adamw.AdamWConfig()) == \
        dataclasses.asdict(jadamw.AdamWConfig())
    cfg = dict(lr=1e-3, warmup_steps=5, total_steps=40)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    for step in range(0, 41):
        want = float(jadamw.lr_schedule(jcfg, jnp.asarray(step, jnp.int32)))
        got = float(adamw.lr_schedule(
            tcfg, torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * cfg["lr"], step


def _random_grads(jp, scale, seed=2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        (scale * rng.standard_normal(a.shape)).astype(np.float32)), jp)


@pytest.mark.parametrize("scale", [1e-4, 1.0])
def test_global_norm_clip_and_three_updates_match_jax(scale):
    """``global_norm`` and three ``adamw_update``s on the same gradients,
    below the clip (scale 1e-4) and far above it (1.0): parameters,
    moments and step within 1e-6."""
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw
    from repro_torch.weights import params_from_jax
    jm, jp, tm, _ = shared_models("llama3.2-1b")
    tp = tm.init(0, device="cpu")
    tp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
    jg = _random_grads(jp, scale)
    tg = _jax_tree_as_port(jg)
    gn = float(jadamw.global_norm(jg))
    assert abs(float(adamw.global_norm(tg)) - gn) <= 1e-6 * gn
    assert (gn > 1.0) == (scale == 1.0)  # the clip binds at scale 1
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    jstate, tstate = jadamw.init_adamw(jp), adamw.init_adamw(tp)
    jparams = jp
    for _ in range(3):
        jparams, jstate = jadamw.adamw_update(jcfg, jg, jstate, jparams)
        tp, tstate = adamw.adamw_update(tcfg, tg, tstate, tp)
    assert int(tstate.step) == int(jstate.step) == 3
    _assert_leaves_close(dict(tp.named_parameters()),
                         _jax_tree_as_port(jparams), 1e-6, "params")
    for moment in ("mu", "nu"):
        got = {k: v for k, v in _flat(getattr(tstate, moment)).items()}
        want = {k: torch.from_numpy(np.array(v)) for k, v in
                _flat(getattr(jstate, moment)).items()}
        _assert_leaves_close(got, want, 1e-6, moment)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch):
    """``make_train_step`` three times from the same weights over the same
    three batches: each step's loss and, after the last, every parameter
    within 1e-4.  AdamW's ``eps`` is 1e-3 here, not 1e-8: at 1e-8 an
    element whose gradient lies within float32 rounding of zero moves by
    up to ±lr on either side's rounding (the update ``g / (|g| + eps)``
    has slope 1/eps at 0), so the two sides part by ~lr there whatever
    the sums' order; eps 1e-3 bounds that slope.  The update's arithmetic
    at the default eps is held on shared gradients above."""
    from repro.launch.steps import make_train_step as jax_step
    from repro.optim.adamw import AdamWConfig as JaxAdamW
    from repro.optim.adamw import init_adamw as jax_init
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamWConfig, init_adamw
    from repro_torch.weights import params_from_jax
    jm, jp, tm, _ = shared_models(arch)
    tp = tm.init(0, device="cpu")
    tp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=3, eps=1e-3)
    jfn = jax.jit(jax_step(jm, JaxAdamW(**cfg)))
    tfn = make_train_step(tm, AdamWConfig(**cfg))
    jparams, jopt = jp, jax_init(jp)
    topt = init_adamw(tp)
    for i in range(3):
        b = _batch(jm.cfg, seed=10 + i)
        jparams, jopt, jl = jfn(jparams, jopt, _jax(b))
        tp, topt, tl = tfn(tp, topt, _torch(b))
        assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl)), i
    assert all(not p.requires_grad for p in tp.parameters())
    _assert_leaves_close(dict(tp.named_parameters()),
                         _jax_tree_as_port(jparams), 1e-4, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    """``make_prefill_step`` over two rows (one left-padded, with the
    family's frontend inputs), then three ``make_decode_step``s on JAX's
    greedy tokens: logits within 1e-4 of JAX's steps'.  The port's steps
    run under ``no_grad``: with parameters that require grad, no output
    does."""
    from repro.launch.steps import make_decode_step as jax_decode
    from repro.launch.steps import make_prefill_step as jax_prefill
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    jm, jp, tm, tp = shared_models(arch)
    b = _batch(jm.cfg, T=10, seed=3)
    b["tokens"][1, :4] = 0
    b["lengths"] = np.array([10, 6], np.int32)
    W = 14 + (jm.cfg.n_prefix_tokens if jm.cfg.family == "vlm" else 0)
    jl, jc = jax_prefill(jm, W)(jp, _jax(b))
    for p in tp.parameters():
        p.requires_grad_(True)
    try:
        tl, tc = make_prefill_step(tm, W)(tp, _torch(b))
        outs = [tl]
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        jstep, tstep = jax_decode(jm), make_decode_step(tm)
        for step in range(3):
            cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            jl, jc = jstep(jp, jc, jnp.asarray(cur), jnp.asarray(step))
            tl, tc = tstep(tp, tc, torch.from_numpy(cur), step)
            outs.append(tl)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                       err_msg=f"decode {step}")
    finally:
        for p in tp.parameters():
            p.requires_grad_(False)
    assert not any(t.requires_grad for t in outs)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------
def test_pipeline_batches_equal_jax_and_restore():
    from repro.data import pipeline as jpipe
    from repro_torch.data import pipeline
    jc = jpipe.SyntheticCorpus(vocab_size=512, seed=3)
    tc = pipeline.SyntheticCorpus(vocab_size=512, seed=3)
    np.testing.assert_array_equal(tc.stream(1000, offset=4),
                                  jc.stream(1000, offset=4))
    jb, tb = jpipe.TokenBatcher(jc, 4, 16), pipeline.TokenBatcher(tc, 4, 16)
    for _ in range(3):
        want, got = next(jb), next(tb)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    saved = tb.state()
    assert saved == jb.state() == {"step": 3}
    ahead = next(tb)
    tb.restore(saved)
    np.testing.assert_array_equal(next(tb)["tokens"], ahead["tokens"])


# ---------------------------------------------------------------------------
# checkpoints, both ways
# ---------------------------------------------------------------------------
def _checkpoint_pair(arch, dtype):
    """(jax params, jax AdamWState, port model, port AdamWState) holding the
    same values bit for bit: the port's loaded from the JAX trees."""
    from repro.configs import get_config as jax_config
    from repro.models.registry import get_model as jax_model
    from repro.optim import adamw as jadamw
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw
    from repro_torch.weights import params_from_jax
    jcfg = jax_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    if dtype == "bfloat16":
        jcfg, tcfg = jcfg.replace(dtype=jnp.bfloat16), \
            tcfg.replace(dtype=torch.bfloat16)
    jp = jax_model(jcfg).init(jax.random.PRNGKey(4))
    jcfg_opt = jadamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    jp, jopt = jadamw.adamw_update(jcfg_opt, _random_grads(jp, 0.1),
                                   jadamw.init_adamw(jp), jp)
    tp = get_model(tcfg).init(0, device="cpu")
    tp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
    topt = adamw.init_adamw(tp)
    with torch.no_grad():
        for name, t in _flat(topt.mu).items():
            t.copy_(torch.from_numpy(np.array(_flat(jopt.mu)[name])))
        for name, t in _flat(topt.nu).items():
            t.copy_(torch.from_numpy(np.array(_flat(jopt.nu)[name])))
        topt.step.copy_(torch.from_numpy(np.array(jopt.step)))
    return jp, jopt, tp, topt


def _bits(a):
    a = np.asarray(a)
    return a.dtype.str, a.shape, a.tobytes()


def _npz(path):
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return {k: _bits(data[k]) for k in data.files}


CHECKPOINT_CASES = [("llama3.2-1b", "float32"), ("llama3.2-1b", "bfloat16"),
                    ("mamba2-130m", "float32"),
                    ("recurrentgemma-9b", "bfloat16"),
                    ("deepseek-v2-lite-16b", "float32")]


@pytest.mark.parametrize("arch, dtype", CHECKPOINT_CASES)
def test_port_checkpoint_loads_in_jax(arch, dtype, tmp_path):
    """The port writes; the file equals JAX's own of the same values (keys,
    dtypes — ``|V2`` for bfloat16 — bytes, manifest), and JAX's
    ``load_checkpoint`` reads it back bit for bit."""
    from repro.checkpoint.store import load_checkpoint as jax_load
    from repro.checkpoint.store import save_checkpoint as jax_save
    from repro_torch.checkpoint.store import save_checkpoint
    jp, jopt, tp, topt = _checkpoint_pair(arch, dtype)
    save_checkpoint(str(tmp_path / "port"), tp, topt, step=7,
                    extra={"arch": arch})
    jax_save(str(tmp_path / "jax"), jp, jopt, step=7, extra={"arch": arch})
    assert _npz(tmp_path / "port") == _npz(tmp_path / "jax")
    for f in ("manifest.json",):
        assert (tmp_path / "port" / f).read_text() == \
            (tmp_path / "jax" / f).read_text()
    params, opt, step, extra = jax_load(str(tmp_path / "port"), jp, jopt)
    assert (step, extra) == (7, {"arch": arch})
    for got, want in ((params, jp), (opt, jopt)):
        gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


@pytest.mark.parametrize("arch, dtype", CHECKPOINT_CASES)
def test_jax_checkpoint_loads_in_port(arch, dtype, tmp_path):
    """JAX writes; the port's ``load_checkpoint`` fills a fresh model and
    optimiser state bit for bit, bfloat16 leaves as bfloat16 (ROADMAP
    C6), and refuses a template of another type."""
    from repro.checkpoint.store import save_checkpoint as jax_save
    from repro_torch.checkpoint.store import load_checkpoint
    from repro_torch.optim.adamw import init_adamw
    jp, jopt, tp, topt = _checkpoint_pair(arch, dtype)
    jax_save(str(tmp_path), jp, jopt, step=3, extra={"k": 1})
    fresh = type(tp)(tp_cfg(tp, arch, dtype), torch.device("cpu"))
    params, opt, step, extra = load_checkpoint(str(tmp_path), fresh,
                                               init_adamw(fresh))
    assert (step, extra) == (3, {"k": 1})
    for (name, a), (_, b) in zip(tp.named_parameters(),
                                 params.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert int(opt.step) == int(topt.step)
    for moment in ("mu", "nu"):
        for name, t in _flat(getattr(topt, moment)).items():
            assert torch.equal(_flat(getattr(opt, moment))[name], t), name
    if dtype == "bfloat16":
        other = type(tp)(tp_cfg(tp, arch, "float32"), torch.device("cpu"))
        with pytest.raises(ValueError, match="bfloat16"):
            load_checkpoint(str(tmp_path), other)


def tp_cfg(tp, arch, dtype):
    from repro_torch.configs import get_config
    cfg = get_config(arch, reduced=True)
    return cfg.replace(dtype=getattr(torch, dtype))


def test_params_to_jax_inverts_params_from_jax():
    """Every family's port model back to the JAX tree: the same keys,
    shapes and values as the tree it was loaded from."""
    from repro_torch.weights import params_to_jax
    for arch in ARCHS:
        jm, jp, tm, tp = shared_models(arch)
        want = jax.tree.map(np.asarray, jp)
        got = params_to_jax(tp)
        assert jax.tree.structure(got) == jax.tree.structure(want), arch
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == w.dtype and g.shape == w.shape, arch
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_train_launcher_improves_and_writes_a_checkpoint(tmp_path):
    """``python -m repro_torch.launch.train --device cpu``: the reduced
    llama3.2-1b's loss improves over 30 steps, and the checkpoint loads in
    the port and in the JAX package."""
    from repro.checkpoint.store import load_checkpoint as jax_load
    from repro.configs import get_config as jax_config
    from repro.models.registry import get_model as jax_model
    from repro.optim.adamw import init_adamw as jax_init
    from repro_torch.checkpoint.store import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import init_adamw
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "30", "--batch", "4", "--seq", "32", "--ckpt", ckpt],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("[train] llama3.2-1b: ")
    assert any(ln.startswith("step    29  loss ") for ln in lines)
    assert "(improved)" in lines[-2], proc.stdout
    model = get_model(get_config("llama3.2-1b", reduced=True))
    fresh = model.init(1, device="cpu")
    params, opt, step, _ = load_checkpoint(ckpt, fresh, init_adamw(fresh))
    assert step == 30 and int(opt.step) == 30
    jm = jax_model(jax_config("llama3.2-1b", reduced=True))
    jp = jm.init(jax.random.PRNGKey(0))
    jparams, jopt, _, _ = jax_load(ckpt, jp, jax_init(jp))
    assert int(jopt.step) == 30
    np.testing.assert_array_equal(np.asarray(jparams["embed"]["table"]),
                                  params.embed.table.numpy())
