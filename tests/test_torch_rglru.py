"""The port's RG-LRU hybrid (recurrentgemma-9b) against the JAX package at
its reduced float32 size (5 layers: one (rec, rec, attn) group and a
recurrent tail of two; MQA 4/1; a local window of 64), and B6's plain
version at recurrentgemma-9b's group of 16 query heads per KV head.

Tolerances: float32 values within ``TOL`` = 2e-5 (as
tests/test_kernels.py holds the float32 kernels).  The log-depth scan adds
in another order than ``jax.lax.associative_scan``, so it is held to that
tolerance, not bit for bit.  Greedy streams equal but for a recorded
near-tie (``repro_torch.testing.stream_tie``).  JAX's init makes every
RG-LRU channel alike (``lambda`` 1, conv_b 0); ``torch_port.shared_models``
draws them apart on both sides."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jrg
from repro_torch.models import rglru as trg
from torch_port import assert_same_stream, prompts, shared_models

ARCH = "recurrentgemma-9b"
TOL = 2e-5


@pytest.fixture(scope="module")
def models():
    return shared_models(ARCH)


def _configs(reduced=True):
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config as torch_config
    return jax_config(ARCH, reduced), torch_config(ARCH, reduced)


# ---------------------------------------------------------------------------
# config and weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax_field_for_field(reduced):
    jcfg, tcfg = _configs(reduced)
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name == "dtype":
            got, want = str(got).split(".")[-1], jnp.dtype(want).name
        assert got == want, f.name
    assert (tcfg.n_rep, tcfg.d_lru) == (jcfg.n_rep, jcfg.d_lru)
    assert trg.n_groups_tail(tcfg) == jrg.n_groups_tail(jcfg)


def test_params_from_jax_carries_groups_and_tail(models):
    """The ``groups`` stack (each with its stack of two ``rec`` blocks and
    an ``attn`` block) and the ``tail`` stack land on
    ``groups.<g>.rec.<j>`` and ``tail.<i>``, perturbed channels
    included."""
    from repro_torch.weights import params_from_jax
    jm, jp, tm, tp = models
    sd = params_from_jax(jax.tree.map(np.asarray, jp))
    assert set(sd) == set(tp.state_dict())
    for name, t in sd.items():
        assert torch.equal(tp.state_dict()[name], t), name
    np.testing.assert_array_equal(tp.groups[0].rec[1].lam.numpy(),
                                  np.asarray(jp["groups"]["rec"]["lambda"][0,
                                                                           1]))
    assert len(tp.tail) == 2 and "groups.0.rec.1.lambda" in sd


def test_lambda_stays_float32_in_a_bfloat16_model():
    from repro.models.registry import get_model as jax_model
    from repro_torch.models.registry import get_model
    from repro_torch.weights import params_from_jax
    jcfg, tcfg = _configs()
    tree = jax.tree.map(np.array, jax_model(jcfg.replace(
        dtype=jnp.bfloat16)).init(jax.random.PRNGKey(1)))
    tree["tail"]["lambda"][:] = 0.1234567
    tp = get_model(tcfg.replace(dtype=torch.bfloat16)).init(0, device="cpu")
    tp.load_state_dict(params_from_jax(tree))
    assert tp.tail[1].lam.dtype == torch.float32
    assert float(tp.tail[1].lam[0]) == np.float32(0.1234567)
    assert tp.tail[1].lru_a.w.dtype == torch.bfloat16


def test_kv_bytes_per_token_counts_the_attention_layers_only():
    """Δ counts the n_layers // 3 = 12 local-attention layers of the full
    config: 2·12·1·256·2 bytes."""
    from repro.models.registry import get_model as jax_model
    from repro_torch.models.registry import get_model
    jcfg, tcfg = _configs(reduced=False)
    got = get_model(tcfg).kv_bytes_per_token()
    assert got == jax_model(jcfg).kv_bytes_per_token() == 12288


def test_init_follows_the_jax_recipe_and_needs_a_device(monkeypatch):
    from repro_torch.models.registry import get_model
    model = get_model(_configs()[1])
    a, b = model.init(3, device="cpu"), model.init(3, device="cpu")
    assert torch.equal(a.groups[0].rec[0].conv_w, b.groups[0].rec[0].conv_w)
    rec = a.tail[0]
    assert abs(float(rec.conv_w.std()) - 0.2) < 3e-2
    assert torch.equal(rec.lam, torch.ones_like(rec.lam))
    assert float(rec.conv_b.abs().max()) == 0.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)


# ---------------------------------------------------------------------------
# the RG-LRU pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,T,dl,with_h0", [(2, 1, 8, False),
                                            (2, 37, 16, False),
                                            (3, 300, 8, True),
                                            (1, 1280, 4, True)])
def test_assoc_scan_matches_jax(B, T, dl, with_h0):
    """The log-depth scan against ``jax.lax.associative_scan`` with the
    same combine, at odd and long T, entering with a state or not."""
    rng = np.random.default_rng(T)
    log_a = (-8.0 * rng.random((B, T, dl))).astype(np.float32)
    log_a[:, : T // 5] = 0.0  # identity steps, as at left pads
    b = rng.standard_normal((B, T, dl)).astype(np.float32)
    h0 = rng.standard_normal((B, dl)).astype(np.float32) if with_h0 else None
    want = jrg._assoc_scan(jnp.asarray(log_a), jnp.asarray(b),
                           None if h0 is None else jnp.asarray(h0))
    got = trg._assoc_scan(torch.from_numpy(log_a), torch.from_numpy(b),
                          None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def _rec_pair(models, g=0, j=1):
    jm, jp, tm, tp = models
    jblk = jax.tree.map(lambda x: x[g, j], jp["groups"]["rec"])
    return jm.cfg, jblk, tm.cfg, tp.groups[g].rec[j]


@pytest.mark.parametrize("with_tail", [False, True])
def test_conv_matches_jax(models, with_tail):
    jcfg, jblk, tcfg, tblk = _rec_pair(models)
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 11, tcfg.d_lru)).astype(np.float32)
    tail = (rng.standard_normal((2, tcfg.ssm_conv_width - 1, tcfg.d_lru))
            .astype(np.float32) if with_tail else None)
    want = jrg._conv(jblk, jnp.asarray(u),
                     None if tail is None else jnp.asarray(tail))
    with torch.no_grad():
        got = trg._conv(tblk, torch.from_numpy(u),
                        None if tail is None else torch.from_numpy(tail))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_rec_block_prefill_and_decode_match_jax(models):
    """``rec_block_forward`` over left-padded rows (the block's output,
    its final LRU state and its raw conv tail), then three
    ``rec_block_decode`` steps from that state."""
    jcfg, jblk, tcfg, tblk = _rec_pair(models)
    rng = np.random.default_rng(5)
    h = rng.standard_normal((3, 20, tcfg.d_model)).astype(np.float32)
    valid = np.arange(20)[None] >= np.array([0, 7, 16])[:, None]
    jo = jrg.rec_block_forward(jblk, jnp.asarray(h), jnp.asarray(valid),
                               jcfg)
    with torch.no_grad():
        to = trg.rec_block_forward(tblk, torch.from_numpy(h),
                                   torch.from_numpy(valid), tcfg)
    for got, want in zip(to, jo):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    (_, jh, jconv), (_, th, tconv) = jo, to
    for _ in range(3):
        x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
        jx, jconv, jh = jrg.rec_block_decode(jblk, jnp.asarray(x), jconv, jh,
                                             jcfg)
        with torch.no_grad():
            tx, tconv, th = trg.rec_block_decode(tblk, torch.from_numpy(x),
                                                 tconv, th, tcfg)
        for got, want in ((tx, jx), (tconv, jconv), (th, jh)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _left_padded(vocab, lens, T, seed):
    toks = np.zeros((len(lens), T), np.int32)
    for b, (p, n) in enumerate(zip(prompts(vocab, lens, seed=seed), lens)):
        toks[b, T - n:] = p
    return toks, np.asarray(lens, np.int32)


@pytest.mark.parametrize("lens,T,n_steps", [
    ([21, 13, 5], 24, 3),      # the ring holds the prompt
    ([80, 61, 9], 80, 3),      # the local window of 64 bites; ring wraps
])
def test_forward_prefill_and_decode_match_jax(models, lens, T, n_steps):
    """``forward``'s logits at every position, ``prefill``'s last logits
    and caches (LRU states, conv tails, the attention ring), then greedy
    ``decode_step``s, within TOL of JAX's."""
    jm, jp, tm, tp = models
    toks, lens = _left_padded(tm.cfg.vocab_size, lens, T, seed=1)
    jf = jrg.forward(jp, jm.cfg, jnp.asarray(toks), jnp.asarray(lens))
    with torch.no_grad():
        tf = trg.forward(tp, tm.cfg, torch.from_numpy(toks),
                         torch.from_numpy(lens))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=TOL)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)}, T + 8)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                 "lengths": torch.from_numpy(lens)}, T + 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    for name in ("conv", "h", "attn_k", "attn_v", "tail_conv", "tail_h"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), atol=TOL)
    assert tc.write_idx == int(jc.write_idx)
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for step in range(n_steps):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(cur), jnp.asarray(step))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(cur), step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
        np.testing.assert_allclose(tc.h.numpy(), np.asarray(jc.h), atol=TOL)
        np.testing.assert_array_equal(tc.slot_pos.numpy(),
                                      np.asarray(jc.slot_pos))
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert tc.attn_k.shape[2] == min(64, T + 8)


def test_decode_equals_prefill_of_the_extended_sequence(models):
    """The one-step recurrence and the scan compute one function:
    decoding 7 tokens after a prefill of 13 gives the logits of a prefill
    of all 20."""
    jm, jp, tm, tp = models
    seq = prompts(tm.cfg.vocab_size, [20], seed=4)[0]
    with torch.no_grad():
        _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(seq[None, :13]),
                                   "lengths": torch.tensor([13])}, 24)
        for t in range(13, 20):
            logits, cache = tm.decode_step(tp, cache,
                                           torch.from_numpy(seq[t:t + 1]),
                                           t - 13)
        want, _ = tm.prefill(tp, {"tokens": torch.from_numpy(seq[None]),
                                  "lengths": torch.tensor([20])}, 24)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# the engine and the launcher
# ---------------------------------------------------------------------------
def test_serve_batch_matches_jax_over_two_slices(models):
    """``StaticEngine.serve_batch`` (dense) against JAX's engine: prompts
    of 5, 70 and 9 tokens (the 70-token row past the local window of 64)
    in slices of 4, then the two unfinished rows re-prefilled with what
    they generated; streams equal but for a recorded near-tie."""
    from repro.engine.static_engine import StaticEngine as JaxEngine
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = models
    jeng = JaxEngine(jm, jp, eos_id=1, len_bucket=8)
    teng = StaticEngine(tm, tp, eos_id=1, len_bucket=8, device="cpu")
    ps = prompts(tm.cfg.vocab_size, [5, 70, 9], seed=21)

    def both(batch, **kw):
        want = jeng.serve_batch(batch, 4, **kw)
        got = teng.serve_batch(batch, 4, **kw)
        assert (got.steps, got.batch_size, got.reprefill_tokens) == \
            (want.steps, want.batch_size, want.reprefill_tokens)
        for p, a, b in zip(batch, want.results, got.results):
            assert_same_stream(p, a["tokens"], b["tokens"], arch=ARCH)
        return got

    first = both(ps, forced_gen_lens=[8, 8, 3])
    gen = [r["tokens"] for r in first.results]
    second = both([ps[0], ps[1]], forced_gen_lens=[4, 4],
                  already_generated=[gen[0], gen[1]])
    assert second.reprefill_tokens == (5 + 4) + (70 + 4)


def test_launcher_serves_the_hybrid_through_dense_scls_on_cpu():
    """``--arch recurrentgemma-9b --reduced --device cpu``: every request
    completes, requests that outlive a slice re-prefill, the local
    attention goes through flash_prefill's and decode_attention's plain
    versions and the decode loop's condition through graph_loop's."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_counts()
    m = serve.main(["--backend", "real", "--arch", ARCH, "--reduced",
                    "--device", "cpu", "--max-input", "48", "--max-gen",
                    "12", "--slice-len", "6", "--duration", "4"])
    assert m.n_requests >= 4 and m.n_completed == m.n_requests
    assert m.reprefill_tokens > 0
    assert {k for k, n in ops.plain_calls.items() if n} == \
        {"flash_prefill", "decode_attention", "graph_loop"}
    assert not any(ops.launches().values())


def test_launcher_and_engine_refuse_the_persistent_paged_path(models):
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="dense family only"):
        serve.main(["--backend", "real", "--arch", ARCH, "--reduced",
                    "--device", "cpu", "--kv-layout", "paged",
                    "--kv-retain", "request"])
    jm, jp, tm, tp = models
    with pytest.raises(ValueError, match="dense family only"):
        StaticEngine(tm, tp, kv_layout="paged", kv_pool_tokens=64,
                     page_tokens=8, device="cpu")


# ---------------------------------------------------------------------------
# B6 at 16 query heads per KV head
# ---------------------------------------------------------------------------
def _ring_inputs(B, W, Hq, Hkv, D, seed=12):
    """A ring cache as the hybrid's local attention leaves it: one row
    wrapped (slot_pos rotated, positions past W), one not yet full, one
    empty."""
    rng = np.random.default_rng(seed)
    sp = np.full((B, W), -1, np.int32)
    sp[0] = (np.arange(W) - 5) % W + 3 * W
    sp[1, : W // 2] = np.arange(W // 2)
    qp = np.array([4 * W - 1, W // 2 - 1] + [0] * (B - 2), np.int32)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kc = rng.standard_normal((B, W, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, W, Hkv, D)).astype(np.float32)
    return q, kc, vc, sp, qp


@pytest.mark.parametrize("D", [32, 64, 256])
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("window", [None, 40])
def test_decode_attention_plain_at_group_16_matches_jax(D, dtype, atol,
                                                        window):
    """recurrentgemma-9b's MQA (16 query heads over one KV head) on a
    ring of 48 slots: the plain version (what ``ops.decode_attention``
    runs on the CPU) against the JAX oracle, the empty row the mean of
    its V."""
    import ml_dtypes
    from repro.kernels.ref import decode_attention_ref as oracle
    from repro_torch.kernels import ops
    q, kc, vc, sp, qp = _ring_inputs(3, 48, 16, 1, D)
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    tdt = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a.astype(npdt)) for a in (q, kc, vc))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, kc, vc))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(sp),
                               torch.from_numpy(qp), window=window)
    want = oracle(jq, jk, jv, jnp.asarray(sp), jnp.asarray(qp),
                  window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol)
    mean_v = tv[-1].float().mean(dim=0).repeat_interleave(16, 0)
    np.testing.assert_allclose(got[-1].float().numpy(), mean_v.numpy(),
                               atol=atol)


@pytest.mark.parametrize("G,want", [(1, 1), (6, 1), (8, 1), (12, 2),
                                    (16, 2), (9, 2), (71, 9)])
def test_decode_kernel_splits_a_group_above_8_into_head_blocks(G, want):
    """The kernel's blocks hold at most 8 query heads: a larger group runs
    as ceil(G / 8) blocks of ceil(G / blocks) heads, the last ragged and
    none empty (two 8-head halves at 16, 8 x 8 + 7 at 71), and groups up
    to 8 keep one block, as before; every group is taken."""
    from repro_torch.kernels import split
    r = split.head_blocks(G)
    gb = split.block_heads(G)
    assert r == want and gb <= split.BLOCK_GROUP and (r - 1) * gb < G <= r * gb
    assert split.supports(256, G, torch.bfloat16)


def test_decode_kernel_wrapper_refuses_cpu_tensors_at_group_16():
    """No fallback: the CUDA wrapper raises on CPU tensors at group 16, as
    at every group, and counts no launch."""
    from repro_torch.kernels import decode_attention as kmod
    q, kc, vc, sp, qp = (torch.from_numpy(a)
                         for a in _ring_inputs(3, 48, 16, 1, 64))
    before = kmod.launches
    with pytest.raises(ValueError, match="CUDA"):
        kmod.decode_attention(q, kc, vc, sp, qp, window=40)
    assert kmod.launches == before
