"""The port's MoE family against the JAX package at the reduced float32
sizes: mixtral-8x22b (GQA, sliding window) and deepseek-v2-lite-16b (MLA,
shared experts, a first dense layer).

Tolerances: float32 values within ``TOL`` = 2e-5 (as
tests/test_kernels.py holds the float32 kernels); the dispatch masks
(which token sits in which expert slot, which choices are dropped)
exactly equal; greedy streams equal but for a recorded near-tie
(``repro_torch.testing.stream_tie``).  The routing cases: capacity that
drops tokens, tied router probabilities (duplicated router columns and
all-zero rows, whose probabilities are uniform), and more tokens than one
dispatch group (B·T > 1024)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from torch_port import assert_same_stream, prompts, shared_models

TOL = 2e-5
ARCHS = ("mixtral-8x22b", "deepseek-v2-lite-16b")


def _configs(arch, reduced=True, **over):
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config as torch_config
    return (jax_config(arch, reduced).replace(**over),
            torch_config(arch, reduced).replace(**over))


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax_field_for_field(arch, reduced):
    """Every field the port's config has equals the JAX config's, the
    dtype by name."""
    jcfg, tcfg = _configs(arch, reduced)
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name == "dtype":
            got, want = str(got).split(".")[-1], jnp.dtype(want).name
        assert got == want, f.name
    assert (tcfg.n_rep, tcfg.d_lru) == (jcfg.n_rep, jcfg.d_lru)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_every_leaf(arch):
    """Every leaf of the JAX tree (the stacked experts, the float32
    router, the shared experts, the dense first layer) lands on a
    parameter of the same name with its values."""
    from repro_torch.weights import params_from_jax
    jm, jp, tm, tp = shared_models(arch)
    sd = params_from_jax(jax.tree.map(np.asarray, jp))
    assert set(sd) == set(tp.state_dict())
    for name, t in sd.items():
        assert torch.equal(tp.state_dict()[name], t), name
    assert tp.layers[0].moe.router.dtype == torch.float32
    if arch.startswith("deepseek"):
        assert len(tp.dense_layers) == 1 and tp.layers[0].moe.shared


@pytest.mark.parametrize("arch", ARCHS)
def test_router_stays_float32_in_a_bfloat16_model(arch):
    from repro.models.registry import get_model as jax_model
    from repro_torch.models.registry import get_model
    from repro_torch.weights import params_from_jax
    jcfg, tcfg = _configs(arch, dtype=jnp.bfloat16)
    tcfg = tcfg.replace(dtype=torch.bfloat16)
    tree = jax.tree.map(np.asarray, jax_model(jcfg).init(
        jax.random.PRNGKey(1)))
    tp = get_model(tcfg).init(0, device="cpu")
    tp.load_state_dict(params_from_jax(tree))
    moe = tp.layers[0].moe
    assert moe.router.dtype == torch.float32
    assert moe.experts.gate.w.dtype == torch.bfloat16
    np.testing.assert_array_equal(moe.router.numpy(),
                                  tree["layers"]["moe"]["router"][0])


@pytest.mark.parametrize("arch,want", [("deepseek-v2-lite-16b", 31104),
                                       ("mixtral-8x22b", 229376)])
def test_kv_bytes_per_token_equals_jax(arch, want):
    """Δ of Eq. 5 at the full configs: MLA caches the latent and the
    shared rope key, n_layers·(kv_lora_rank + qk_rope)·2 bytes."""
    from repro.models.registry import get_model as jax_model
    from repro_torch.models.registry import get_model
    jcfg, tcfg = _configs(arch, reduced=False)
    got = get_model(tcfg).kv_bytes_per_token()
    assert got == jax_model(jcfg).kv_bytes_per_token() == want
    assert get_model(tcfg).kv_bytes_per_token(4) == \
        jax_model(jcfg).kv_bytes_per_token(4)


def test_init_is_seeded_and_needs_a_device(monkeypatch):
    from repro_torch.models.registry import get_model
    _, tcfg = _configs("deepseek-v2-lite-16b")
    model = get_model(tcfg)
    a, b = model.init(3, device="cpu"), model.init(3, device="cpu")
    assert torch.equal(a.layers[0].moe.experts.up.w,
                       b.layers[0].moe.experts.up.w)
    assert abs(float(a.layers[0].moe.router.std()) - 0.02) < 5e-3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)


# ---------------------------------------------------------------------------
# routing and the MoE layer
# ---------------------------------------------------------------------------
def test_top_k_breaks_ties_toward_the_lower_index():
    """``jax.lax.top_k`` picks the lower index among equal values; the
    port's selection does too (``torch.topk`` promises nothing)."""
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 3, size=(64, 16)).astype(np.float32) / 4
    vals, idx = tmoe.top_k(torch.from_numpy(probs), 6)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def _layer_pair(arch, capacity_factor, seed=3, tied=False, **over):
    """(jax cfg, jax layer params, torch cfg, torch MoELayer) of the
    reduced ``arch`` (its MoE fields replaced), JAX's init carried over;
    ``tied`` gives experts 0, 1 and 2 one router column."""
    from repro_torch.weights import params_from_jax
    jcfg, tcfg = _configs(arch, capacity_factor=capacity_factor, **over)
    tree = jax.tree.map(np.array,
                        jmoe.init_moe_layer(jax.random.PRNGKey(seed), jcfg))
    if tied:
        tree["router"][:, 1] = tree["router"][:, 0]
        tree["router"][:, 2] = tree["router"][:, 0]
    tp = tmoe.MoELayer(tcfg, torch.device("cpu"))
    tp.load_state_dict(params_from_jax(tree))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tp


def dense_dispatch(r, n_experts, capacity):
    """The JAX package's one-hot (dispatch (g,E,C), combine (g,E,C))
    float32 tensors of the port's routing ``r``."""
    g, k = r.expert.shape
    dispatch = torch.zeros((g, n_experts, capacity), dtype=torch.float32)
    combine = torch.zeros_like(dispatch)
    tok = torch.arange(g)[:, None].expand(g, k)
    e, s, t = r.expert[r.keep], r.slot[r.keep], tok[r.keep]
    dispatch[t, e, s] = 1.0
    combine[t, e, s] = r.weight[r.keep]
    return dispatch, combine


def _groups(x, cfg):
    """x (B,T,d) as JAX groups it: (n, group, d), zero-padded, and the
    capacity."""
    B, T, d = x.shape
    g_total = B * T
    group = min(jmoe.MOE_GROUP, g_total)
    xf = x.reshape(g_total, d)
    xf = np.pad(xf, ((0, (-g_total) % group), (0, 0)))
    cap = max(1, int(group * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return xf.reshape(-1, group, d), cap


#: (arch, MoE fields, capacity factor, B, T, tied router, zero rows):
#: a case that drops nothing, capacity that drops, ties, deepseek's top-6
#: over 16 experts, and two groups (1,200 tokens, the second group padded
#: with 848 zero rows)
ROUTING_CASES = [
    ("mixtral-8x22b", {}, 4.0, 2, 24, False, 0),
    ("mixtral-8x22b", {}, 0.5, 2, 24, False, 0),
    ("mixtral-8x22b", {}, 1.0, 3, 16, True, 5),
    ("deepseek-v2-lite-16b", dict(n_experts=16, top_k=6), 1.25, 2, 40,
     False, 0),
    ("deepseek-v2-lite-16b", dict(n_experts=16, top_k=6), 1.25, 2, 24, True,
     4),
    ("mixtral-8x22b", {}, 1.25, 3, 400, False, 7),
]


@pytest.mark.parametrize("arch,over,cf,B,T,tied,zeros", ROUTING_CASES)
def test_dispatch_and_moe_apply_match_jax(arch, over, cf, B, T, tied, zeros):
    """Per group: the port's routing from JAX's router probabilities gives
    JAX's one-hot dispatch exactly and its combine weights within TOL,
    and the port's own router (float32 x @ router, softmax) routes every
    choice as JAX does; then ``moe_apply`` (shared experts included)
    equals JAX's within TOL.  The drop cases do drop, the others keep
    every choice."""
    jcfg, jp, tcfg, tp = _layer_pair(arch, cf, tied=tied, **over)
    rng = np.random.default_rng(B * T)
    x = rng.standard_normal((B, T, jcfg.d_model)).astype(np.float32)
    x.reshape(-1, jcfg.d_model)[rng.permutation(B * T)[:zeros]] = 0.0
    xg, cap = _groups(x, jcfg)
    n_dropped = 0
    for g in range(xg.shape[0]):
        jprobs = jax.nn.softmax(jnp.asarray(xg[g]) @ jp["router"], axis=-1)
        jdisp, jcomb = jmoe._dispatch(jprobs, jcfg.top_k, cap)
        r = tmoe._dispatch(torch.from_numpy(np.array(jprobs)), tcfg.top_k,
                           cap)
        disp, comb = dense_dispatch(r, tcfg.n_experts, cap)
        np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
        np.testing.assert_allclose(comb.numpy(), np.asarray(jcomb), atol=TOL)
        with torch.no_grad():
            own = tmoe._dispatch(torch.softmax(
                torch.from_numpy(xg[g]) @ tp.router, dim=-1), tcfg.top_k, cap)
        assert torch.equal(dense_dispatch(own, tcfg.n_experts, cap)[0],
                           disp)
        n_dropped += int((~r.keep).sum())
    if cf < 1.25 or T >= 400:
        assert n_dropped > 0
    elif cf == 4.0:
        assert n_dropped == 0
    want, _ = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("group", [1, 8, 37, 1024])
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_the_jax_formula(arch, reduced, group):
    """``moe.capacity`` (deepseek-v2-lite's decode group of 8: 1 slot an
    expert) equals the capacity of JAX's ``moe_apply`` for a group of
    ``group`` tokens."""
    jcfg, tcfg = _configs(arch, reduced)
    want = _groups(np.zeros((1, group, 1), np.float32), jcfg)[1]
    assert tmoe.capacity(tcfg, group) == want
    if arch == "deepseek-v2-lite-16b" and not reduced and group == 8:
        assert want == 1


def test_a_dropped_choice_weighs_nothing():
    """At capacity 1 per expert, the second token routed to an expert
    loses that choice: its output is its other choices' alone."""
    jcfg, jp, tcfg, tp = _layer_pair("mixtral-8x22b", 0.25)
    x = np.random.default_rng(4).standard_normal((1, 8, jcfg.d_model)
                                                 ).astype(np.float32)
    x[0, 1] = x[0, 0]  # token 1 picks token 0's experts: both dropped
    with torch.no_grad():
        got = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
        probs = torch.softmax(torch.from_numpy(x[0]) @ tp.router, dim=-1)
        r = tmoe._dispatch(probs, 2, 1)
    assert not r.keep[1].any() and r.keep[0].all()
    assert float(got[0, 1].abs().max()) == 0.0  # mixtral has no shared
    want, _ = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
def _mla_pair(seed=2):
    from repro_torch.weights import params_from_jax
    jcfg, tcfg = _configs("deepseek-v2-lite-16b")
    tree = jax.tree.map(np.array, jmla.init_mla(jax.random.PRNGKey(seed),
                                                jcfg))
    tree["ckv_norm"] = (0.3 * np.random.default_rng(seed).standard_normal(
        tree["ckv_norm"].shape)).astype(np.float32)
    tp = tmla.MLA(tcfg, torch.device("cpu"))
    tp.load_state_dict(params_from_jax(tree))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tp


def _positions(lens, T):
    from repro.models.transformer import make_positions
    return np.array(make_positions(jnp.zeros((len(lens), T), jnp.int32),
                                   jnp.asarray(lens, jnp.int32)))


@pytest.mark.parametrize("lens,T,W,window", [
    ([21, 13, 5], 24, 30, None),     # zero-padded cache
    ([21, 13, 5], 24, 16, 16),       # a ring of 16 behind a window
    ([2060], 2060, 2064, None),      # the q-blocked path (T >= 2048)
])
def test_mla_prefill_and_decode_match_jax(lens, T, W, window):
    """``mla_prefill``'s output and (c_kv, rope key) cache, then two
    ``mla_decode`` steps on the ring (slot_pos and the write slot as the
    model computes them), within TOL of JAX's."""
    from repro.models import attention as jattn
    jcfg, jp, tcfg, tp = _mla_pair()
    rng = np.random.default_rng(T)
    x = rng.standard_normal((len(lens), T, jcfg.d_model)).astype(np.float32)
    pos = _positions(lens, T)
    mask = None if T >= jattn.CHUNK_THRESHOLD else jattn.prefill_mask(
        jnp.asarray(pos), window)
    jo, jc, jr = jmla.mla_prefill(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                  window, W, mask)
    with torch.no_grad():
        to, tc, tr = tmla.mla_prefill(tp, torch.from_numpy(x),
                                      torch.from_numpy(pos), tcfg, window, W)
    for got, want in ((to, jo), (tc, jc), (tr, jr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    from repro_torch.models import attention as tattn
    slot_pos = np.array(jattn.prefill_slot_pos(jnp.asarray(pos), W))
    write_idx = T if W >= T else W
    tc, tr = tc.clone(), tr.clone()
    for step in range(2):
        q_pos = np.asarray(lens, np.int32) + step
        slot = write_idx % W
        slot_pos = slot_pos.copy()
        slot_pos[:, slot] = q_pos
        xd = rng.standard_normal((len(lens), 1, jcfg.d_model)
                                 ).astype(np.float32)
        jo, jc, jr = jmla.mla_decode(jp, jnp.asarray(xd), jnp.asarray(q_pos),
                                     jc, jr, jnp.asarray(slot_pos),
                                     jnp.asarray(slot), jcfg, window)
        with torch.no_grad():
            to = tmla.mla_decode(tp, torch.from_numpy(xd),
                                 torch.from_numpy(q_pos), tc, tr,
                                 torch.from_numpy(slot_pos), slot, tcfg,
                                 window)
        for got, want in ((to, jo), (tc, jc), (tr, jr)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=TOL)
        write_idx += 1
    assert tattn.decode_mask(torch.from_numpy(q_pos),
                             torch.from_numpy(slot_pos), window).shape == \
        (len(lens), 1, 1, W)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
def _left_padded(vocab, lens, T, seed):
    toks = np.zeros((len(lens), T), np.int32)
    for b, (p, n) in enumerate(zip(prompts(vocab, lens, seed=seed), lens)):
        toks[b, T - n:] = p
    return toks, np.asarray(lens, np.int32)


#: (arch, capacity factor, row lengths, T): the reduced capacity (4.0,
#: nothing dropped), then one that drops at prefill and decode; mixtral's
#: window of 64 bites at T 80 and its ring of 64 wraps while decoding
MODEL_CASES = [
    ("mixtral-8x22b", None, [80, 61, 9], 80),
    ("mixtral-8x22b", 0.75, [80, 61, 9], 80),
    ("deepseek-v2-lite-16b", None, [21, 13, 5], 24),
    ("deepseek-v2-lite-16b", 1.0, [21, 13, 5], 24),
]


@pytest.mark.parametrize("arch,cf,lens,T", MODEL_CASES)
def test_forward_prefill_and_decode_match_jax(arch, cf, lens, T):
    """``forward``'s logits at every position, ``prefill``'s last logits
    and three greedy ``decode_step``s (the MoE group the step's rows)
    within TOL of JAX's, and the caches' ``slot_pos`` equal."""
    jm, jp, tm, tp = shared_models(arch, capacity_factor=cf)
    toks, lens = _left_padded(tm.cfg.vocab_size, lens, T, seed=1)
    jf, _ = jmoe.forward(jp, jm.cfg, jnp.asarray(toks), jnp.asarray(lens))
    batch = {"tokens": torch.from_numpy(toks),
             "lengths": torch.from_numpy(lens)}
    with torch.no_grad():
        tf = tmoe.forward(tp, tm.cfg, batch["tokens"], batch["lengths"])
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=TOL)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)}, T + 8)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, batch, T + 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for step in range(3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(cur), jnp.asarray(step))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(cur), step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
        np.testing.assert_array_equal(tc.kv.slot_pos.numpy(),
                                      np.asarray(jc.kv.slot_pos))
        assert tc.kv.write_idx == int(jc.kv.write_idx)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    if arch.startswith("mixtral"):
        assert tc.kv.window == 64 < T  # the ring wrapped
    else:
        assert isinstance(tc.kv, tmla.MLACache)
        np.testing.assert_allclose(tc.dense_kv.ckv.numpy(),
                                   np.asarray(jc.dense_kv.ckv), atol=TOL)


def test_decode_capacity_of_one_drops_as_jax_does():
    """deepseek's decode at B <= 8 has cap = max(1, int(B·6·1.25/64)) = 1:
    a second row routed to an expert loses that choice.  At the reduced
    sizes (4 experts, top-2, capacity 0.5) cap is 1 for 3 rows too; the
    logits of two decode steps equal JAX's, where rows do lose choices."""
    jm, jp, tm, tp = shared_models("deepseek-v2-lite-16b",
                                   capacity_factor=0.5)
    assert max(1, int(3 * 2 * 0.5 / 4)) == 1
    toks, lens = _left_padded(tm.cfg.vocab_size, [9, 7, 3], 12, seed=5)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)}, 16)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                 "lengths": torch.from_numpy(lens)}, 16)
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for step in range(2):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(cur), jnp.asarray(step))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(cur), step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


# ---------------------------------------------------------------------------
# the engine and the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,cf", [("mixtral-8x22b", None),
                                     ("deepseek-v2-lite-16b", None),
                                     ("deepseek-v2-lite-16b", 1.25)])
def test_serve_batch_matches_jax_over_two_slices(arch, cf):
    """``StaticEngine.serve_batch`` (dense) against JAX's engine: prompts
    of 5, 13 and 9 tokens (a batch bucket of 4: one pad row, which
    competes for expert capacity) in slices of 4, then the two unfinished
    rows re-prefilled with what they generated; streams equal but for a
    recorded near-tie.  ``cf`` 1.25 is the full configs' capacity."""
    from repro.engine.static_engine import StaticEngine as JaxEngine
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = shared_models(arch, capacity_factor=cf)
    jeng = JaxEngine(jm, jp, eos_id=1, len_bucket=8)
    teng = StaticEngine(tm, tp, eos_id=1, len_bucket=8, device="cpu")
    ps = prompts(tm.cfg.vocab_size, [5, 13, 9], seed=21)

    def both(batch, **kw):
        want = jeng.serve_batch(batch, 4, **kw)
        got = teng.serve_batch(batch, 4, **kw)
        assert (got.steps, got.batch_size, got.reprefill_tokens) == \
            (want.steps, want.batch_size, want.reprefill_tokens)
        for p, a, b in zip(batch, want.results, got.results):
            assert_same_stream(p, a["tokens"], b["tokens"], arch=arch,
                               capacity_factor=cf)
        return got

    first = both(ps, forced_gen_lens=[8, 3, 8])
    gen = [r["tokens"] for r in first.results]
    second = both([ps[0], ps[2]], forced_gen_lens=[4, 4],
                  already_generated=[gen[0], gen[2]])
    assert second.reprefill_tokens == (5 + 4) + (9 + 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_moe_through_dense_scls_on_cpu(arch):
    """``--arch <moe> --reduced --device cpu``: every request completes,
    requests that outlive a slice re-prefill; mixtral's attention goes
    through flash_prefill's and decode_attention's plain versions, MLA's
    through neither (plain torch by design); both test the decode loop's
    condition through graph_loop's."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_counts()
    m = serve.main(["--backend", "real", "--arch", arch, "--reduced",
                    "--device", "cpu", "--max-input", "48", "--max-gen",
                    "12", "--slice-len", "6", "--duration", "4"])
    assert m.n_requests >= 4 and m.n_completed == m.n_requests
    assert m.reprefill_tokens > 0
    used = {k for k, n in ops.plain_calls.items() if n}
    assert used == ({"graph_loop"} if arch.startswith("deepseek")
                    else {"flash_prefill", "decode_attention", "graph_loop"})
    assert not any(ops.launches().values())


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_refuses_the_persistent_paged_engine(arch):
    """As the JAX launcher: ``--kv-retain request`` drives the paged
    engine, which is dense-family only; so does ``StaticEngine``."""
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="dense family only"):
        serve.main(["--backend", "real", "--arch", arch, "--reduced",
                    "--device", "cpu", "--kv-layout", "paged",
                    "--kv-retain", "request"])
    jm, jp, tm, tp = shared_models(arch)
    with pytest.raises(ValueError, match="dense family only"):
        StaticEngine(tm, tp, kv_layout="paged", kv_pool_tokens=64,
                     page_tokens=8, device="cpu")
