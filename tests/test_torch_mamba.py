"""The port's Mamba-2 slice against the JAX package: the plain SSD scan
against the JAX oracle (and, where the oracle overflows, against the
Pallas kernel in interpret mode), the reduced mamba2-130m's prefill and
decode on shared weights, ``StaticEngine.serve_batch`` token for token,
the launcher on the CPU, and the refusals of the paths that have no
SSM counterpart."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import assert_same_stream, prompts, shared_models

ARCH = "mamba2-130m"
#: float32 oracle parity, as tests/test_kernels.py holds the Pallas scan
SCAN_TOL = dict(atol=1e-5, rtol=0)
#: float32 model parity (sums of another order through two layers)
MODEL_TOL = 2e-5


@pytest.fixture(scope="module")
def models():
    return shared_models(ARCH)


def _scan_inputs(B, T, H, P, N, G, seed=0, dt_value=None):
    """x, dt, A, B, C as numpy, float32: dt softplus of a normal (or a
    constant), A = -exp(0.2 z) per head, B/C per group."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    if dt_value is None:
        dt = np.log1p(np.exp(rng.standard_normal((B, T, H))))
    else:
        dt = np.full((B, T, H), dt_value)
    A = -np.exp(0.2 * rng.standard_normal(H))
    Bm = rng.standard_normal((B, T, G, N))
    Cm = rng.standard_normal((B, T, G, N))
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------
#: y's tolerance where 1e-5 does not hold: at (1,32,2,16,8,1,16) the two
#: y differ by 2.19e-5 at |y| 15.5 (the state by 6e-7).  Each is that far
#: from a float64 evaluation of the same maths (port 1.45e-5, oracle
#: 7.5e-6): the decay exponent cum_t - cum_s is a difference of
#: cumulative sums reaching |cum| ~ 18, which torch and XLA round in
#: other orders, and CB ~ 10 multiplies that error
SCAN_Y_ATOL_LONG_CHUNK = 3e-5


@pytest.mark.parametrize("B,T,H,P,N,G,Q,with_state,y_atol", [
    (1, 8, 1, 4, 4, 1, 4, False, SCAN_TOL["atol"]),
    (2, 24, 3, 8, 4, 1, 8, False, SCAN_TOL["atol"]),
    (1, 32, 2, 16, 8, 1, 16, False, SCAN_Y_ATOL_LONG_CHUNK),
    (2, 32, 4, 8, 4, 2, 8, False, SCAN_TOL["atol"]),
    (2, 24, 3, 8, 4, 1, 8, True, SCAN_TOL["atol"]),
])
def test_ssd_scan_ref_matches_jax_oracle(B, T, H, P, N, G, Q, with_state,
                                         y_atol):
    """The shapes of tests/test_kernels.py's scan sweep, one with two
    groups (head h reads group h // (H/G)) and one entering with a state:
    y and the final state within 1e-5 of the JAX oracle, which is finite
    at these sizes (y within ``SCAN_Y_ATOL_LONG_CHUNK`` at one shape)."""
    from repro.kernels.ref import ssd_scan_ref as jax_oracle
    from repro_torch.kernels.ref import ssd_scan_ref
    arrays = _scan_inputs(B, T, H, P, N, G)
    init = (np.random.default_rng(5).standard_normal((B, H, P, N))
            .astype(np.float32) if with_state else None)
    yj, sj = jax_oracle(*map(jnp.asarray, arrays), Q,
                        None if init is None else jnp.asarray(init))
    yt, st = ssd_scan_ref(*_torch(arrays), Q,
                          None if init is None else torch.from_numpy(init))
    assert np.isfinite(np.asarray(yj)).all()
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=y_atol,
                               rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **SCAN_TOL)


def test_c2_oracle_overflows_where_the_port_follows_the_pallas_kernel():
    """ROADMAP C2: with dt = 1.5 and A = -1 a 64-token chunk sums dt·|A| to
    96 > ln(float32 max), so the JAX oracle's exp of the upper triangle
    overflows and its multiplicative mask gives NaN.  The port's plain
    version masks the exponent first: it is finite and equals the Pallas
    kernel (interpret mode) within 1e-5."""
    from repro.kernels.ref import ssd_scan_ref as jax_oracle
    from repro.kernels.ssd_scan import ssd_scan as pallas_scan
    from repro_torch.kernels.ref import ssd_scan_ref
    x, dt, A, Bm, Cm = _scan_inputs(1, 128, 2, 8, 8, 1, seed=3,
                                    dt_value=1.5)
    A = -np.ones(2, np.float32)
    yj, _ = jax_oracle(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 64)
    assert np.isnan(np.asarray(yj)).any()
    yt, st = ssd_scan_ref(*_torch((x, dt, A, Bm, Cm)), 64)
    assert torch.isfinite(yt).all() and torch.isfinite(st).all()
    Bh = np.broadcast_to(Bm, (1, 128, 2, 8))
    Ch = np.broadcast_to(Cm, (1, 128, 2, 8))
    yp, sp = pallas_scan(*map(jnp.asarray, (x, dt, A, Bh, Ch)), 64,
                         interpret=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yp), **SCAN_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sp), **SCAN_TOL)


def _four_passes(x, dt, A, Bm, Cm, Q):
    """A test-only statement, in numpy float32, of the four passes of
    ``csrc/ssd_scan.cu``: (1) CB = C·Bᵀ once per (row, chunk, group); (2)
    per (row, chunk, head) cum, e^{cum_last} and S_loc = Σ_s e^{cum_last −
    cum_s} dt_s x_s ⊗ B_s; (3) per (row, head) the entering states S_in[c]
    = e^{cum_last[c−1]} S_in[c−1] + S_loc[c−1]; (4) y = e^{cum_t} C_t·S_in
    + Σ_{s≤t} CB[t,s] e^{cum_t − cum_s} dt_s x_s, masked before anything
    reaches y.  Every exponent is clamped at 0, as the kernel clamps the
    scan's rounding; none is positive, so numpy's overflow check, raised
    to an error here, never fires."""
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc, rep = T // Q, H // G
    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, G, N)
    Cc = Cm.reshape(Bsz, nc, Q, G, N)
    with np.errstate(over="raise", invalid="raise"):
        CB = np.einsum("bctgn,bcsgn->bcgts", Cc, Bc)              # pass 1
        cum = np.cumsum(dtc * A, axis=2)                          # pass 2
        w = np.exp(np.minimum(cum[:, :, -1:] - cum, 0)) * dtc
        decay = np.exp(cum[:, :, -1])                             # (B,nc,H)
        S_loc = np.einsum("bcsh,bcshp,bcshn->bchpn", w, xc,
                          np.repeat(Bc, rep, axis=3))
        S_in = np.zeros_like(S_loc)                               # pass 3
        state = np.zeros((Bsz, H, P, N), np.float32)
        for c in range(nc):
            S_in[:, c] = state
            state = decay[:, c, :, None, None] * state + S_loc[:, c]
        causal = np.tril(np.ones((Q, Q), bool))                   # pass 4
        diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (t, s)
        M = np.where(causal[None, None, :, :, None],
                     np.repeat(CB, rep, axis=2).transpose(0, 1, 3, 4, 2)
                     * np.exp(np.minimum(diff, 0)) * dtc[:, :, None], 0)
        y = (np.einsum("bcthn,bchpn->bcthp", np.repeat(Cc, rep, axis=3),
                       S_in) * np.exp(cum)[..., None]
             + np.einsum("bctsh,bcshp->bcthp", M, xc))
    return y.reshape(Bsz, T, H, P).astype(np.float32), state


@pytest.mark.parametrize("B,T,H,P,N,G,Q,dt_value", [
    (2, 24, 3, 8, 4, 1, 8, None),
    (2, 32, 4, 8, 4, 2, 8, None),
    (2, 48, 4, 8, 8, 2, 8, None),       # six chunks, two groups
    (1, 256, 2, 8, 8, 1, 64, 1.5),      # C2 in each of the four chunks
    (2, 192, 4, 4, 8, 2, 64, 1.5),      # C2, two rows and two groups
])
def test_four_pass_decomposition_matches_the_pallas_kernel(B, T, H, P, N, G,
                                                           Q, dt_value):
    """The kernel's algorithm before any chip time: the four passes give
    the Pallas kernel's y and final state (interpret mode) within
    ``SCAN_TOL``, finite also where every chunk's Σ dt·|A| passes 88.7 and
    the JAX oracle is NaN (ROADMAP C2).  Random dt takes chunks of 8: at
    chunks of 64 the cumulative sums reach |cum| ~ 57, whose float32
    rounding puts the port's plain version, the Pallas kernel and this
    statement each ~5e-5 from a float64 evaluation of y (|y| ~ 36); the
    C2 cases' constant dt sums exactly."""
    from repro.kernels.ref import ssd_scan_ref as jax_oracle
    from repro.kernels.ssd_scan import ssd_scan as pallas_scan
    x, dt, A, Bm, Cm = _scan_inputs(B, T, H, P, N, G, seed=4,
                                    dt_value=dt_value)
    if dt_value is not None:
        A = -np.ones(H, np.float32)
        yj, _ = jax_oracle(*map(jnp.asarray, (x, dt, A, Bm, Cm)), Q)
        assert np.isnan(np.asarray(yj)).any()
        assert ((dt * -A).reshape(B, T // Q, Q, H).sum(2) > 88.8).all()
    y, state = _four_passes(x, dt, A, Bm, Cm, Q)
    assert np.isfinite(y).all() and np.isfinite(state).all()
    Bh, Ch = (np.repeat(m, H // G, axis=2) for m in (Bm, Cm))
    yp, sp = pallas_scan(*map(jnp.asarray, (x, dt, A, Bh, Ch)), Q,
                         interpret=True)
    np.testing.assert_allclose(y, np.asarray(yp), **SCAN_TOL)
    np.testing.assert_allclose(state, np.asarray(sp), **SCAN_TOL)


def _sequential_f64(x, dt, A, Bm, Cm):
    """The SSM the chunked scan computes, step by step in float64: h_t =
    e^{dt_t A} h_{t-1} + dt_t x_t ⊗ B_t, y_t = h_t · C_t (group h // (H/G)
    serving head h).  Returns (y (B,T,H,P), final state (B,H,P,N))."""
    Bsz, T, H, P = x.shape
    rep = H // Bm.shape[2]
    x, dt, A = (a.astype(np.float64) for a in (x, dt, A))
    Bh, Ch = (np.repeat(m, rep, axis=2).astype(np.float64) for m in (Bm, Cm))
    h = np.zeros((Bsz, H, P, Bm.shape[3]))
    y = np.zeros((Bsz, T, H, P))
    for t in range(T):
        h = (np.exp(dt[:, t] * A)[..., None, None] * h
             + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None])
        y[:, t] = np.einsum("bhpn,bhn->bhp", h, Ch[:, t])
    return y, h


#: C4: the port's plain scan no farther from a float64 evaluation than the
#: Pallas kernel is, at most by this factor.  Both round the decay
#: exponent cum_t - cum_s as a difference of float32 cumulative sums, torch
#: and XLA in other orders, so neither is exact and their errors differ by
#: rounding alone; a factor of 2 admits that and refuses an error the port
#: adds of its own
C4_FACTOR = 2.0


@pytest.mark.parametrize("B,T,H", [(1, 256, 2), (2, 384, 3)])
def test_ssd_scan_ref_at_the_served_chunk_is_as_close_to_float64_as_pallas(
        B, T, H):
    """ROADMAP C4: mamba2-130m's heads (P 64, N 128, one group) at the
    chunk it serves (128), random dt = softplus(z - 1.5) kept below the C2
    threshold (every chunk's Σ dt·|A| < 88.7, so all three are finite).
    The port's plain version (the function B7 follows) and the Pallas
    kernel (interpret mode) are each held against the float64 recurrence,
    relative to its largest |y| (and |state|): the port no farther than
    ``C4_FACTOR`` times the Pallas kernel's distance."""
    from repro.kernels.ssd_scan import ssd_scan as pallas_scan
    from repro_torch.kernels.ref import ssd_scan_ref
    P, N, Q = 64, 128, 128
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)) - 1.5)).astype(
        np.float32)
    A = (-np.exp(0.2 * rng.standard_normal(H))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, T, 1, N)).astype(np.float32)
              for _ in range(2))
    sums = (dt * -A).reshape(B, T // Q, Q, H).sum(2)
    assert (sums < 88.7).all() and sums.max() > 20
    y64, s64 = _sequential_f64(x, dt, A, Bm, Cm)
    yt, st = ssd_scan_ref(*_torch((x, dt, A, Bm, Cm)), Q)
    Bh, Ch = (np.repeat(m, H, axis=2) for m in (Bm, Cm))
    yp, sp = pallas_scan(*map(jnp.asarray, (x, dt, A, Bh, Ch)), Q,
                         interpret=True)
    for port, pallas, want in ((yt.numpy(), np.asarray(yp), y64),
                               (st.numpy(), np.asarray(sp), s64)):
        e_port, e_pallas = _rel(port, want), _rel(pallas, want)
        assert e_port <= C4_FACTOR * e_pallas, (e_port, e_pallas)


def _rel(got, want):
    """Largest |got - want| relative to the largest |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("B,T,H,P,N,G,Q", [
    (8, 512, 24, 64, 128, 1, 128),      # chip_smoke.py's B7 shape
    (1, 1024, 24, 64, 128, 1, 128),     # one row of eight chunks
    (2, 640, 24, 64, 128, 1, 128),
    (1, 1408, 24, 64, 128, 1, 128),     # a re-prefill of eleven chunks
    (2, 24, 3, 8, 4, 1, 8),             # the reduced shapes' scale
    (1, 504, 6, 12, 20, 3, 36),         # no tile filled
    (1, 768, 2, 136, 132, 2, 256),      # two row tiles, three P tiles
])
def test_ssd_kernel_plan(B, T, H, P, N, G, Q):
    """The wrapper's host-side plan: scratch of the passes' shapes, grids
    that cover every (row, chunk, group) tile of the lower triangle and
    every (row, chunk, head) tile, and at mamba2-130m's widths at least
    two blocks of each pass per SM, with 192 (row, chunk, head) blocks in
    passes 2 and 4 at one row of 1,024 tokens."""
    from repro_torch.kernels import ssd_scan as kmod
    pl = kmod.plan(B, T, H, P, N, G, Q)
    nc = T // Q
    assert pl["nc"] == nc
    assert pl["scratch"] == {"cb": (B, nc, G, Q, Q),
                             "state": (B, nc, H, P, N),
                             "cum": (B, nc, H, Q), "decay": (B, nc, H)}
    nt = -(-Q // kmod.CB_TILE)
    tiles_y = {"cb": nt * (nt + 1) // 2,
               "state": -(-P // 64) * -(-N // 128),
               "pass": -(-P * N // (4 * kmod.PASS_THREADS)),
               "output": -(-Q // 128) * -(-P // 64)}
    tiles_x = {"cb": B * nc * G, "state": B * nc * H, "pass": B * H,
               "output": B * nc * H}
    assert pl["grids"] == {k: (tiles_x[k], tiles_y[k]) for k in tiles_x}
    assert pl["smem"]["pass"] == 0
    assert max(pl["smem"].values()) <= kmod.MAX_SMEM
    if (P, N, Q) == (64, 128, 128):
        assert all(2 * v <= kmod.MAX_SMEM for v in pl["smem"].values())
        assert pl["grids"]["state"][1] == pl["grids"]["output"][1] == 1
        if (B, T) == (1, 1024):
            assert pl["grids"]["state"][0] == pl["grids"]["output"][0] \
                == 192


@pytest.mark.parametrize("shape,match", [
    ((1, 32, 4, 8, 8, 1, 12), "multiple of the chunk"),
    ((1, 32, 4, 8, 8, 3, 8), "of G"),
    ((1, 30, 4, 8, 8, 1, 6), "multiples of 4"),
    ((1, 32, 4, 6, 8, 1, 8), "multiples of 4"),
    ((1, 32, 4, 8, 6, 1, 8), "multiples of 4"),
    ((1, 32768, 1, 4, 4, 1, 32768), "shared memory"),
    ((1, 8, 1, 8192, 8192, 1, 8), "blocks in y"),
])
def test_ssd_kernel_plan_refuses_what_the_kernel_does_not_take(shape, match):
    from repro_torch.kernels import ssd_scan as kmod
    with pytest.raises(ValueError, match=match):
        kmod.plan(*shape)


def test_ssd_kernel_plan_takes_every_shape_the_one_block_kernel_took():
    """The kernel it replaces held x, B, C, the state and a score tile of a
    (row, head) in one block's shared memory; every chunk, P and N that
    fitted there fits the passes' tiles."""
    from repro_torch.kernels import ssd_scan as kmod
    for Q in range(4, 1025, 4):
        for P, N in ((4, 4), (64, 128), (128, 128)):
            R = min(Q, 32)
            while Q % R:
                R -= 4
            old = 4 * (Q * P + 2 * Q * (N + 1) + P * (N + 1)
                       + R * (Q + 1) + 4 * Q)
            if old <= kmod.MAX_SMEM:
                kmod.plan(1, Q, 2, P, N, 1, Q)


def test_ssd_ops_takes_the_plain_version_on_cpu_and_counts_it():
    from repro_torch.kernels import ops, ref
    arrays = _torch(_scan_inputs(2, 16, 4, 8, 4, 2))
    ops.reset_counts()
    y, s = ops.ssd_chunked_scan(*arrays, chunk=8)
    assert ops.plain_calls["ssd_scan"] == 1
    assert ops.launches()["ssd_scan"] == 0
    want = ref.ssd_scan_ref(*arrays, 8)
    assert torch.equal(y, want[0]) and torch.equal(s, want[1])


def test_ssd_ops_refuses_a_t_that_is_no_chunk_multiple():
    from repro_torch.kernels import ops
    arrays = _torch(_scan_inputs(1, 12, 2, 4, 4, 1))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_chunked_scan(*arrays, chunk=8)


def test_ssd_ops_gives_no_other_device_the_plain_version():
    from repro_torch.kernels import ops
    arrays = [a.to("meta") for a in _torch(_scan_inputs(1, 8, 2, 4, 4, 1))]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.ssd_chunked_scan(*arrays, chunk=8)


def test_ssd_kernel_wrapper_refuses_what_it_does_not_take():
    """The CUDA wrapper imports without a card and checks its inputs
    before it builds anything: float32 only, on a CUDA device."""
    from repro_torch.kernels import ssd_scan as kmod
    arrays = _torch(_scan_inputs(1, 8, 2, 4, 4, 1))
    with pytest.raises(TypeError, match="float32"):
        kmod.ssd_scan(*[a.to(torch.bfloat16) for a in arrays], 8)
    with pytest.raises(ValueError, match="CUDA"):
        kmod.ssd_scan(*arrays, 8)
    assert kmod.launches == 0


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _left_padded(vocab, lens, T, seed):
    toks = np.zeros((len(lens), T), np.int32)
    for b, (p, n) in enumerate(zip(prompts(vocab, lens, seed=seed), lens)):
        toks[b, T - n:] = p
    return toks, np.asarray(lens, np.int32)


def _prefill_both(models, toks, lens):
    jm, jp, tm, tp = models
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)}, 0)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                 "lengths": torch.from_numpy(lens)}, 0)
    return (jl, jc), (tl, tc)


def test_params_from_jax_carries_the_mamba_tree(models):
    """Every leaf of the JAX tree lands on a parameter of the same name
    (the stacked layer axis split per layer), perturbations included."""
    from repro_torch.weights import params_from_jax
    jm, jp, tm, tp = models
    sd = params_from_jax(jax.tree.map(np.asarray, jp))
    assert set(sd) == set(tp.state_dict())
    for name, t in sd.items():
        assert torch.equal(tp.state_dict()[name], t), name
    a_log = np.asarray(jp["layers"]["mixer"]["A_log"])
    assert len(np.unique(a_log)) == a_log.size  # heads differ


def test_ssm_scalars_stay_float32_in_a_bfloat16_model():
    """``A_log``, ``D`` and ``dt_bias`` are float32 in the bf16 model, as in
    JAX, so loading the JAX tree does not round them to bf16."""
    from repro.configs import get_config as jax_config
    from repro.models.registry import get_model as jax_model
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.weights import params_from_jax
    cfg = get_config(ARCH, reduced=True).replace(dtype=torch.bfloat16)
    jm = jax_model(jax_config(ARCH, reduced=True).replace(dtype=jnp.bfloat16))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    tree["layers"]["mixer"]["dt_bias"] = np.full(
        tree["layers"]["mixer"]["dt_bias"].shape, 0.1234567, np.float32)
    tp = get_model(cfg).init(0, device="cpu")
    tp.load_state_dict(params_from_jax(tree))
    mixer = tp.layers[1].mixer
    for p in (mixer.A_log, mixer.D, mixer.dt_bias):
        assert p.dtype == torch.float32
    assert float(mixer.dt_bias[0]) == np.float32(0.1234567)
    assert mixer.in_proj.w.dtype == mixer.conv_w.dtype == torch.bfloat16


def test_mamba_prefill_matches_jax(models):
    """Left-padded rows of 21, 13 and 5 tokens (T 24 pads to two chunks of
    16): last logits, SSD states and raw conv tails within 2e-5."""
    toks, lens = _left_padded(models[2].cfg.vocab_size, [21, 13, 5], 24, 1)
    (jl, jc), (tl, tc) = _prefill_both(models, toks, lens)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL)
    np.testing.assert_allclose(tc.state.numpy(), np.asarray(jc.state),
                               atol=MODEL_TOL)
    np.testing.assert_allclose(tc.conv.numpy(), np.asarray(jc.conv),
                               atol=MODEL_TOL)
    assert tc.lengths.tolist() == lens.tolist()


def test_mamba_decode_matches_jax(models):
    """Four greedy decode steps from that prefill: logits within 2e-5."""
    jm, jp, tm, tp = models
    toks, lens = _left_padded(tm.cfg.vocab_size, [21, 13, 5], 24, 1)
    (jl, jc), (tl, tc) = _prefill_both(models, toks, lens)
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for step in range(4):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(cur), jnp.asarray(step))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(cur), step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=MODEL_TOL)
        np.testing.assert_allclose(tc.state.numpy(), np.asarray(jc.state),
                                   atol=MODEL_TOL)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_mamba_decode_equals_prefill_of_the_extended_sequence(models):
    """The recurrence and the chunked scan compute one function: decoding
    k tokens after a prefill gives the logits of a prefill of prompt + k
    tokens (across a chunk boundary), and decoding a whole prompt from an
    empty cache gives its prefill's logits (tests/test_models.py's
    property)."""
    from repro_torch.models import mamba2
    jm, jp, tm, tp = models
    cfg = tm.cfg
    seq = prompts(cfg.vocab_size, [20], seed=4)[0]
    with torch.no_grad():
        _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(seq[None, :13]),
                                   "lengths": torch.tensor([13])}, 0)
        for t in range(13, 20):
            logits, cache = tm.decode_step(tp, cache,
                                           torch.from_numpy(seq[t:t + 1]), 0)
        want, _ = tm.prefill(tp, {"tokens": torch.from_numpy(seq[None]),
                                  "lengths": torch.tensor([20])}, 0)
        np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=1e-4)
        d_in, H, P, N, G, conv_dim = mamba2._dims(cfg)
        cache = mamba2.MambaCache(
            conv=torch.zeros((cfg.n_layers, 1, cfg.ssm_conv_width - 1,
                              conv_dim)),
            state=torch.zeros((cfg.n_layers, 1, H, P, N)),
            lengths=torch.zeros((1,), dtype=torch.int32))
        for t in range(20):
            logits, cache = tm.decode_step(tp, cache,
                                           torch.from_numpy(seq[t:t + 1]), t)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=1e-4)


def test_mamba_left_padding_does_not_change_a_row(models):
    """A prompt alone and the same prompt behind left pads in a batch
    (padded to another chunk count) give the same logits and state."""
    jm, jp, tm, tp = models
    p = prompts(tm.cfg.vocab_size, [11], seed=9)[0]
    with torch.no_grad():
        alone, ca = tm.prefill(tp, {"tokens": torch.from_numpy(p[None]),
                                    "lengths": torch.tensor([11])}, 0)
        toks = np.zeros((2, 40), np.int32)
        toks[0, 29:] = p
        toks[1] = prompts(tm.cfg.vocab_size, [40], seed=10)[0]
        both, cb = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                   "lengths": torch.tensor([11, 40])}, 0)
    np.testing.assert_allclose(both[0].numpy(), alone[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(cb.state[:, 0].numpy(), ca.state[:, 0].numpy(),
                               atol=1e-5)
    np.testing.assert_array_equal(cb.conv[:, 0].numpy(), ca.conv[:, 0].numpy())


def test_mamba_init_follows_the_jax_recipe_and_needs_a_device(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    model = get_model(get_config(ARCH, reduced=True))
    assert model.kv_bytes_per_token() == 0.0
    a = model.init(3, device="cpu")
    b = model.init(3, device="cpu")
    assert torch.equal(a.layers[1].mixer.conv_w, b.layers[1].mixer.conv_w)
    mixer = a.layers[0].mixer
    assert abs(float(mixer.conv_w.std()) - 0.2) < 2e-2
    assert float(mixer.conv_b.abs().max()) == float(mixer.A_log.abs().max()) \
        == float(mixer.dt_bias.abs().max()) == 0.0
    assert torch.equal(mixer.D, torch.ones_like(mixer.D))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)


# ---------------------------------------------------------------------------
# the engine, the launcher and the refusals
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines(models):
    from repro.engine.static_engine import StaticEngine as JaxEngine
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = models
    return (JaxEngine(jm, jp, eos_id=1, len_bucket=8),
            StaticEngine(tm, tp, eos_id=1, len_bucket=8, device="cpu"))


def _serve_both(engines, batch, slice_len, **kw):
    jeng, teng = engines
    want = jeng.serve_batch(batch, slice_len, **kw)
    got = teng.serve_batch(batch, slice_len, **kw)
    assert (got.steps, got.batch_input_len, got.batch_size,
            got.early_return, got.reprefill_tokens) == \
        (want.steps, want.batch_input_len, want.batch_size,
         want.early_return, want.reprefill_tokens)
    for p, a, b in zip(batch, want.results, got.results):
        assert_same_stream(p, a["tokens"], b["tokens"], arch=ARCH)
        for key in ("n_valid", "finished", "invalid", "pad"):
            assert b[key] == a[key], key
    return got


def test_serve_batch_matches_jax_with_reprefill(engines, models):
    """Prompts of 5, 13 and 9 tokens with forced lengths 8, 3 and 8 (a
    batch bucket of 4, so one pad row), in slices of 4: the second slice
    re-prefills prompt + generated of the two unfinished rows."""
    vocab = models[2].cfg.vocab_size
    ps = prompts(vocab, [5, 13, 9], seed=21)
    first = _serve_both(engines, ps, 4, forced_gen_lens=[8, 3, 8])
    assert first.reprefill_tokens == 0 and first.steps == 4
    gen = [r["tokens"] for r in first.results]
    second = _serve_both(engines, [ps[0], ps[2]], 4, forced_gen_lens=[4, 4],
                         already_generated=[gen[0], gen[2]])
    assert second.reprefill_tokens == (5 + 4) + (9 + 4)
    one_shot = _serve_both(engines, ps, 8, forced_gen_lens=[8, 3, 8])
    for i, s in ((0, 0), (2, 1)):
        assert gen[i] + second.results[s]["tokens"] == \
            one_shot.results[i]["tokens"]


def test_serve_batch_eos_driven_row_matches_jax(engines, models):
    got = _serve_both(engines, prompts(models[2].cfg.vocab_size, [6, 17],
                                       seed=22), 8)
    for r in got.results:
        assert 1 <= r["n_valid"] <= 8


def test_launcher_serves_mamba_through_dense_scls_on_cpu():
    """``--arch mamba2-130m --reduced --device cpu``: every request
    completes, requests that outlive a slice re-prefill, and the only
    kernel wrappers called are ssd_scan's and the decode loop's condition
    (graph_loop), on their plain versions."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_counts()
    m = serve.main(["--backend", "real", "--arch", ARCH, "--reduced",
                    "--device", "cpu", "--max-input", "64", "--max-gen",
                    "16", "--slice-len", "8"])
    assert m.n_requests >= 4 and m.n_completed == m.n_requests
    assert m.reprefill_tokens > 0
    assert ops.plain_calls["ssd_scan"] > 0
    assert ops.plain_calls["graph_loop"] > 0
    assert not any(n for k, n in ops.plain_calls.items()
                   if k not in ("ssd_scan", "graph_loop"))
    assert not any(ops.launches().values())


@pytest.mark.parametrize("extra, match", [
    (["--kv-layout", "paged", "--kv-retain", "request"], "dense family"),
    (["--kv-layout", "paged"], "holds no page"),
])
def test_launcher_refuses_paged_paths_for_mamba(extra, match, capsys):
    """The persistent paged engine is dense-only, and a paged memory model
    over Δ = 0 bytes per token has no page (the JAX launcher's zero-block
    pool)."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match=match):
        serve.main(["--backend", "real", "--arch", ARCH, "--reduced",
                    "--device", "cpu"] + extra)


def test_engines_without_an_ssm_path_refuse_mamba(models):
    from repro_torch.engine.continuous_engine import ContinuousEngine
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = models
    with pytest.raises(ValueError, match="dense family only"):
        StaticEngine(tm, tp, kv_layout="paged", kv_pool_tokens=64,
                     page_tokens=8, device="cpu")
    with pytest.raises(ValueError, match="dense family only"):
        ContinuousEngine(tm, tp, device="cpu")


# ---------------------------------------------------------------------------
# the near-tie rule shared with chip_smoke.py
# ---------------------------------------------------------------------------
def test_stream_tie_accepts_equal_streams_and_refuses_other_partings(models):
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.testing import prefill_logits, stream_tie
    jm, jp, tm, tp = models
    ref = prefill_logits(tm, tp)
    p = prompts(tm.cfg.vocab_size, [7], seed=30)[0]
    res = StaticEngine(tm, tp, eos_id=-1, len_bucket=8,
                       device="cpu").serve_batch([p], 6, forced_gen_lens=[6])
    stream = res.results[0]["tokens"]
    assert stream_tie(ref, p, stream, stream) is None
    flipped = stream[:2] + [(stream[2] + 1) % tm.cfg.vocab_size] + stream[3:]
    with pytest.raises(AssertionError, match="no near-tie"):
        stream_tie(ref, p, stream, flipped)
    with pytest.raises(AssertionError, match="lengths differ"):
        stream_tie(ref, p, stream, stream[:-1])


def test_stream_tie_returns_the_gap_where_the_reference_nearly_ties():
    """The reference sees the context up to the parting token only, and a
    top-2 gap below ``NEAR_TIE`` is returned rather than raised."""
    from repro_torch.testing import NEAR_TIE, stream_tie
    seen = []

    def ref(ctx):
        seen.append(ctx.tolist())
        logits = np.zeros(8, np.float32)
        logits[[3, 5]] = 1.0, 1.0 - NEAR_TIE / 2
        return logits

    gap = stream_tie(ref, [9, 9], [4, 3, 7], [4, 5, 6])
    assert gap == pytest.approx(NEAR_TIE / 2, rel=1e-3)
    assert seen == [[9, 9, 4]]
