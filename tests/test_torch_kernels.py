"""The port's kernel modules (``repro_torch.kernels``) against the JAX
package: each plain version is held against the Pallas kernel (run in
interpret mode, as the JAX tests run it on the CPU) and the jnp oracle on
the same numpy inputs; the dispatch takes the plain version for CPU
tensors only.  The CUDA kernels themselves are checked on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import \
    decode_attention as pallas_dense_decode
from repro.kernels.flash_prefill import flash_prefill as pallas_prefill
from repro.kernels.fused_rope_decode_append import \
    fused_rope_decode_append as pallas_fused_decode
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as pallas_paged_decode
from repro_torch.kernels import fused_rope_decode_append as fdecode_kernel
from repro_torch.kernels import fused_rope_prefill_write as fwrite_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_decode_attention as decode_kernel
from repro_torch.kernels import paged_prefill_write as write_kernel

#: float32 tolerance of the JAX kernel tests (tests/test_kernels.py)
ATOL_F32 = 2e-5
#: the JAX kernel tests' table, by dtype name (tests/test_kernels.py:35)
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
THETA = 5e5  # llama3.2-1b's rope theta: angles of hundreds of radians


def _paged_inputs(B, nb, pg, Hq, Hkv, D, seed=0, pad_row=False):
    """Random pools, shuffled block tables and compact slot_pos; with
    ``pad_row`` the last row is a batch-bucket pad row (null pages only,
    every slot masked)."""
    rng = np.random.default_rng(seed)
    P = B * nb + 1
    kp = rng.standard_normal((P, pg, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, pg, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    bt = np.zeros((B, nb), np.int32)
    slot_pos = np.full((B, nb * pg), -1, np.int32)
    q_pos = np.zeros((B,), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b in range(B - 1 if pad_row else B):
        fill = int(rng.integers(1, nb * pg + 1))
        n_used = -(-fill // pg)
        bt[b, :n_used] = perm[b * nb:b * nb + n_used]
        slot_pos[b, :fill] = np.arange(fill)
        q_pos[b] = fill - 1
    return q, kp, vp, bt, slot_pos, q_pos


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("B,nb,pg,Hq,Hkv,D", [
    (1, 2, 8, 1, 1, 8),
    (2, 3, 8, 4, 2, 16),
    (3, 3, 8, 6, 2, 16),    # non-pow2 batch
    (2, 4, 16, 8, 2, 32),   # the reduced llama3.2-1b heads
    (3, 3, 16, 8, 1, 256),  # gemma-2b's heads: MQA 8/1 at head_dim 256
    # page sizes the card's kernel takes on its own paths: one lookup per
    # 8 slots (32), one per slot (1, 4, 12)
    (3, 2, 32, 8, 2, 32),
    (2, 9, 4, 8, 2, 32),
    (3, 4, 12, 6, 2, 16),
    (2, 20, 1, 4, 2, 16),
])
@pytest.mark.parametrize("window", [None, 6])
def test_paged_decode_attention_plain_matches_jax(B, nb, pg, Hq, Hkv, D,
                                                  window):
    q, kp, vp, bt, sp, qp = _paged_inputs(B, nb, pg, Hq, Hkv, D,
                                          pad_row=B > 1)
    got = ops.paged_decode_attention(*_torch(q, kp, vp, bt, sp, qp),
                                     window=window).numpy()
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, sp, qp)]
    pallas = pallas_paged_decode(*args, window=window, interpret=True)
    oracle = jref.paged_decode_attention_ref(*args, window=window)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL_F32)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=ATOL_F32)


def test_paged_decode_fully_masked_row_is_uniform_not_nan():
    """The finite NEG_INF: a pad row whose every slot is masked averages
    its (null-page) values uniformly, exactly as the JAX oracle does."""
    q, kp, vp, bt, sp, qp = _paged_inputs(2, 2, 8, 4, 2, 16, seed=3,
                                          pad_row=True)
    got = ref.paged_decode_attention_ref(*_torch(q, kp, vp, bt, sp, qp))
    assert torch.isfinite(got).all()
    want = vp[0].reshape(-1, 2, 16).mean(axis=0)          # (Hkv, D)
    np.testing.assert_allclose(got[1].reshape(2, 2, 16).numpy(),
                               np.broadcast_to(want[:, None], (2, 2, 16)),
                               atol=ATOL_F32)


def _write_inputs(B, T, pg, Hkv, D, start, seed=0):
    """Left-padded rows whose tokens sit at absolute positions
    ``start[b] ..``, as ``transformer.prefill_tail_paged`` builds them
    (``start`` 0 is a plain prefill)."""
    rng = np.random.default_rng(seed)
    tails = rng.integers(1, T + 1, size=B)
    tails[0] = T
    idx = np.arange(T)[None]
    base = np.where(idx < T - tails[:, None], -1, idx - (T - tails[:, None]))
    start = np.asarray(start)[:, None]
    positions = np.where(base >= 0, base + start, -1).astype(np.int32)
    nb = -(-(T + int(start.max())) // pg) + 1
    P = B * nb + 1
    bt = rng.permutation(np.arange(1, P))[:B * nb].reshape(B, nb)
    k_new = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v_new = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    pool = rng.standard_normal((P, pg, Hkv, D)).astype(np.float32)
    return k_new, v_new, positions, bt.astype(np.int32), pool


@pytest.mark.parametrize("B,T,pg,Hkv,D", [
    (1, 16, 8, 1, 8),
    (2, 24, 8, 2, 16),
    (3, 12, 4, 2, 8),   # non-pow2 batch, partial last page
])
@pytest.mark.parametrize("shifted", [False, True])
def test_paged_prefill_write_plain_matches_jax_oracle(B, T, pg, Hkv, D,
                                                      shifted):
    """Bit-exact on every observable slot (each written token's own slot)
    and on every page outside the rows' tables, for a zero-start prefill
    and a tail whose positions start past a shared page-aligned prefix —
    whose slots must be left untouched."""
    start = [2 * pg * (b % 2) for b in range(B)] if shifted else [0] * B
    k_new, v_new, pos, bt, pool = _write_inputs(B, T, pg, Hkv, D, start)
    kp, vp = _torch(pool.copy(), pool.copy())
    ops.paged_prefill_write(*_torch(k_new, v_new, pos, bt), kp, vp)
    jk, jv = jref.paged_prefill_write_ref(
        *[jnp.asarray(a) for a in (k_new, v_new, pos, bt, pool, pool)])
    jk, jv = np.asarray(jk), np.asarray(jv)
    for b in range(B):
        for t in np.nonzero(pos[b] >= 0)[0]:
            page, off = bt[b, pos[b, t] // pg], pos[b, t] % pg
            np.testing.assert_array_equal(kp[page, off].numpy(), jk[page, off])
            np.testing.assert_array_equal(vp[page, off].numpy(), jv[page, off])
            np.testing.assert_array_equal(kp[page, off].numpy(), k_new[b, t])
        for s in range(start[b]):   # shared prefix slots: untouched
            page, off = bt[b, s // pg], s % pg
            np.testing.assert_array_equal(kp[page, off].numpy(),
                                          pool[page, off])
    outside = np.setdiff1d(np.arange(1, pool.shape[0]), bt)
    np.testing.assert_array_equal(kp[outside].numpy(), pool[outside])
    np.testing.assert_array_equal(vp[outside].numpy(), pool[outside])


def test_dispatch_counts_plain_calls_and_no_kernel_launch_on_cpu():
    q, kp, vp, bt, sp, qp = _paged_inputs(2, 2, 8, 4, 2, 16)
    k_new, v_new, pos, wbt, pool = _write_inputs(2, 8, 8, 2, 16, [0, 0])
    ops.reset_counts()
    ops.paged_decode_attention(*_torch(q, kp, vp, bt, sp, qp))
    ops.paged_prefill_write(*_torch(k_new, v_new, pos, wbt, pool, pool))
    ops.fused_rope_prefill_write(*_torch(k_new, v_new, pos, wbt, pool, pool))
    assert ops.plain_calls == {"paged_prefill_write": 1,
                               "paged_decode_attention": 1,
                               "fused_rope_prefill_write": 1,
                               "fused_rope_decode_append": 0,
                               "flash_prefill": 0,
                               "decode_attention": 0,
                               "ssd_scan": 0, "graph_loop": 0}
    assert ops.launches() == dict.fromkeys(ops.plain_calls, 0)
    ops.reset_counts()
    assert not any(ops.plain_calls.values())


def test_counts_lose_no_increment_across_threads(monkeypatch):
    """Several serving instances' event loops count on one process's
    counters from their own threads.  The counts here yield the
    interpreter between an increment's read and its write, so 8 threads
    of 500 counted calls each lose increments unless the count is taken
    under the lock."""
    import threading
    import time

    class YieldingCounts(dict):
        def __setitem__(self, key, value):
            time.sleep(0)  # another thread may run between read and write
            super().__setitem__(key, value)

    counts = YieldingCounts((k, 0) for k in ops.plain_calls)
    monkeypatch.setattr(ops, "plain_calls", counts)
    t = torch.zeros(1)
    threads = [threading.Thread(target=lambda: [
        ops._on_cpu(t, "paged_decode_attention") for _ in range(500)])
        for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert counts["paged_decode_attention"] == 8 * 500


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its CUDA kernel or raises: it never computes a
    CPU tensor itself, so the card's path cannot fall back silently."""
    q, kp, vp, bt, sp, qp = _torch(*_paged_inputs(2, 2, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        decode_kernel.paged_decode_attention(q, kp, vp, bt, sp, qp)
    k_new, v_new, pos, wbt, pool = _torch(
        *_write_inputs(2, 8, 8, 2, 16, [0, 0]))
    with pytest.raises(ValueError, match="CUDA"):
        write_kernel.paged_prefill_write(k_new, v_new, pos, wbt, pool,
                                         pool.clone())
    assert decode_kernel.launches == 0 and write_kernel.launches == 0


def test_fused_kernel_wrappers_refuse_cpu_tensors():
    k_new, v_new, pos, wbt, pool = _torch(
        *_write_inputs(2, 8, 8, 2, 16, [0, 0]))
    with pytest.raises(ValueError, match="CUDA"):
        fwrite_kernel.fused_rope_prefill_write(k_new, v_new, pos, wbt, pool,
                                               pool.clone())
    args = _torch(*_fused_decode_inputs(2, 2, 8, 4, 2, 16, [3, 0]))
    with pytest.raises(ValueError, match="CUDA"):
        fdecode_kernel.fused_rope_decode_append(*args)
    assert fwrite_kernel.launches == 0 and fdecode_kernel.launches == 0


def test_dispatch_rejects_devices_without_a_kernel():
    q, kp, vp, bt, sp, qp = [t.to("meta") for t in _torch(
        *_paged_inputs(1, 2, 8, 2, 2, 8))]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.paged_decode_attention(q, kp, vp, bt, sp, qp)


# ---------------------------------------------------------------------------
# fused RoPE kernels: plain versions against the JAX oracles (and the
# Pallas decode kernel; the Pallas prefill kernel does not trace on the
# installed JAX, ROADMAP C0)
# ---------------------------------------------------------------------------
def _pair(a, dtype):
    """The same numpy values as a torch and a jnp array of ``dtype``, the
    torch one a copy of its own (the plain versions write in place)."""
    return (torch.from_numpy(np.array(a)).to(getattr(torch, dtype)),
            jnp.asarray(a, getattr(jnp, dtype)))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,pg,Hkv,D,start", [
    (2, 24, 8, 2, 16, [0, 0]),
    (3, 12, 4, 2, 8, [0, 8, 0]),     # page-aligned shared-prefix tail
    (2, 16, 8, 2, 32, [5, 13]),      # tails that start mid-page
])
def test_fused_rope_prefill_write_plain_matches_jax_oracle(dtype, B, T, pg,
                                                           Hkv, D, start):
    """Each written token: K within the JAX kernel tests' tolerance, V
    exact; slots below a row's start and pages outside the rows' tables
    untouched (exact)."""
    k_new, v_new, pos, bt, pool = _write_inputs(B, T, pg, Hkv, D, start,
                                                seed=4)
    (tk, jk), (tv, jv) = _pair(k_new, dtype), _pair(v_new, dtype)
    (tkp, jpool), (tvp, _) = _pair(pool, dtype), _pair(pool, dtype)
    ops.fused_rope_prefill_write(tk, tv, torch.from_numpy(pos),
                                 torch.from_numpy(bt), tkp, tvp, theta=THETA)
    jkp, jvp = jref.fused_rope_prefill_write_ref(
        jk, jv, jnp.asarray(pos), jnp.asarray(bt), jpool, jpool, theta=THETA)
    got_k, got_v, want_k, want_v = _f32(tkp), _f32(tvp), _f32(jkp), _f32(jvp)
    before = _f32(_pair(pool, dtype)[0])
    for b in range(B):
        for t in np.nonzero(pos[b] >= 0)[0]:
            page, off = bt[b, pos[b, t] // pg], pos[b, t] % pg
            np.testing.assert_allclose(got_k[page, off], want_k[page, off],
                                       atol=ATOL[dtype])
            np.testing.assert_array_equal(got_v[page, off], want_v[page, off])
        for s in range(start[b]):
            page, off = bt[b, s // pg], s % pg
            np.testing.assert_array_equal(got_k[page, off], before[page, off])
            np.testing.assert_array_equal(got_v[page, off], before[page, off])
    outside = np.setdiff1d(np.arange(1, pool.shape[0]), bt)
    np.testing.assert_array_equal(got_k[outside], before[outside])


def test_fused_rope_prefill_write_plain_equals_rope_then_write():
    """The fused plain version is the port's own unfused pair bit for bit:
    ``apply_rope`` then ``paged_prefill_write``."""
    from repro_torch.models.common import apply_rope
    k_new, v_new, pos, bt, pool = _torch(*_write_inputs(3, 12, 4, 2, 8,
                                                        [0, 8, 3], seed=6))
    fk, fv, uk, uv = (pool.clone() for _ in range(4))
    ref.fused_rope_prefill_write_ref(k_new, v_new, pos, bt, fk, fv,
                                     theta=THETA)
    ref.paged_prefill_write_ref(apply_rope(k_new, pos.clamp(min=0), THETA),
                                v_new, pos, bt, uk, uv)
    assert torch.equal(fk, uk) and torch.equal(fv, uv)


def _fused_decode_inputs(B, nb, pg, Hq, Hkv, D, fills, seed=0):
    """Pools mid-decode: row b holds ``fills[b]`` resident tokens and
    appends its new token at slot ``fills[b]`` (slot_pos already marks it);
    a fill of 0 in the last row makes it a batch-bucket pad row, whose
    block table is the null page and whose one live slot is its own, as
    the engine builds it."""
    rng = np.random.default_rng(seed)
    P = B * nb + 1
    kp = rng.standard_normal((P, pg, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, pg, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k_new = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    v_new = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    bt = np.zeros((B, nb), np.int32)
    slot_pos = np.full((B, nb * pg), -1, np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b, fill in enumerate(fills):
        if fill:
            n_used = fill // pg + 1
            bt[b, :n_used] = perm[b * nb:b * nb + n_used]
        slot_pos[b, :fill + 1] = np.arange(fill + 1)
    slots = np.asarray(fills, np.int32)
    return q, k_new, v_new, bt, slot_pos, slots, slots.copy(), kp, vp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("B,nb,pg,Hq,Hkv,D,fills", [
    (2, 3, 8, 4, 2, 16, [16, 0]),           # first offset of a page; pad row
    (3, 3, 8, 6, 2, 16, [7, 23, 11]),       # last offsets of pages
    (4, 2, 16, 8, 2, 32, [15, 16, 3, 0]),   # reduced llama heads; pad row
    (3, 3, 16, 8, 1, 256, [20, 33, 0]),     # gemma-2b's heads, D 256
])
def test_fused_rope_decode_append_plain_matches_jax(dtype, window, B, nb, pg,
                                                    Hq, Hkv, D, fills):
    """Output and both pools after the append, against the jnp oracle
    (f32 2e-5, bf16 2e-2; V exact) and, in float32, the Pallas kernel in
    interpret mode.  Page 0 is left out of the Pallas comparison: its grid
    writes the null page's tiles back once for every row that points
    there."""
    arrays = _fused_decode_inputs(B, nb, pg, Hq, Hkv, D, fills)
    floats = {i: _pair(arrays[i], dtype) for i in (0, 1, 2, 7, 8)}
    ints = {i: _pair(arrays[i], "int32") for i in (3, 4, 5, 6)}
    args = [floats[i] if i in floats else ints[i] for i in range(9)]
    tout = ops.fused_rope_decode_append(*[a[0] for a in args], theta=THETA,
                                        window=window)
    jargs = [a[1] for a in args]
    jout, jk, jv = jref.fused_rope_decode_append_ref(*jargs, theta=THETA,
                                                     window=window)
    tk, tv = args[7][0], args[8][0]
    tol = ATOL[dtype]
    np.testing.assert_allclose(_f32(tout), _f32(jout), atol=tol)
    np.testing.assert_allclose(_f32(tk), _f32(jk), atol=tol)
    np.testing.assert_array_equal(_f32(tv), _f32(jv))
    if dtype != "float32":
        return
    pout, pk, pv = pallas_fused_decode(*jargs, theta=THETA, window=window,
                                       interpret=True)
    np.testing.assert_allclose(_f32(tout), _f32(pout), atol=tol)
    np.testing.assert_allclose(_f32(tk)[1:], _f32(pk)[1:], atol=tol)
    np.testing.assert_array_equal(_f32(tv)[1:], _f32(pv)[1:])


def test_fused_rope_decode_append_plain_equals_unfused_three_pass():
    """The fused plain version is the port's unfused decode bit for bit:
    ``apply_rope``, the scatter into the page slot, then
    ``paged_decode_attention``."""
    from repro_torch.models.common import apply_rope
    q, kn, vn, bt, sp, slots, qp, kp, vp = _torch(*_fused_decode_inputs(
        3, 3, 8, 6, 2, 16, [7, 23, 0], seed=2))
    fk, fv, uk, uv = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    fo = ref.fused_rope_decode_append_ref(q, kn, vn, bt, sp, slots, qp, fk,
                                          fv, theta=THETA)
    qr = apply_rope(q[:, None], qp[:, None], THETA)[:, 0]
    kr = apply_rope(kn[:, None], qp[:, None], THETA)[:, 0]
    page = bt.long()[torch.arange(3), slots.long() // 8]
    uk[page, slots.long() % 8] = kr
    uv[page, slots.long() % 8] = vn
    uo = ref.paged_decode_attention_ref(qr, uk, uv, bt, sp, qp)
    assert torch.equal(fo, uo)
    assert torch.equal(fk, uk) and torch.equal(fv, uv)


# ---------------------------------------------------------------------------
# dense attention: flash_prefill and decode_attention
# ---------------------------------------------------------------------------
def _pow2_block(n: int, cap: int = 8) -> int:
    """The JAX dispatch's block rule: the largest power of two up to
    ``cap`` that divides ``n``."""
    b = min(cap, n)
    while n % b:
        b //= 2
    return b


def _cast(x, dtype):
    """One numpy array as a JAX and a torch array of ``dtype`` with the
    same bits (both round float32 to nearest even)."""
    t = torch.from_numpy(x)
    if dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), t.to(torch.bfloat16)
    return jnp.asarray(x), t


def _prefill_np(B, T, Hq, Hkv, D, lens, seed=5):
    rng = np.random.default_rng(seed)
    idx = np.arange(T)[None]
    pad = T - np.asarray(lens)[:, None]
    positions = np.where(idx < pad, -1, idx - pad).astype(np.int32)
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    return q, k, v, positions


@pytest.mark.parametrize("B,T,Hq,Hkv,D,lens", [
    (2, 16, 4, 2, 16, [16, 9]),
    (3, 12, 8, 2, 32, [12, 5, 0]),    # T not a multiple of 8; an all-pad row
    (2, 24, 4, 1, 16, [24, 1]),       # MQA, a one-token row
    (1, 13, 4, 4, 8, [13]),           # MHA, odd T
    (2, 20, 8, 1, 256, [20, 7]),      # gemma-2b's heads: MQA 8/1, D 256
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
def test_flash_prefill_plain_matches_jax(B, T, Hq, Hkv, D, lens, dtype,
                                         window):
    """Whole outputs, pad rows included, against the oracle; the valid
    rows against the Pallas kernel in interpret mode, as
    ``tests/test_kernels.py`` compares them."""
    q, k, v, pos = _prefill_np(B, T, Hq, Hkv, D, lens)
    (jq, tq), (jk, tk), (jv, tv) = (_cast(a, dtype) for a in (q, k, v))
    got = ops.flash_prefill(tq, tk, tv, torch.from_numpy(pos),
                            window=window).float().numpy()
    jpos = jnp.asarray(pos)
    oracle = jref.flash_prefill_ref(jq, jk, jv, jpos, window=window)
    np.testing.assert_allclose(got, np.asarray(oracle.astype(jnp.float32)),
                               atol=ATOL[dtype])
    blk = _pow2_block(T)
    pallas = pallas_prefill(jq, jk, jv, jpos, window=window, block_q=blk,
                            block_k=blk, interpret=True)
    valid = (pos >= 0)[..., None, None]
    np.testing.assert_allclose(
        got * valid, np.asarray(pallas.astype(jnp.float32)) * valid,
        atol=ATOL[dtype])


def test_flash_prefill_pad_rows_take_their_own_value():
    """The diagonal rule: a pad query row attends only to itself, so its
    output is its own V (of its KV head), finite."""
    q, k, v, pos = _prefill_np(2, 12, 4, 2, 8, [12, 5])
    got = ref.flash_prefill_ref(*_torch(q, k, v, pos))
    want = np.repeat(v[1, :7], 2, axis=1)  # 2 query heads per KV head
    np.testing.assert_allclose(got[1, :7].numpy(), want, atol=1e-6)


def _dense_decode_np(B, W, Hq, Hkv, D, seed=6):
    """Rows at different positions; the last row is empty (every slot
    masked); the first row's last slot lies past its q_pos."""
    rng = np.random.default_rng(seed)
    slot_pos = np.full((B, W), -1, np.int32)
    q_pos = np.zeros((B,), np.int32)
    for b in range(B - 1):
        fill = int(rng.integers(1, W + 1))
        slot_pos[b, :fill] = np.arange(fill)
        q_pos[b] = fill - 1
    slot_pos[0, :] = np.arange(W)
    q_pos[0] = W - 2
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kc = rng.standard_normal((B, W, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, W, Hkv, D)).astype(np.float32)
    return q, kc, vc, slot_pos, q_pos


@pytest.mark.parametrize("B,W,Hq,Hkv,D", [
    (3, 8, 4, 2, 16),
    (4, 37, 8, 2, 32),     # W not a multiple of 8
    (3, 24, 4, 1, 16),     # MQA
    (2, 16, 4, 4, 8),      # MHA
    (3, 24, 8, 1, 256),    # gemma-2b's heads: MQA 8/1, D 256
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention_plain_matches_jax(B, W, Hq, Hkv, D, dtype,
                                           window):
    q, kc, vc, sp, qp = _dense_decode_np(B, W, Hq, Hkv, D)
    (jq, tq), (jk, tk), (jv, tv) = (_cast(a, dtype) for a in (q, kc, vc))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(sp),
                               torch.from_numpy(qp),
                               window=window).float().numpy()
    jsp, jqp = jnp.asarray(sp), jnp.asarray(qp)
    oracle = jref.decode_attention_ref(jq, jk, jv, jsp, jqp, window=window)
    pallas = pallas_dense_decode(jq, jk, jv, jsp, jqp, window=window,
                                 block_w=_pow2_block(W), interpret=True)
    for want in (oracle, pallas):
        np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                                   atol=ATOL[dtype])
    # the empty last row: the mean of its V, as with the finite NEG_INF
    mean_v = np.repeat(tv[-1].float().mean(dim=0).numpy(), Hq // Hkv, 0)
    np.testing.assert_allclose(got[-1], mean_v, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_plain_matches_jax_on_a_ring(dtype, window):
    """A ring cache (a windowed model keeps the last W entries and decode
    overwrites the oldest): slot_pos rotated out of index order, a row
    that has not wrapped yet (empty slots at the end) and an empty row."""
    B, W, Hq, Hkv, D = 3, 12, 8, 2, 16
    q, kc, vc, _, _ = _dense_decode_np(B, W, Hq, Hkv, D, seed=8)
    sp = np.full((B, W), -1, np.int32)
    sp[0] = (np.arange(W) - 5) % W + 17      # positions 17..28, wrapped
    sp[1, :7] = np.arange(7)                 # 7 of 12 slots used
    qp = np.array([28, 6, 0], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_cast(a, dtype) for a in (q, kc, vc))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(sp),
                               torch.from_numpy(qp),
                               window=window).float().numpy()
    oracle = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(sp),
                                       jnp.asarray(qp), window=window)
    np.testing.assert_allclose(got, np.asarray(oracle.astype(jnp.float32)),
                               atol=ATOL[dtype])
    mean_v = np.repeat(tv[-1].float().mean(dim=0).numpy(), Hq // Hkv, 0)
    np.testing.assert_allclose(got[-1], mean_v, atol=ATOL[dtype])


@pytest.mark.parametrize("B,W", [(1, 1), (2, 1344), (8, 768), (16, 1280),
                                 (64, 100_000)])
def test_decode_attention_split_depends_on_shapes_only(B, W):
    """The kernel's slots per split: whole pages, within the bounds the
    kernel stages in shared memory, at most 1024 splits, and at least two
    blocks per SM of a 132-SM card wherever W holds that many splits."""
    from repro_torch.kernels import split as k
    Hkv, n_sm = 8, 132
    chunk = k.split_slots(B, W, Hkv, n_sm)
    n_split = -(-W // chunk)
    assert chunk % k.PAGE == 0 and k.MIN_SPLIT <= chunk <= k.MAX_SPLIT
    assert n_split <= 1024
    if W >= 2 * n_sm // (B * Hkv) * k.MIN_SPLIT:
        assert n_split * B * Hkv >= 2 * n_sm - B * Hkv


@pytest.mark.parametrize("B,nb,pg", [(8, 36, 16), (4, 40, 16), (64, 80, 16),
                                     (8, 72, 8), (4, 81, 8), (3, 25, 8),
                                     (1, 1, 8), (1, 1, 16)])
def test_paged_decode_split_depends_on_shapes_only(B, nb, pg):
    """The paged kernels' slots per split at the smoke's shapes (8 rows of
    36 pages of 16, 4 of 40, the paged ILS engine's 64 of 80) and at pages
    of 8: whole 16-slot steps, so a pool page lies in one split; within
    the bounds the kernel stages in shared memory; at most 1024 splits;
    the same for the same shapes; at least two blocks per SM of a 132-SM
    card wherever the slots hold that many splits; a workspace of one
    partial per split."""
    from repro_torch.kernels import split as k
    Hq, Hkv, D, n_sm = 32, 8, 64, 132
    W = nb * pg
    chunk = k.split_slots(B, W, Hkv, n_sm)
    n_split = -(-W // chunk)
    assert chunk % k.PAGE == 0 and chunk % pg == 0
    assert k.MIN_SPLIT <= chunk <= k.MAX_SPLIT
    assert n_split <= 1024
    assert chunk == k.split_slots(B, W, Hkv, n_sm)
    if W >= 2 * n_sm // (B * Hkv) * k.MIN_SPLIT:
        assert n_split * B * Hkv >= 2 * n_sm - B * Hkv
    ws = k.workspace(B, W, Hq, Hkv, D, chunk, torch.device("cpu"))
    assert ws.dtype == torch.float32
    assert ws.numel() == B * Hkv * n_split * (Hq // Hkv) * (D + 2)


@pytest.mark.parametrize("B,nb,pg,Hkv,want", [(4, 40, 16, 8, 80),
                                              (3, 25, 8, 8, 64),
                                              (2, 20, 16, 2, 64),
                                              (4, 20, 16, 8, 64),
                                              (3, 30, 8, 2, 64)])
def test_paged_decode_split_of_the_card_cases(B, nb, pg, Hkv, want):
    """The split cases of ``test_torch_cuda``'s paged decode tests split as
    their comments say on a 132-SM card (an H100): several splits per long
    row, and splits of 64 that start mid-way through a table of 8-slot
    pages."""
    from repro_torch.kernels import split
    assert split.split_slots(B, nb * pg, Hkv, 132) == want


def test_dense_attention_dispatch_takes_the_plain_versions_on_cpu():
    ops.reset_counts()
    q, k, v, pos = _prefill_np(2, 8, 4, 2, 16, [8, 3])
    ops.flash_prefill(*_torch(q, k, v, pos))
    ops.decode_attention(*_torch(*_dense_decode_np(2, 8, 4, 2, 16)))
    assert ops.plain_calls["flash_prefill"] == 1
    assert ops.plain_calls["decode_attention"] == 1
    assert not any(ops.launches().values())
    ops.reset_counts()


def test_dense_attention_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import decode_attention as dense_decode_kernel
    from repro_torch.kernels import flash_prefill as prefill_kernel
    with pytest.raises(ValueError, match="CUDA"):
        prefill_kernel.flash_prefill(
            *_torch(*_prefill_np(2, 8, 4, 2, 16, [8, 3])))
    with pytest.raises(ValueError, match="CUDA"):
        dense_decode_kernel.decode_attention(
            *_torch(*_dense_decode_np(2, 8, 4, 2, 16)))
    assert prefill_kernel.launches == 0 and dense_decode_kernel.launches == 0
