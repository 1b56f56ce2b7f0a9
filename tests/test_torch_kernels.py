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
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as pallas_paged_decode
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_decode_attention as decode_kernel
from repro_torch.kernels import paged_prefill_write as write_kernel

#: float32 tolerance of the JAX kernel tests (tests/test_kernels.py)
ATOL_F32 = 2e-5


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
    assert ops.plain_calls == {"paged_prefill_write": 1,
                               "paged_decode_attention": 1}
    assert ops.launches() == {"paged_prefill_write": 0,
                              "paged_decode_attention": 0}
    ops.reset_counts()
    assert not any(ops.plain_calls.values())


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


def test_dispatch_rejects_devices_without_a_kernel():
    q, kp, vp, bt, sp, qp = [t.to("meta") for t in _torch(
        *_paged_inputs(1, 2, 8, 2, 2, 8))]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.paged_decode_attention(q, kp, vp, bt, sp, qp)
