"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA
device; on the card the kernels are built from ``src/repro_torch/kernels/
csrc`` at first use.  The file imports neither JAX nor the JAX package,
so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_decode_attention as decode_kernel
from repro_torch.kernels import paged_prefill_write as write_kernel
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda

#: f32 as the JAX kernel tests; bf16 for the kernel's unrounded weights
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are built with nvcc "
                    "for sm_90a)")
    return torch.device("cuda")


def _decode_inputs(B, nb, pg, Hq, Hkv, D, dtype, device, seed=0):
    """Random pools and shuffled block tables; row lengths vary, the last
    row is a batch-bucket pad row (null pages, every slot masked)."""
    rng = np.random.default_rng(seed)
    P = B * nb + 1
    kp = torch.from_numpy(rng.standard_normal((P, pg, Hkv, D)))
    vp = torch.from_numpy(rng.standard_normal((P, pg, Hkv, D)))
    q = torch.from_numpy(rng.standard_normal((B, Hq, D)))
    bt = np.zeros((B, nb), np.int32)
    slot_pos = np.full((B, nb * pg), -1, np.int32)
    q_pos = np.zeros((B,), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b in range(B - 1):
        fill = int(rng.integers(1, nb * pg + 1))
        n_used = -(-fill // pg)
        bt[b, :n_used] = perm[b * nb:b * nb + n_used]
        slot_pos[b, :fill] = np.arange(fill)
        q_pos[b] = fill - 1
    floats = [t.to(device=device, dtype=dtype) for t in (q, kp, vp)]
    ints = [torch.from_numpy(a).to(device) for a in (bt, slot_pos, q_pos)]
    return floats + ints


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("B,nb,pg,Hq,Hkv,D", [
    (4, 5, 16, 8, 2, 64),
    (3, 11, 8, 32, 8, 64),     # more pages than warps per block
    (2, 3, 16, 16, 2, 128),    # the widest group and head dim compiled
])
def test_paged_decode_attention_matches_plain(cuda_device, dtype, window,
                                              B, nb, pg, Hq, Hkv, D):
    args = _decode_inputs(B, nb, pg, Hq, Hkv, D, dtype, cuda_device)
    got = decode_kernel.paged_decode_attention(*args, window=window)
    want = ref.paged_decode_attention_ref(*args, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


def test_paged_decode_attention_refuses_uncompiled_shapes(cuda_device):
    args = _decode_inputs(2, 2, 4, 4, 2, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="page_tokens 4"):
        decode_kernel.paged_decode_attention(*args)


def _write_inputs(B, T, pg, Hkv, D, start, dtype, device, seed=2):
    rng = np.random.default_rng(seed)
    tails = rng.integers(1, T + 1, size=B)
    tails[0] = T
    idx = np.arange(T)[None]
    base = np.where(idx < T - tails[:, None], -1, idx - (T - tails[:, None]))
    st = np.asarray(start)[:, None]
    positions = np.where(base >= 0, base + st, -1).astype(np.int32)
    nb = -(-(T + int(st.max())) // pg) + 1
    P = B * nb + 1
    bt = rng.permutation(np.arange(1, P))[:B * nb].reshape(B, nb)
    k_new = torch.from_numpy(rng.standard_normal((B, T, Hkv, D)))
    v_new = torch.from_numpy(rng.standard_normal((B, T, Hkv, D)))
    pool = torch.from_numpy(rng.standard_normal((P, pg, Hkv, D)))
    floats = [t.to(device=device, dtype=dtype) for t in (k_new, v_new, pool)]
    ints = [torch.from_numpy(a).to(device)
            for a in (positions, bt.astype(np.int32))]
    return floats[0], floats[1], ints[0], ints[1], floats[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True])
def test_paged_prefill_write_matches_plain(cuda_device, dtype, shifted):
    """Bit-identical pools, including a tail whose positions start past a
    two-page shared prefix (those slots stay untouched)."""
    start = [0, 32, 0] if shifted else [0, 0, 0]
    k_new, v_new, pos, bt, pool = _write_inputs(3, 40, 16, 8, 64, start,
                                                dtype, cuda_device)
    ka, va, kb, vb = (pool.clone() for _ in range(4))
    write_kernel.paged_prefill_write(k_new, v_new, pos, bt, ka, va)
    ref.paged_prefill_write_ref(k_new, v_new, pos, bt, kb, vb)
    torch.cuda.synchronize()
    assert torch.equal(ka, kb) and torch.equal(va, vb)
