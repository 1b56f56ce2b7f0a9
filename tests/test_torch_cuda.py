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

from repro_torch.kernels import decode_attention as dense_decode_kernel
from repro_torch.kernels import flash_prefill as prefill_kernel
from repro_torch.kernels import fused_rope_decode_append as fdecode_kernel
from repro_torch.kernels import fused_rope_prefill_write as fwrite_kernel
from repro_torch.kernels import graph_loop as loop_kernel
from repro_torch.kernels import paged_decode_attention as decode_kernel
from repro_torch.kernels import paged_prefill_write as write_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd_kernel

pytestmark = pytest.mark.cuda

#: f32 as the JAX kernel tests; bf16 for the kernel's unrounded weights
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are built with nvcc "
                    "for sm_90a)")
    return torch.device("cuda")


def _decode_inputs(B, nb, pg, Hq, Hkv, D, dtype, device, seed=0,
                   fills=None):
    """Random pools and shuffled block tables; row lengths vary (row b
    holds ``fills[b]`` tokens where given), the last row is a batch-bucket
    pad row (null pages, every slot masked)."""
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
        fill = (int(rng.integers(1, nb * pg + 1)) if fills is None
                else fills[b])
        n_used = -(-fill // pg)
        bt[b, :n_used] = perm[b * nb:b * nb + n_used]
        slot_pos[b, :fill] = np.arange(fill)
        q_pos[b] = fill - 1
    floats = [t.to(device=device, dtype=dtype) for t in (q, kp, vp)]
    ints = [torch.from_numpy(a).to(device) for a in (bt, slot_pos, q_pos)]
    return floats + ints


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("B,nb,pg,Hq,Hkv,D,fills", [
    (4, 5, 16, 8, 2, 64, None),
    (3, 11, 8, 32, 8, 64, None),     # more pages than warps per block
    (2, 3, 16, 16, 2, 128, None),    # the widest group and head dim
    (3, 4, 8, 8, 2, 32, None),       # the reduced llama3.2-1b heads
    # rows over several splits (80 slots each on a 132-SM card) beside a
    # row shorter than one split
    (4, 40, 16, 32, 8, 64, [600, 40, 257]),
    # pages of 8: splits of 64 slots start at pages 8, 16 and 24
    (3, 25, 8, 32, 8, 64, [200, 70]),
    (2, 20, 16, 16, 2, 128, [320]),
    # gemma-2b's heads (MQA 8/1, head_dim 256): a row over several splits
    # beside a short one, pages of 16 and of 8
    (3, 12, 16, 8, 1, 256, [150, 60]),
    (3, 20, 8, 8, 1, 256, [150, 33]),
    # minitron-4b's heads (GQA 24/8: 3 query heads a KV head) and
    # codeqwen1.5-7b's (MHA 32/32), head_dim 128, over several splits
    (3, 12, 16, 24, 8, 128, [150, 60]),
    (3, 20, 8, 32, 32, 128, [150, 33]),
])
def test_paged_decode_attention_matches_plain(cuda_device, dtype, window,
                                              B, nb, pg, Hq, Hkv, D, fills):
    """Held to the plain version; the pad row, which has no live slot, is
    the mean of the V of its (null) pages."""
    args = _decode_inputs(B, nb, pg, Hq, Hkv, D, dtype, cuda_device,
                          fills=fills)
    got = decode_kernel.paged_decode_attention(*args, window=window)
    want = ref.paged_decode_attention_ref(*args, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]
    vp, bt = args[2], args[3]
    mean_v = vp[bt[-1].long()].float().mean(dim=(0, 1))
    mean_v = mean_v.repeat_interleave(Hq // Hkv, dim=0)
    assert (got[-1].float() - mean_v).abs().max().item() <= ATOL[dtype]


#: every page size class of the paged kernels: one slot, a divisor of 8,
#: neither a divisor nor a multiple of 8, and multiples of 8 that do and do
#: not divide the 16-slot step
PAGE_SIZES = (1, 4, 12, 24, 32, 64, 128)
#: the rows of the page-size cases: two long rows over several splits,
#: two short ones, then a pad row
PG_FILLS = [600, 64, 7, 2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("pg", PAGE_SIZES)
@pytest.mark.parametrize("window", [None, 6])
def test_paged_decode_kernels_take_every_page_size(cuda_device, dtype, D,
                                                   pg, window):
    """B1 and B4 at every page size class, against their plain versions:
    rows of 600, 64, 7 and 2 slots (the 64-slot row's first 13 slots
    masked: a shifted start, its live slots beginning mid-page) and a
    dead pad row (B1: the mean of its null pages' V); B4 appends each
    row's new token at its own slot, mid-page for most sizes."""
    nb = -(-(max(PG_FILLS) + 1) // pg)
    args = _decode_inputs(len(PG_FILLS) + 1, nb, pg, 16, 4, D, dtype,
                          cuda_device, fills=PG_FILLS)
    args[4][1, :13] = -1
    got = decode_kernel.paged_decode_attention(*args, window=window)
    want = ref.paged_decode_attention_ref(*args, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]
    vp, bt = args[2], args[3]
    mean_v = vp[bt[-1].long()].float().mean(dim=(0, 1))
    mean_v = mean_v.repeat_interleave(4, dim=0)
    assert (got[-1].float() - mean_v).abs().max().item() <= ATOL[dtype]

    args = _fused_decode_inputs(4, nb, pg, 16, 4, D, [599, 64, 5, 0], dtype,
                                cuda_device)
    args[4][1, :13] = -1
    kp, vp = args[7], args[8]
    plain = args[:7] + [kp.clone(), vp.clone()]
    got = fdecode_kernel.fused_rope_decode_append(*args, theta=THETA,
                                                  window=window)
    want = ref.fused_rope_decode_append_ref(*plain, theta=THETA,
                                            window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]
    assert torch.equal(vp, plain[8])
    assert _max_ulps(kp, plain[7]) <= 1


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


# ---------------------------------------------------------------------------
# fused RoPE kernels
# ---------------------------------------------------------------------------
THETA = 5e5  # llama3.2-1b's: angles of hundreds of radians


def _max_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two tensors of
    one float type (same-sign values; 0 where they are equal)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    ia = a.view(ints[a.dtype]).long()
    ib = b.view(ints[b.dtype]).long()
    return int((ia - ib).abs().max().item()) if a.numel() else 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,pg", [(64, 16), (128, 8), (128, 16)])
@pytest.mark.parametrize("start", [[0, 0, 0], [0, 32, 0], [0, 21, 5]])
def test_fused_rope_prefill_write_matches_plain(cuda_device, dtype, D, pg,
                                                start):
    """V and every slot the kernel must not write are bit-identical to the
    plain version (a page-aligned and a mid-page shared prefix included);
    K is within one unit in the last place (both compute the angles with
    the same inverse frequencies, cosf and sinf: in practice exact)."""
    k_new, v_new, pos, bt, pool = _write_inputs(3, 40, pg, 8, D, start,
                                                dtype, cuda_device)
    ka, va, kb, vb = (pool.clone() for _ in range(4))
    fwrite_kernel.fused_rope_prefill_write(k_new, v_new, pos, bt, ka, va,
                                           theta=THETA)
    ref.fused_rope_prefill_write_ref(k_new, v_new, pos, bt, kb, vb,
                                     theta=THETA)
    torch.cuda.synchronize()
    assert torch.equal(va, vb)
    written = torch.zeros(pool.shape[:2], dtype=torch.bool,
                          device=cuda_device)
    valid = pos >= 0
    slot = pos.clamp(min=0).long()
    page = torch.gather(bt.long(), 1, slot // pg)[valid]
    written[page, (slot % pg)[valid]] = True
    assert torch.equal(ka[~written], pool[~written])
    assert _max_ulps(ka[written], kb[written]) <= 1


#: the rows of ``_edge_write_inputs``: (kind, valid tokens, first position)
EDGE_ROWS = (("run", 1, 0),        # a one-token row
             ("pad", 0, 0),        # a pad-only row
             ("run", 30, 21),      # a run that starts mid-page
             ("run", 27, 0),       # a run that ends mid-page
             ("shuffled", 33, 5),  # positions 5..37 in no order
             ("clipped", 20, 0))   # its last position past the table


def _edge_write_inputs(T, pg, Hkv, D, dtype, device, seed=3, nb=None):
    """One row of each ``EDGE_ROWS`` kind, left-padded in T tokens; the
    clipped row's last token names position 10**6, which lands in the
    table's last slot (named by no other token); pages are shuffled.
    ``nb`` widens the table: the entries no token names are the null
    page 0, but for the last, which the clipped token writes."""
    rng = np.random.default_rng(seed)
    B = len(EDGE_ROWS)
    positions = np.full((B, T), -1, np.int32)
    for b, (kind, n, start) in enumerate(EDGE_ROWS):
        row = np.arange(start, start + n)
        if kind == "shuffled":
            row = rng.permutation(row)
        elif kind == "clipped":
            row[-1] = 10 ** 6
        positions[b, T - n:] = row
    used = -(-max(s + n for _, n, s in EDGE_ROWS) // pg) + 1
    P = B * used + 1
    pages = rng.permutation(np.arange(1, P))[:B * used].reshape(B, used)
    bt = np.zeros((B, nb or used), np.int64)
    bt[:, :used - 1] = pages[:, :-1]
    bt[:, -1] = pages[:, -1]
    floats = [torch.from_numpy(rng.standard_normal(shape)).to(
        device=device, dtype=dtype) for shape in
        ((B, T, Hkv, D), (B, T, Hkv, D), (P, pg, Hkv, D))]
    ints = [torch.from_numpy(a.astype(np.int32)).to(device)
            for a in (positions, bt)]
    return floats[0], floats[1], ints[0], ints[1], floats[2]


def _written(pos, bt, pg, n_pool):
    """(P, pg) mask of the pool slots the valid tokens name (clipped)."""
    written = torch.zeros((n_pool, pg), dtype=torch.bool, device=pos.device)
    valid = pos >= 0
    slot = pos.clamp(min=0).long().clamp(max=bt.shape[1] * pg - 1)
    page = torch.gather(bt.long(), 1, slot // pg)[valid]
    written[page, (slot % pg)[valid]] = True
    return written


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pg", [8, 16])
@pytest.mark.parametrize("T,Hkv,D,nb", [
    (37, 8, 64, None),    # T a multiple of neither page size; tiles span
                          # rows
    (40, 2, 32, None),    # T a multiple of 8 only; the reduced heads
    (40, 8, 128, None),
    (40, 32, 128, None),  # codeqwen1.5-7b's heads: rows of 8 KiB (bf16)
    (35, 64, 128, None),  # rows of 64 KiB (float32): one token a tile,
                          # and more than one pass of the tile's threads
    (250, 8, 64, None),   # enough tokens for 2 vectors a thread (132 SMs)
    (1100, 8, 64, None),  # and a call of 8 rows of 512's size
    (40, 8, 64, 1100),    # a wide block table
])
def test_prefill_writes_hold_every_edge_case(cuda_device, dtype, pg, T, Hkv,
                                             D, nb):
    """Both prefill writes against their plain versions on the edge rows
    (``EDGE_ROWS``): paged_prefill_write's pools bit-identical;
    fused_rope_prefill_write's V bit-identical, K within one unit in the
    last place; for both every slot the call must not write untouched."""
    k_new, v_new, pos, bt, pool = _edge_write_inputs(T, pg, Hkv, D, dtype,
                                                     cuda_device, nb=nb)
    written = _written(pos, bt, pg, pool.shape[0])
    ka, va, kb, vb = (pool.clone() for _ in range(4))
    write_kernel.paged_prefill_write(k_new, v_new, pos, bt, ka, va)
    ref.paged_prefill_write_ref(k_new, v_new, pos, bt, kb, vb)
    torch.cuda.synchronize()
    assert torch.equal(ka, kb) and torch.equal(va, vb)
    assert torch.equal(ka[~written], pool[~written])
    assert torch.equal(va[~written], pool[~written])

    ka, va, kb, vb = (pool.clone() for _ in range(4))
    fwrite_kernel.fused_rope_prefill_write(k_new, v_new, pos, bt, ka, va,
                                           theta=THETA)
    ref.fused_rope_prefill_write_ref(k_new, v_new, pos, bt, kb, vb,
                                     theta=THETA)
    torch.cuda.synchronize()
    assert torch.equal(va, vb)
    assert torch.equal(ka[~written], pool[~written])
    assert torch.equal(va[~written], pool[~written])
    assert _max_ulps(ka[written], kb[written]) <= 1


def _page_size_write_inputs(pg, D, dtype, device, seed=6):
    """Rows of 600, 64, 7 and 2 valid tokens, left-padded to 600, then a
    pad-only row; the 64-token row starts at position 3 * pg + 5 (a tail
    past a shared prefix that ends mid-page, for pg > 5), the others at 0;
    pages shuffled."""
    rng = np.random.default_rng(seed)
    T, Hkv = 600, 4
    rows = [(600, 0), (64, 3 * pg + 5), (7, 0), (2, 0), (0, 0)]
    positions = np.full((len(rows), T), -1, np.int32)
    for b, (n, start) in enumerate(rows):
        positions[b, T - n:] = np.arange(start, start + n)
    nb = -(-max(n + s for n, s in rows) // pg) + 1
    P = len(rows) * nb + 1
    bt = rng.permutation(np.arange(1, P))[:len(rows) * nb].reshape(-1, nb)
    floats = [torch.from_numpy(rng.standard_normal(shape)).to(
        device=device, dtype=dtype) for shape in
        ((len(rows), T, Hkv, D), (len(rows), T, Hkv, D), (P, pg, Hkv, D))]
    ints = [torch.from_numpy(a.astype(np.int32)).to(device)
            for a in (positions, bt)]
    return floats[0], floats[1], ints[0], ints[1], floats[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("pg", PAGE_SIZES)
def test_prefill_writes_take_every_page_size(cuda_device, dtype, D, pg):
    """B2 and B3 address each token by ``pos // pg`` and take any page
    size: paged_prefill_write's pools bit-identical to the plain
    version's, fused_rope_prefill_write's V bit-identical and K within one
    unit in the last place; every slot no token names untouched."""
    k_new, v_new, pos, bt, pool = _page_size_write_inputs(pg, D, dtype,
                                                          cuda_device)
    written = _written(pos, bt, pg, pool.shape[0])
    ka, va, kb, vb = (pool.clone() for _ in range(4))
    write_kernel.paged_prefill_write(k_new, v_new, pos, bt, ka, va)
    ref.paged_prefill_write_ref(k_new, v_new, pos, bt, kb, vb)
    torch.cuda.synchronize()
    assert torch.equal(ka, kb) and torch.equal(va, vb)
    assert torch.equal(ka[~written], pool[~written])

    ka, va, kb, vb = (pool.clone() for _ in range(4))
    fwrite_kernel.fused_rope_prefill_write(k_new, v_new, pos, bt, ka, va,
                                           theta=THETA)
    ref.fused_rope_prefill_write_ref(k_new, v_new, pos, bt, kb, vb,
                                     theta=THETA)
    torch.cuda.synchronize()
    assert torch.equal(va, vb)
    assert torch.equal(ka[~written], pool[~written])
    assert _max_ulps(ka[written], kb[written]) <= 1


def test_paged_prefill_write_refuses_misaligned_pools(cuda_device):
    k_new, v_new, pos, bt, pool = _write_inputs(2, 16, 16, 8, 64, [0, 0],
                                                torch.float32, cuda_device)
    shifted = pool.reshape(-1)[1:1 + pool.numel() - pool[0].numel()]
    shifted = shifted.reshape(pool.shape[0] - 1, *pool.shape[1:])
    with pytest.raises(ValueError, match="aligned"):
        write_kernel.paged_prefill_write(k_new, v_new, pos, bt, shifted,
                                         pool[1:].contiguous())


def _fused_decode_inputs(B, nb, pg, Hq, Hkv, D, fills, dtype, device,
                         seed=1):
    """Row b holds ``fills[b]`` tokens and appends at slot ``fills[b]``
    (slot_pos already marks it); a 0 in the last row makes it a pad row
    on the null page, whose only live slot is its own."""
    rng = np.random.default_rng(seed)
    P = B * nb + 1
    floats = [torch.from_numpy(rng.standard_normal(shape)).to(
        device=device, dtype=dtype) for shape in
        ((B, Hq, D), (B, Hkv, D), (B, Hkv, D), (P, pg, Hkv, D),
         (P, pg, Hkv, D))]
    bt = np.zeros((B, nb), np.int32)
    slot_pos = np.full((B, nb * pg), -1, np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b, fill in enumerate(fills):
        if fill:
            bt[b, :fill // pg + 1] = perm[b * nb:b * nb + fill // pg + 1]
        slot_pos[b, :fill + 1] = np.arange(fill + 1)
    slots = np.asarray(fills, np.int32)
    ints = [torch.from_numpy(a).to(device)
            for a in (bt, slot_pos, slots, slots.copy())]
    q, kn, vn, kp, vp = floats
    return [q, kn, vn] + ints + [kp, vp]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("B,nb,pg,Hq,Hkv,D,fills", [
    (4, 5, 16, 32, 8, 64, [16, 31, 47, 0]),     # a page's first / last slot
    (3, 11, 8, 32, 8, 64, [80, 7, 0]),          # more pages than warps
    (3, 4, 16, 16, 2, 128, [15, 32, 0]),    # widest group and head dim
    (3, 4, 8, 8, 2, 32, [7, 20, 0]),        # the reduced llama3.2-1b heads
    # splits of 64 slots: the new slot first in its split and its only
    # live slot (64), last in its split (127), in the fifth split of a row
    # over five (300)
    (4, 20, 16, 32, 8, 64, [64, 127, 300, 0]),
    # pages of 8, splits from pages 8 and 16: the new slot last in the
    # third split (191), first and alone in the second (64)
    (3, 30, 8, 16, 2, 128, [191, 64, 0]),
    # gemma-2b's heads at head_dim 256 (one angle a thread): the new slot
    # first in the second split (64), in the third (150); pages of 8
    (3, 12, 16, 8, 1, 256, [64, 150, 0]),
    (3, 20, 8, 8, 1, 256, [127, 9, 0]),
    # minitron-4b's heads (3 query heads a KV head) and codeqwen1.5-7b's
    # (MHA), head_dim 128
    (3, 12, 16, 24, 8, 128, [64, 150, 0]),
    (3, 20, 8, 32, 32, 128, [127, 9, 0]),
])
def test_fused_rope_decode_append_matches_plain(cuda_device, dtype, window,
                                                B, nb, pg, Hq, Hkv, D,
                                                fills):
    args = _fused_decode_inputs(B, nb, pg, Hq, Hkv, D, fills, dtype,
                                cuda_device)
    kp, vp = args[7], args[8]
    plain = args[:7] + [kp.clone(), vp.clone()]
    got = fdecode_kernel.fused_rope_decode_append(*args, theta=THETA,
                                                  window=window)
    want = ref.fused_rope_decode_append_ref(*plain, theta=THETA,
                                            window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]
    assert torch.equal(vp, plain[8])
    assert _max_ulps(kp, plain[7]) <= 1


def test_fused_kernels_refuse_what_they_do_not_take(cuda_device):
    """CPU tensors, mixed or unsupported types and misaligned pools raise
    before any launch."""
    args = _fused_decode_inputs(2, 2, 16, 8, 2, 64, [5, 0], torch.float32,
                                cuda_device)
    cpu = [t.cpu() for t in args]
    with pytest.raises(ValueError, match="CUDA"):
        fdecode_kernel.fused_rope_decode_append(*cpu)
    half = [t.half() if t.is_floating_point() else t for t in args]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fdecode_kernel.fused_rope_decode_append(*half)
    pool = args[7]
    shifted = pool.reshape(-1)[1:1 + pool.numel() - pool[0].numel()]
    bad = args[:7] + [shifted.reshape(pool.shape[0] - 1, *pool.shape[1:]),
                      args[8][1:].contiguous()]
    with pytest.raises(ValueError, match="aligned"):
        fdecode_kernel.fused_rope_decode_append(*bad)

    k_new, v_new, pos, bt, pool = _write_inputs(2, 16, 16, 8, 64, [0, 0],
                                                torch.float32, cuda_device)
    with pytest.raises(ValueError, match="CUDA"):
        fwrite_kernel.fused_rope_prefill_write(
            k_new.cpu(), v_new.cpu(), pos.cpu(), bt.cpu(), pool.cpu(),
            pool.cpu())
    with pytest.raises(TypeError, match="int32"):
        fwrite_kernel.fused_rope_prefill_write(k_new, v_new, pos.long(), bt,
                                               pool, pool.clone())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fwrite_kernel.fused_rope_prefill_write(k_new, v_new.bfloat16(), pos,
                                               bt, pool, pool.clone())
    pflat = pool.reshape(-1)
    mis = pflat[1:1 + pool.numel() - pool[0].numel()].reshape(
        pool.shape[0] - 1, *pool.shape[1:])
    with pytest.raises(ValueError, match="aligned"):
        fwrite_kernel.fused_rope_prefill_write(k_new, v_new, pos, bt, mis,
                                               pool[1:].contiguous())


# ---------------------------------------------------------------------------
# dense attention kernels: flash_prefill and decode_attention
# ---------------------------------------------------------------------------
def _prefill_inputs(B, T, Hq, Hkv, D, dtype, device, seed=3):
    """Left-padded rows of random lengths: the first row full, the last
    all pads (every query row takes only its diagonal)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    if B > 1:
        lens[-1] = 0
    idx = np.arange(T)[None]
    pad = T - lens[:, None]
    positions = np.where(idx < pad, -1, idx - pad).astype(np.int32)
    floats = [torch.from_numpy(rng.standard_normal(shape)).to(
        device=device, dtype=dtype)
        for shape in ((B, T, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))]
    return floats + [torch.from_numpy(positions).to(device)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 7, 100])
@pytest.mark.parametrize("B,T,Hq,Hkv,D", [
    (3, 40, 32, 8, 64),      # llama3.2-1b heads; T not a tile multiple
    (2, 100, 16, 2, 128),    # the widest group at head_dim 128
    (2, 77, 24, 8, 64),      # 3 heads per KV head: idle threads
    (1, 130, 8, 8, 64),      # no grouping: 128 tokens per block
    (2, 16, 32, 8, 64),      # one bucket of 16, a pad row
    (3, 40, 8, 2, 32),       # the reduced llama3.2-1b heads
    (1, 1280, 32, 8, 64),    # an ILS join / a long dense re-prefill
    (2, 300, 32, 8, 64),     # T not a multiple of the 128-row tile
    (2, 300, 24, 8, 64),     # 3 heads per KV head over several q tiles
    (8, 512, 32, 8, 64),     # the smoke shape: the most outputs
    # head_dim 256 (one Q buffer, two K/V stages in bf16; 32 query rows a
    # float32 block): gemma-2b's MQA 8/1 over several q tiles, at its
    # smoke shape, and MHA (128 tokens a q tile)
    (2, 300, 8, 1, 256),
    (8, 512, 8, 1, 256),
    (2, 100, 16, 16, 256),
    # minitron-4b's heads (3 query heads a KV head) and codeqwen1.5-7b's
    # (MHA), head_dim 128
    (2, 300, 24, 8, 128),
    (2, 300, 32, 32, 128),
])
def test_flash_prefill_matches_plain(cuda_device, dtype, window, B, T, Hq,
                                     Hkv, D):
    """Windows of 7 (below a 64-key tile: edges masked) and 100 (fully
    live interior tiles beside masked edges), and none."""
    args = _prefill_inputs(B, T, Hq, Hkv, D, dtype, cuda_device)
    got = prefill_kernel.flash_prefill(*args, window=window)
    want = ref.flash_prefill_ref(*args, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


def _dense_decode_inputs(B, W, Hq, Hkv, D, dtype, device, seed=4,
                         layout="compact"):
    """Rows at different positions, the last row empty (every slot
    masked) when B > 1.  ``compact``: row b holds positions 0..fill-1 in
    its first slots (fill random, the first row full) and one row also
    holds a slot past its q_pos.  ``left``: live runs behind left pads, as
    the dense slices' re-prefilled caches, the first row's first 64 slots
    (one split or more) dead and its last 16 slots empty.  ``ring``: a
    windowed model's ring cache, each row's positions rotated by a random
    offset (slot_pos out of index order)."""
    rng = np.random.default_rng(seed)
    slot_pos = np.full((B, W), -1, np.int32)
    q_pos = np.zeros((B,), np.int32)
    for b in range(B - 1 if B > 1 else 1):
        if layout == "left":
            pad = 64 if b == 0 else int(rng.integers(0, W))
            end = W - 16 if b == 0 else W
            slot_pos[b, pad:end] = np.arange(end - pad)
            q_pos[b] = end - pad - 1
        elif layout == "ring":
            fill = W if b % 2 == 0 else int(rng.integers(1, W + 1))
            start = int(rng.integers(0, 3 * W))   # first position kept
            order = (np.arange(fill) + int(rng.integers(0, W))) % fill
            slot_pos[b, :fill] = start + order
            q_pos[b] = start + fill - 1
        else:
            fill = W if b == 0 else int(rng.integers(1, W + 1))
            slot_pos[b, :fill] = np.arange(fill)
            q_pos[b] = fill - 1
    if layout == "compact" and B > 2 and W > 1:
        q_pos[1] = max(0, q_pos[1] - 1)  # its last slot lies in the future
    floats = [torch.from_numpy(rng.standard_normal(shape)).to(
        device=device, dtype=dtype)
        for shape in ((B, Hq, D), (B, W, Hkv, D), (B, W, Hkv, D))]
    return floats + [torch.from_numpy(a).to(device)
                     for a in (slot_pos, q_pos)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("B,W,Hq,Hkv,D,layout", [
    (4, 37, 32, 8, 64, "compact"),    # W not a multiple of the 16-slot page
    (3, 1, 8, 2, 64, "compact"),      # a single slot
    (3, 200, 16, 2, 128, "compact"),  # the widest group at head_dim 128
    (5, 768, 32, 8, 64, "compact"),   # more pages than warps
    (3, 50, 8, 2, 32, "compact"),     # the reduced llama3.2-1b heads
    (2, 1000, 32, 8, 64, "left"),     # splits of 64 do not divide W; a live
                                      # row's dead first split; a dead row
                                      # over 16 splits
    (3, 1344, 32, 8, 64, "left"),     # ragged last split of 128
    (1, 1344, 32, 8, 64, "left"),     # the dense SCLS slice's one row
    (16, 1280, 32, 8, 64, "left"),    # the dense ILS engine's 16 slots
    (4, 300, 32, 8, 64, "ring"),      # a ring cache: slot_pos unsorted
    (3, 130, 16, 2, 128, "ring"),
    # gemma-2b's heads (MQA 8/1, head_dim 256)
    (3, 200, 8, 1, 256, "compact"),
    (2, 1000, 8, 1, 256, "left"),
    (4, 300, 8, 1, 256, "ring"),
    # minitron-4b's heads (3 query heads a KV head) and codeqwen1.5-7b's
    # (MHA), head_dim 128
    (3, 200, 24, 8, 128, "compact"),
    (2, 1000, 32, 32, 128, "left"),
])
def test_decode_attention_matches_plain(cuda_device, dtype, window, B, W,
                                        Hq, Hkv, D, layout):
    args = _dense_decode_inputs(B, W, Hq, Hkv, D, dtype, cuda_device,
                                layout=layout)
    got = dense_decode_kernel.decode_attention(*args, window=window)
    want = ref.decode_attention_ref(*args, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]
    if B > 1:
        # the empty last row weighs every slot alike: the mean of V
        mean_v = args[2][-1].float().mean(dim=0).repeat_interleave(
            Hq // Hkv, 0)
        assert (got[-1].float() - mean_v).abs().max().item() <= ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 6, 2048])
@pytest.mark.parametrize("B,W,Hq,Hkv,D,layout", [
    # recurrentgemma-9b's heads (MQA 16/1, head_dim 256) on its local ring
    (4, 300, 16, 1, 256, "ring"),
    (2, 2048, 16, 1, 256, "ring"),
    (3, 200, 16, 1, 256, "compact"),
    (2, 1000, 16, 1, 256, "left"),
    # group 16 at the other head dims, over two KV heads
    (3, 130, 32, 2, 64, "ring"),
    (3, 200, 32, 2, 128, "ring"),
    (2, 1000, 16, 1, 128, "left"),
])
def test_decode_attention_at_group_16_matches_plain(cuda_device, dtype,
                                                    window, B, W, Hq, Hkv, D,
                                                    layout):
    """B6 at 16 query heads per KV head (two 8-head blocks per KV head,
    each reading its KV head's slots) against its plain version, the
    empty last row the mean of its V."""
    test_decode_attention_matches_plain(cuda_device, dtype, window, B, W,
                                        Hq, Hkv, D, layout)


def test_decode_attention_refuses_a_head_dim_outside_its_domain(cuda_device):
    """Any group runs now (32 query heads on one KV head included); a head
    dim that is no multiple of 16, or above 256, raises naming the
    domain, before any launch."""
    args = _dense_decode_inputs(2, 20, 32, 1, 64, torch.bfloat16,
                                cuda_device)
    got = dense_decode_kernel.decode_attention(*args)
    assert (got.float() - ref.decode_attention_ref(*args).float()).abs() \
        .max().item() <= ATOL[torch.bfloat16]
    before = dense_decode_kernel.launches
    for D in (72, 272, 8):
        q, kc, vc, sp, qp = _dense_decode_inputs(2, 20, 4, 1, D,
                                                 torch.bfloat16, cuda_device)
        with pytest.raises(ValueError, match="multiples of 16 from 16 to "
                                             "256"):
            dense_decode_kernel.decode_attention(q, kc, vc, sp, qp)
    assert dense_decode_kernel.launches == before


def test_dense_attention_kernels_refuse_what_they_do_not_take(cuda_device):
    """CPU tensors, unsupported types, non-contiguous inputs and a query
    head count that is not a multiple of the KV heads raise before any
    launch; nothing falls back to the plain versions."""
    q, k, v, pos = _prefill_inputs(2, 24, 8, 2, 64, torch.float32,
                                   cuda_device)
    with pytest.raises(ValueError, match="CUDA"):
        prefill_kernel.flash_prefill(q.cpu(), k.cpu(), v.cpu(), pos.cpu())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        prefill_kernel.flash_prefill(q.half(), k.half(), v.half(), pos)
    with pytest.raises(TypeError, match="int32"):
        prefill_kernel.flash_prefill(q, k, v, pos.long())
    with pytest.raises(ValueError, match="contiguous"):
        prefill_kernel.flash_prefill(q.transpose(1, 2).contiguous()
                                     .transpose(1, 2), k, v, pos)
    with pytest.raises(ValueError, match="shapes"):
        prefill_kernel.flash_prefill(q[:, :, :6].contiguous(),
                                     k[:, :, :1].repeat(1, 1, 4, 1), v[:, :, :1]
                                     .repeat(1, 1, 4, 1), pos)
    before = prefill_kernel.launches
    for D in (72, 272):
        with pytest.raises(ValueError, match="multiples of 16 from 16 to "
                                             "256"):
            prefill_kernel.flash_prefill(*_prefill_inputs(
                2, 24, 8, 2, D, torch.float32, cuda_device))
    assert prefill_kernel.launches == before
    # a float32 block holds 32 query rows at head_dim 256: 64 query heads
    # a KV head run as two head blocks of 32
    args = _prefill_inputs(1, 8, 64, 1, 256, torch.float32, cuda_device)
    got = prefill_kernel.flash_prefill(*args)
    assert (got - ref.flash_prefill_ref(*args)).abs().max().item() <= \
        ATOL[torch.float32]

    q, kc, vc, sp, qp = _dense_decode_inputs(3, 20, 8, 2, 64, torch.float32,
                                             cuda_device)
    with pytest.raises(ValueError, match="CUDA"):
        dense_decode_kernel.decode_attention(q.cpu(), kc.cpu(), vc.cpu(),
                                             sp.cpu(), qp.cpu())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dense_decode_kernel.decode_attention(q, kc.bfloat16(), vc, sp, qp)
    with pytest.raises(TypeError, match="int32"):
        dense_decode_kernel.decode_attention(q, kc, vc, sp.long(), qp)
    with pytest.raises(ValueError, match="contiguous"):
        dense_decode_kernel.decode_attention(
            q, kc.transpose(0, 1).contiguous().transpose(0, 1), vc, sp, qp)
    with pytest.raises(ValueError, match="shapes"):
        dense_decode_kernel.decode_attention(q[:, :6].contiguous(),
                                             kc[:, :, :1].repeat(1, 1, 4, 1),
                                             vc[:, :, :1].repeat(1, 1, 4, 1),
                                             sp, qp)


def test_ops_dispatch_dense_attention_to_the_kernels(cuda_device):
    """On CUDA tensors ``kernels.ops`` launches the kernels (counted) and
    takes no plain version."""
    from repro_torch.kernels import ops
    ops.reset_counts()
    args = _prefill_inputs(2, 24, 8, 2, 64, torch.bfloat16, cuda_device)
    ops.flash_prefill(*args)
    dargs = _dense_decode_inputs(3, 20, 8, 2, 64, torch.bfloat16,
                                 cuda_device)
    ops.decode_attention(*dargs)
    torch.cuda.synchronize()
    assert ops.launches()["flash_prefill"] == 1
    assert ops.launches()["decode_attention"] == 1
    assert not any(ops.plain_calls.values())


def test_prefill_attention_refuses_a_mask_on_the_card(cuda_device):
    """``prefill_attend`` takes no caller-supplied mask (a keyword it
    does not have), so nothing on the card falls back to the plain maths:
    the prefix-LM mask is the kernel's ``prefix_len``, which launches
    flash_prefill (counted, with the prefix) and no plain version."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as tattn
    q, k, v, pos = _prefill_inputs(2, 16, 8, 2, 64, torch.bfloat16,
                                   cuda_device)
    mask = tattn.prefill_mask(pos, None)
    with pytest.raises(TypeError, match="mask"):
        tattn.prefill_attend(q, k, v, pos, None, 64 ** -0.5, mask=mask)
    ops.reset_counts()
    got = tattn.prefill_attend(q, k, v, pos, None, 64 ** -0.5, prefix_len=5)
    want = ref.flash_prefill_ref(q, k, v, pos, prefix_len=5)
    torch.cuda.synchronize()
    assert ops.launches()["flash_prefill"] == 1
    assert prefill_kernel.prefix_launches == 1
    assert not any(ops.plain_calls.values())
    assert (got.float() - want.float()).abs().max().item() <= \
        ATOL[torch.bfloat16]


def _prefix_inputs(P, lens, T, Hq, Hkv, D, dtype, device, seed=7):
    """The VLM prefill's layout: a prefix of P at positions 0..P-1, then
    each row's left pads (mid-row, between the prefix and the text) and
    its ``lens[b]`` text tokens at P + 0.., T text slots a row."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    text = np.full((B, T), -1, np.int32)
    for b, n in enumerate(lens):
        text[b, T - n:] = P + np.arange(n)
    positions = np.concatenate(
        [np.broadcast_to(np.arange(P, dtype=np.int32), (B, P)), text], 1)
    N = P + T
    floats = [torch.from_numpy(rng.standard_normal(shape)).to(
        device=device, dtype=dtype)
        for shape in ((B, N, Hq, D), (B, N, Hkv, D), (B, N, Hkv, D))]
    return floats + [torch.from_numpy(positions).to(device)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("P,lens,T,Hq,Hkv,D", [
    # paligemma-3b's heads (MQA 8/1, head_dim 256): a prefix of 256 over
    # four 64-key tiles, so the prefix's first queries read tiles above
    # their diagonal; text rows full and left-padded
    (256, (128, 70), 128, 8, 1, 256),
    (200, (60, 1), 60, 8, 1, 256),
    # head_dim 64 (seamless's heads, MHA 16/16): a prefix not a tile
    # multiple, mid-row pads, one row of text pads only
    (100, (40, 17, 0), 40, 16, 16, 64),
    (130, (200, 150), 200, 32, 8, 64),
])
def test_flash_prefill_with_prefix_matches_plain(cuda_device, dtype, window,
                                                 P, lens, T, Hq, Hkv, D):
    """B5 with ``prefix_len = P`` against its plain version: prefix keys
    above the diagonal are read (tile skipping includes them), the
    prefix overrides the window, pads between prefix and text attend
    their diagonal only."""
    args = _prefix_inputs(P, lens, T, Hq, Hkv, D, dtype, cuda_device)
    got = prefill_kernel.flash_prefill(*args, window=window, prefix_len=P)
    want = ref.flash_prefill_ref(*args, window=window, prefix_len=P)
    causal = ref.flash_prefill_ref(*args, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]
    assert (causal.float() - want.float()).abs().max().item() > \
        10 * ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,lens,H,D", [
    (300, (300, 217), 16, 64),      # seamless's heads, frames invalid
    (1024, (1024, 700, 256), 16, 64),
    (130, (130, 3), 8, 256),
])
def test_flash_prefill_as_encoder_matches_plain(cuda_device, dtype, S, lens,
                                                H, D):
    """B5 as the encoder runs it: masking positions ``where(valid,
    arange, -1)`` (right-padded invalid frames) and ``prefix_len = S``,
    every valid frame seeing every valid frame, each invalid frame only
    itself."""
    rng = np.random.default_rng(8)
    valid = np.arange(S)[None] < np.asarray(lens)[:, None]
    pos = torch.from_numpy(np.where(valid, np.arange(S)[None], -1).astype(
        np.int32)).to(cuda_device)
    q, k, v = (torch.from_numpy(rng.standard_normal((len(lens), S, H, D))
                                ).to(device=cuda_device, dtype=dtype)
               for _ in range(3))
    got = prefill_kernel.flash_prefill(q, k, v, pos, prefix_len=S)
    want = ref.flash_prefill_ref(q, k, v, pos, prefix_len=S)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,lens,H,D", [
    (1024, (1024, 700, 256, 0), 16, 64),   # seamless's heads; a row
    (300, (300, 17), 16, 64),              # without a valid frame
])
def test_decode_attention_as_cross_attention_matches_plain(cuda_device,
                                                           dtype, S, lens,
                                                           H, D):
    """B6 unchanged as cross-attention (``attention.cross_decode_attend``:
    slot_pos 0 on valid frames, -1 on invalid ones, q_pos 0) against its
    plain version and against the masked softmax over the valid frames;
    a row without a valid frame weighs every frame alike."""
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(9)
    B = len(lens)
    valid = torch.from_numpy(np.arange(S)[None] < np.asarray(lens)[:, None]
                             ).to(cuda_device)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D))).to(
        device=cuda_device, dtype=dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D))).to(
        device=cuda_device, dtype=dtype) for _ in range(2))
    sp = tattn.cross_slot_pos(valid)
    got = tattn.cross_decode_attend(q, k, v, sp)
    want = ref.decode_attention_ref(q[:, 0], k, v, sp,
                                    torch.zeros(B, dtype=torch.int32,
                                                device=cuda_device))
    masked = tattn.gqa_attend(q, k, v, valid[:, None, None, :]
                              .expand(B, 1, 1, S), D ** -0.5)
    torch.cuda.synchronize()
    assert (got[:, 0].float() - want.float()).abs().max().item() <= \
        ATOL[dtype]
    assert (got.float() - masked.float()).abs().max().item() <= ATOL[dtype]


# ---------------------------------------------------------------------------
# the attention kernels' domain: every head dim that is a multiple of 16
# up to 256 (rounded up to a compiled instance) and every group
# ---------------------------------------------------------------------------
DOMAIN_DIMS = (16, 48, 80, 96, 160, 192, 240)
DOMAIN_GROUPS = (3, 9, 12, 16, 24, 71)


def _domain_kv(G):
    """KV heads of a domain case: two (one for the prime group 71)."""
    return 1 if G == 71 else 2


def _close(got, want, dtype):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", DOMAIN_GROUPS)
@pytest.mark.parametrize("D", DOMAIN_DIMS)
@pytest.mark.parametrize("pg", [1, 16, 24])
def test_paged_decode_attention_takes_every_head_dim_and_group(
        cuda_device, dtype, D, G, pg):
    """B1 against its plain version, with no window and with one of 6
    slots; rows over several splits, the last a pad row."""
    Hkv = _domain_kv(G)
    nb = -(-150 // pg)
    args = _decode_inputs(3, nb, pg, G * Hkv, Hkv, D, dtype, cuda_device,
                          fills=[150, 37])
    for window in (None, 6):
        _close(decode_kernel.paged_decode_attention(*args, window=window),
               ref.paged_decode_attention_ref(*args, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", DOMAIN_GROUPS)
@pytest.mark.parametrize("D", DOMAIN_DIMS)
@pytest.mark.parametrize("pg", [1, 16, 24])
def test_fused_rope_decode_append_takes_every_head_dim_and_group(
        cuda_device, dtype, D, G, pg):
    """B4 against its plain version (every head block of a split that
    holds the new slot appends it): outputs within the tolerance, the
    appended V bit-equal and K within an ulp, with no window and with one
    of 6 slots; the new slot inside a split and first in one (64), the
    last row a pad row."""
    Hkv = _domain_kv(G)
    fills = [150, 64, 0]
    nb = 150 // pg + 2
    for window in (None, 6):
        args = _fused_decode_inputs(3, nb, pg, G * Hkv, Hkv, D, fills, dtype,
                                    cuda_device)
        kp, vp = args[7], args[8]
        plain = args[:7] + [kp.clone(), vp.clone()]
        got = fdecode_kernel.fused_rope_decode_append(*args, theta=THETA,
                                                      window=window)
        want = ref.fused_rope_decode_append_ref(*plain, theta=THETA,
                                                window=window)
        _close(got, want, dtype)
        assert torch.equal(vp, plain[8])
        assert _max_ulps(kp, plain[7]) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", DOMAIN_GROUPS)
@pytest.mark.parametrize("D", DOMAIN_DIMS)
def test_flash_prefill_takes_every_head_dim_and_group(cuda_device, dtype, D,
                                                      G):
    """B5 against its plain version over left-padded rows (the last all
    pads), with no window and with one of 7."""
    Hkv = _domain_kv(G)
    args = _prefill_inputs(3, 70, G * Hkv, Hkv, D, dtype, cuda_device)
    for window in (None, 7):
        _close(prefill_kernel.flash_prefill(*args, window=window),
               ref.flash_prefill_ref(*args, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", DOMAIN_GROUPS)
@pytest.mark.parametrize("D", DOMAIN_DIMS)
def test_decode_attention_takes_every_head_dim_and_group(cuda_device, dtype,
                                                         D, G):
    """B6 against its plain version on a ring cache over three splits,
    with no window and with one of 6; the last row empty (the mean of its
    V)."""
    Hkv = _domain_kv(G)
    args = _dense_decode_inputs(3, 150, G * Hkv, Hkv, D, dtype, cuda_device,
                                layout="ring")
    for window in (None, 6):
        got = dense_decode_kernel.decode_attention(*args, window=window)
        _close(got, ref.decode_attention_ref(*args, window=window), dtype)
    mean_v = args[2][-1].float().mean(dim=0).repeat_interleave(G, 0)
    assert (got[-1].float() - mean_v).abs().max().item() <= ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_at_falcon_heads_matches_plain(cuda_device, dtype):
    """B6 at Falcon-7B's heads (71/1, D 64) over 8 rows of 576 slots: nine
    head blocks a KV head over four splits, whose partials fill the whole
    workspace (a workspace sized for fewer heads a block would be written
    past its end)."""
    from repro_torch.kernels import split
    args = _dense_decode_inputs(8, 576, 71, 1, 64, dtype, cuda_device)
    chunk = split.split_slots(8, 576, split.head_blocks(71),
                              split.sm_count(cuda_device))
    assert -(-576 // chunk) > 1
    got = dense_decode_kernel.decode_attention(*args)
    _close(got, ref.decode_attention_ref(*args), dtype)


def test_attention_kernels_refuse_head_dims_outside_the_domain(cuda_device):
    """D 8, 72 and 272 raise a ValueError naming the domain in each of the
    four wrappers, before any launch and with no plain fallback."""
    from repro_torch.kernels import ops
    ops.reset_counts()
    for D in (8, 72, 272):
        dec = _decode_inputs(2, 4, 16, 4, 2, D, torch.bfloat16, cuda_device)
        fused = _fused_decode_inputs(2, 4, 16, 4, 2, D, [20, 0],
                                     torch.bfloat16, cuda_device)
        pre = _prefill_inputs(2, 24, 4, 2, D, torch.bfloat16, cuda_device)
        dense = _dense_decode_inputs(2, 20, 4, 2, D, torch.bfloat16,
                                     cuda_device)
        for fn, args in ((ops.paged_decode_attention, dec),
                         (ops.fused_rope_decode_append, fused),
                         (ops.flash_prefill, pre),
                         (ops.decode_attention, dense)):
            with pytest.raises(ValueError, match="multiples of 16 from 16 "
                                                 "to 256"):
                fn(*args)
    assert not any(ops.launches().values())
    assert not any(ops.plain_calls.values())


# ---------------------------------------------------------------------------
# the ILS engines and the dense static engine: card against CPU
# ---------------------------------------------------------------------------
def _smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_reduced_model_engines_on_the_card_match_the_cpu(cuda_device):
    """chip_smoke.py's phase 4b: the reduced float32 llama3.2-1b's dense
    and paged ILS engines and dense static engine on the card (flash_prefill,
    decode_attention, paged_decode_attention, each once per layer per
    prefill / decode step) give the CPU's token streams but for near-ties,
    and dense == paged on the card.  The phase raises SystemExit when it
    fails."""
    _smoke().check_ils_parity()


@pytest.mark.parametrize("arch,head_dim", [("codeqwen1.5-7b", None),
                                           ("minitron-4b", None),
                                           ("gemma-2b", None),
                                           ("gemma-2b", 256),
                                           ("mixtral-8x22b", None),
                                           ("deepseek-v2-lite-16b", None),
                                           ("recurrentgemma-9b", None),
                                           ("seamless-m4t-large-v2", None),
                                           ("paligemma-3b", None)])
def test_reduced_dense_configs_on_the_card_match_the_cpu(cuda_device, arch,
                                                         head_dim):
    """chip_smoke.py's phase 4c: the reduced float32 config (codeqwen's
    QKV biases, recurrentgemma's RG-LRU channels and seamless's norm gains
    drawn apart; gemma-2b also at its published head_dim 256; the VLM and
    the encoder-decoder with seeded frontend embeddings) through the dense static engine
    and, for the dense configs, the paged unfused and fused ones on the card
    gives the CPU's token streams but for near-ties, each path's kernels
    launching once per layer per prefill stage / decode step.  The phase
    raises SystemExit when it fails."""
    _smoke().check_config_parity(arch, head_dim)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-lite-16b"])
def test_reduced_moe_engines_at_the_served_capacity_match_the_cpu(
        cuda_device, arch):
    """chip_smoke.py's phase 4c for the MoE configs at their full configs'
    capacity factor (1.25): the reduced float32 dense static engine on the
    card drops routed choices and gives the CPU's token streams but for
    near-ties."""
    _smoke().check_config_parity(arch, served_capacity=True)


# ---------------------------------------------------------------------------
# ssd_scan (B7) and the Mamba-2 engine
# ---------------------------------------------------------------------------
#: kernel vs plain, relative to the plain version's largest |value|
#: (float32 sums of <= 128 terms in another order, through the chunk
#: states, stay near 1e-6 of it)
SSD_TOL = 1e-4


def _ssd_inputs(B, T, H, P, N, G, device, seed=5, dt_value=None,
                lengths=None):
    """float32 x, dt, A, B, C; rows left-padded to ``lengths`` (dt 0 at
    pads); dt softplus(normal) or a constant; A = -exp(0.5 z) per head."""
    rng = np.random.default_rng(seed)
    lengths = lengths or [T] * B
    valid = np.arange(T)[None] >= T - np.asarray(lengths)[:, None]
    x = rng.standard_normal((B, T, H, P))
    dt = (np.log1p(np.exp(rng.standard_normal((B, T, H))))
          if dt_value is None else np.full((B, T, H), dt_value))
    dt = dt * valid[..., None]
    A = -np.exp(0.5 * rng.standard_normal(H))
    Bm = rng.standard_normal((B, T, G, N))
    Cm = rng.standard_normal((B, T, G, N))
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (x, dt, A, Bm, Cm)]


@pytest.mark.parametrize("B,T,H,P,N,G,Q,lengths,dt_value", [
    (3, 48, 8, 32, 16, 1, 16, [48, 30, 7], None),       # reduced mamba2
    (8, 512, 24, 64, 128, 1, 128,
     [512, 497, 300, 505, 460, 489, 333, 512], None),   # smoke shapes
    (2, 256, 24, 64, 128, 2, 128, [256, 200], None),    # two groups
    (1, 128, 2, 8, 8, 1, 64, None, 1.5),                # C2: oracle NaN
    (2, 24, 3, 8, 4, 1, 8, None, None),                 # small, odd heads
    (2, 128, 24, 64, 128, 1, 128, [128, 77], None),     # one chunk
    (1, 1408, 24, 64, 128, 1, 128, [1391], None),       # 11 chunks, 1 row
    (2, 256, 4, 64, 128, 4, 128, [256, 130], None),     # G = H
    (2, 256, 24, 64, 128, 1, 128, [256, 0], None),      # a row all pad
    (2, 512, 24, 64, 128, 1, 128, [279, 418], None),    # a recorded stage
    (2, 1024, 24, 64, 128, 1, 128, None, 1.5),          # C2 in every chunk
    (1, 504, 6, 12, 20, 3, 36, [500], 1.5),             # C2, ragged tiles
    (1, 768, 2, 136, 132, 2, 256, [700], None),         # 2 row tiles, 3 P
])
def test_ssd_scan_matches_plain(cuda_device, B, T, H, P, N, G, Q, lengths,
                                dt_value):
    args = _ssd_inputs(B, T, H, P, N, G, cuda_device, dt_value=dt_value,
                       lengths=lengths)
    if dt_value is not None:
        args[2] = -torch.ones_like(args[2])
    y, st = ssd_kernel.ssd_scan(*args, Q)
    y_ref, st_ref = ref.ssd_scan_ref(*args, Q)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    for got, want in ((y, y_ref), (st, st_ref)):
        err = (got - want).abs().max().item() / want.abs().max().item()
        assert err <= SSD_TOL, err


def test_ssd_scan_plan_holds_the_kernels_shared_memory(cuda_device):
    """The wrapper's plan reckons each pass's shared memory as the built
    kernel does, at chunks that fill the tiles and at ones that do not."""
    for Q in (8, 36, 128, 256, 1000):
        assert ssd_kernel.kernel_smem_bytes(Q) == ssd_kernel.smem_bytes(Q)


def test_ssd_scan_refuses_what_it_does_not_take(cuda_device):
    args = _ssd_inputs(1, 32, 4, 8, 8, 2, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        ssd_kernel.ssd_scan(*[a.double() for a in args], 8)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_kernel.ssd_scan(*args, 12)
    bad_g = _ssd_inputs(1, 32, 4, 8, 8, 3, cuda_device)
    with pytest.raises(ValueError, match="of G"):
        ssd_kernel.ssd_scan(*bad_g, 8)
    x_t = args[0].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_kernel.ssd_scan(x_t, *args[1:], 8)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_scan(*[a.cpu() for a in args], 8)
    flat = torch.empty(args[0].numel() + 1, device=cuda_device)
    x_off = flat[1:].view(args[0].shape).copy_(args[0])  # 4 bytes off
    ssd_kernel.reset_launches()
    with pytest.raises(ValueError, match="aligned"):
        ssd_kernel.ssd_scan(x_off, *args[1:], 8)
    assert ssd_kernel.launches == 0


def test_ssd_scan_launches_nothing_for_an_empty_batch(cuda_device):
    """No row, no launch: the count means a kernel ran."""
    args = _ssd_inputs(1, 32, 4, 8, 8, 1, cuda_device)
    empty = [a[:0] for a in args[:2]] + [args[2]] + [a[:0] for a in args[3:]]
    ssd_kernel.reset_launches()
    y, st = ssd_kernel.ssd_scan(*empty, 8)
    assert ssd_kernel.launches == 0
    assert y.shape == (0, 32, 4, 8) and st.shape == (0, 4, 8, 8)


def test_ops_dispatch_ssd_scan_to_the_kernel(cuda_device):
    from repro_torch.kernels import ops
    ops.reset_counts()
    ops.ssd_chunked_scan(*_ssd_inputs(2, 32, 4, 8, 8, 1, cuda_device),
                         chunk=16)
    torch.cuda.synchronize()
    assert ops.launches()["ssd_scan"] == 1
    assert not any(ops.plain_calls.values())


def test_reduced_mamba_engine_on_the_card_matches_the_cpu(cuda_device):
    """chip_smoke.py's phase 4c for mamba2-130m: the reduced float32
    model's dense static engine on the card (ssd_scan once per layer per
    prefill, no other kernel) gives the CPU's token streams over two
    slices but for near-ties.  The phase raises when it fails."""
    _smoke().check_config_parity("mamba2-130m")


#: every kernel wrapper of ``kernels.ops`` (chip_smoke.kernel_guard_cases)
GUARDED = ("paged_prefill_write", "paged_decode_attention",
           "fused_rope_prefill_write", "fused_rope_decode_append",
           "flash_prefill", "decode_attention", "ssd_scan")


@pytest.mark.parametrize("name", GUARDED)
def test_wrapper_refuses_an_input_that_requires_grad(cuda_device, name):
    """The kernels have no backward: a CUDA call with grad mode on and an
    input that requires grad raises before it launches, rather than
    return a result cut from the autograd graph."""
    from repro_torch.kernels import ops
    call = dict(_smoke().kernel_guard_cases(cuda_device))[name]
    ops.reset_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert not any(ops.launches().values())


@pytest.mark.parametrize("arch", ("llama3.2-1b", "mamba2-130m",
                                  "deepseek-v2-lite-16b", "mixtral-8x22b",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-large-v2", "paligemma-3b"))
def test_train_step_on_the_card_matches_the_cpu(cuda_device, arch):
    """chip_smoke.py's phase 22 for one family: one train step of the
    reduced float32 model on the card and on the CPU agree within 1e-4,
    and the step without AdamW's bias correction does not.  The phase
    raises when it fails."""
    allow = torch.backends.cuda.matmul.allow_tf32
    try:
        _smoke().check_train_parity(arch)  # turns TF32 off
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,heads_split", [(8, 2, True), (8, 1, False)])
def test_b5_b6_on_dtensor_shards_match_plain(cuda_device, dtype, Hq, Hkv,
                                             heads_split):
    """``ops.flash_prefill`` and ``ops.decode_attention`` on DTensors of a
    fake (2, 2) mesh over ("data", "model") with CUDA shards (a replicated
    input is chunked locally, so rank 0's shard holds real values): the
    kernels run on rank 0's rows and, where the KV heads divide the model
    axis, its heads, once a call, and its local output matches the plain
    version's rows and heads on the plain tensors."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import fake_mesh
    rng = np.random.default_rng(3)
    B, T, D, W = 4, 96, 64, 80

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(
            device=cuda_device, dtype=dtype)

    pos = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)
    pos[1, :17] = -1
    pos[1, 17:] -= 17
    pos = pos.to(cuda_device)
    q, k, v = t(B, T, Hq, D), t(B, T, Hkv, D), t(B, T, Hkv, D)
    qd, kc, vc = t(B, Hq, D), t(B, W, Hkv, D), t(B, W, Hkv, D)
    slot_pos = torch.arange(W, dtype=torch.int32)[None].repeat(B, 1)
    slot_pos[2, 50:] = -1
    slot_pos = slot_pos.to(cuda_device)
    q_pos = torch.full((B,), W - 1, dtype=torch.int32, device=cuda_device)
    hl = Hq // 2 if heads_split else Hq
    with fake_mesh((2, 2), ("data", "model"), device_type="cuda") as mesh:
        rep = [Replicate(), Replicate()]

        def d(x):
            return DTensor.from_local(x, mesh, rep, run_check=False)

        ops.reset_counts()
        got = ops.flash_prefill(d(q), d(k), d(v), d(pos), window=40)
        gotd = ops.decode_attention(d(qd), d(kc), d(vc), d(slot_pos),
                                    d(q_pos), window=60)
        torch.cuda.synchronize()
        launches = ops.launches()
        assert launches["flash_prefill"] == 1
        assert launches["decode_attention"] == 1
        assert not any(ops.plain_calls.values())
        want = ref.flash_prefill_ref(q.cpu(), k.cpu(), v.cpu(), pos.cpu(),
                                     window=40).float()
        torch.testing.assert_close(got.to_local().cpu().float(),
                                   want[:B // 2, :, :hl], rtol=0,
                                   atol=ATOL[dtype])
        want = ref.decode_attention_ref(qd.cpu(), kc.cpu(), vc.cpu(),
                                        slot_pos.cpu(), q_pos.cpu(),
                                        window=60).float()
        torch.testing.assert_close(gotd.to_local().cpu().float(),
                                   want[:B // 2, :hl], rtol=0,
                                   atol=ATOL[dtype])


@pytest.mark.parametrize("B", [1, 3, 256, 300])
def test_graph_loop_matches_plain(cuda_device, B):
    """The decode loop's condition kernel (its predicate launched alone)
    equals ``graph_loop_ref``'s ``step < limit and not all(done)`` over
    steps below, at and past the limit and flags none, all, and all but
    one done (the last row and the first live), through the module's
    entry and the ``ops`` wrapper."""
    from repro_torch.kernels import ops
    for s in (0, 5, 9, 10, 11):
        for pattern in ("none", "all", "last live", "first live"):
            done = torch.zeros(B, dtype=torch.bool)
            if pattern != "none":
                done[:] = True
            if pattern == "last live":
                done[-1] = False
            if pattern == "first live":
                done[0] = False
            step = torch.tensor(s, dtype=torch.int64)
            want = ref.graph_loop_ref(step, done, 10)
            got = loop_kernel.graph_loop(step.to(cuda_device),
                                         done.to(cuda_device), 10)
            via_ops = ops.graph_loop(step.to(cuda_device),
                                     done.to(cuda_device), 10)
            assert got.dtype == torch.bool and got.dim() == 0
            assert bool(got.cpu()) == bool(want) == bool(via_ops.cpu())


def test_graph_loop_refuses_what_it_does_not_take(cuda_device):
    """A step counter that is not 0-d int64, or done flags that are not a
    non-empty (B,) bool tensor, raise before any launch."""
    step = torch.zeros((), dtype=torch.int64, device=cuda_device)
    done = torch.zeros(4, dtype=torch.bool, device=cuda_device)
    for bad_step, bad_done in ((step.int(), done), (step[None], done),
                               (step, done.int()), (step, done[:0]),
                               (step.cpu(), done)):
        with pytest.raises((TypeError, ValueError)):
            loop_kernel.graph_loop(bad_step, bad_done, 4)
