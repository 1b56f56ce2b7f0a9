"""Dispatch for the port's kernels, by the device of the tensors.

A CUDA tensor launches the hand-written kernel (or the wrapper raises);
a CPU tensor takes the kernel's plain version in ``kernels.ref``.  There
is no switch that sends a CUDA tensor to the plain version.  The engines
and models call through these functions, so the serving stack runs the
kernels whenever its pools live on the card.

No kernel has a backward.  A CUDA call with grad mode on and an input
that requires grad raises (``_refuse_grad``) rather than return a result
cut from the autograd graph, which would leave everything upstream of
the kernel untrained without a word: the training forwards (``Model.
loss``) run the plain torch versions and reach none of these functions.

**Counts.**  ``launches()`` counts the launches the card ran.  A wrapper
counts its own launch, except while its thread captures a CUDA graph,
where the launch is only recorded (``build.counted``); each replay of a
captured graph adds what its capture recorded (``add_launches``).

**Shards.**  ``flash_prefill`` and ``decode_attention`` (B5 and B6, the
kernels of the dense prefill and decode steps) and ``ssd_chunked_scan``
(B7, by rows only: ``on_local_rows``) also take DTensors on a
``DeviceMesh``: ``on_local_heads`` runs the call on each rank's local
shard (``local_map``'s work) -- rows over the mesh's "pod" / "data" axes
where the batch divides, heads over "model" where both the query and the
KV head counts divide (a rank then holds whole GQA groups) -- after
redistributing the inputs to those placements, so that no kernel is
launched on a mismatched head group.  The local call is the plain-tensor
dispatch above: the kernel for CUDA shards, the plain version for CPU
shards, never the plain version for a CUDA shard.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import build, ref
from repro_torch.kernels import decode_attention as _dense_decode_kernel
from repro_torch.kernels import flash_prefill as _prefill_kernel
from repro_torch.kernels import fused_rope_decode_append as _fdecode_kernel
from repro_torch.kernels import fused_rope_prefill_write as _fwrite_kernel
from repro_torch.kernels import graph_loop as _loop_kernel
from repro_torch.kernels import paged_decode_attention as _decode_kernel
from repro_torch.kernels import paged_prefill_write as _write_kernel
from repro_torch.kernels import ssd_scan as _ssd_kernel

#: each kernel's wrapper module, by kernel name
_KERNELS = {"paged_prefill_write": _write_kernel,
            "paged_decode_attention": _decode_kernel,
            "fused_rope_prefill_write": _fwrite_kernel,
            "fused_rope_decode_append": _fdecode_kernel,
            "flash_prefill": _prefill_kernel,
            "decode_attention": _dense_decode_kernel,
            "ssd_scan": _ssd_kernel,
            "graph_loop": _loop_kernel}

#: calls that took a kernel's plain version (CPU tensors), by kernel
plain_calls: Dict[str, int] = {name: 0 for name in _KERNELS}


def _on_cpu(t: torch.Tensor, name: str) -> bool:
    if t.is_cuda:
        if isinstance(t, DTensor):
            raise NotImplementedError(
                f"{name}: the paged kernels (paged_decode_attention, "
                f"paged_prefill_write, fused_rope_decode_append, "
                f"fused_rope_prefill_write) take no DTensor shards: the "
                f"paged engines are never sharded")
        return False
    if t.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    with build.LOCK:  # engines on several threads share the count
        plain_calls[name] += 1
    return True


def _refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when the kernel ``name`` would run under autograd: grad mode
    on and an input that requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward, and "
                           f"an input requires grad; train through the "
                           f"model's plain forward (Model.loss), or call "
                           f"under torch.no_grad()")


def launches() -> Dict[str, int]:
    """Kernel launches since the last ``reset_counts``."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def add_launches(tally: Dict[str, int]) -> None:
    """Add ``tally`` (kernel name -> launches) to the counts: a captured
    graph's replay launches the kernels its capture recorded
    (``build.capturing``) without calling their wrappers."""
    with build.LOCK:
        for name, n in tally.items():
            _KERNELS[name].launches += n


def reset_counts() -> None:
    for mod in _KERNELS.values():
        mod.reset_launches()
    for k in plain_calls:
        plain_calls[k] = 0


def _as_dtensor(t: torch.Tensor, mesh) -> DTensor:
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a local
    shard's gradient becomes a DTensor's local tensor, which DTensor's
    later views expect in its own (contiguous) layout."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _placed(out: torch.Tensor, mesh, placements, shape) -> DTensor:
    """A local result (made contiguous: contiguous gradients too) as the
    DTensor of global ``shape`` under ``placements``."""
    return DTensor.from_local(out.contiguous(), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def head_placements(mesh, batch: int, n_heads: Sequence[int]):
    """(placements of a tensor whose dim 0 is the batch and whose heads sit
    at dim ``h``, as a function of ``h`` (None: no heads)): rows over the
    "pod" / "data" axes where ``batch`` divides their product, heads over
    "model" where every count of ``n_heads`` divides its size."""
    names = mesh.mesh_dim_names or ()
    sizes = dict(zip(names, mesh.shape))
    dp = math.prod(sizes[n] for n in names if n in ("pod", "data"))
    rows = dp > 1 and batch % dp == 0
    m = sizes.get("model", 1)
    heads = m > 1 and all(h % m == 0 for h in n_heads)

    def of(head_dim: Optional[int]):
        out = []
        for n in names:
            if n in ("pod", "data") and rows:
                out.append(Shard(0))
            elif n == "model" and heads and head_dim is not None:
                out.append(Shard(head_dim))
            else:
                out.append(Replicate())
        return out

    return of


def on_local_heads(fn: Callable, q: torch.Tensor,
                   kv: Sequence[torch.Tensor], rows: Sequence[torch.Tensor],
                   q_head_dim: int, kv_head_dim: int) -> DTensor:
    """``fn(q, *kv, *rows)`` on each rank's local shard of DTensor inputs:
    q's heads at ``q_head_dim``, each of ``kv``'s at ``kv_head_dim``,
    ``rows`` (positions, slot tables) sharded by batch only; plain tensors
    among them count as replicated.  The output has q's leading dims and
    q's placements.

    ``local_map``'s work, written out (redistribute, ``to_local``, the
    call, ``from_local``; each step carries gradients): its reading of
    ``out_placements`` differs between PyTorch releases (2.11 takes a
    list of placements for one output as one placement an output)."""
    mesh = next(t for t in (q, *kv, *rows)
                if isinstance(t, DTensor)).device_mesh
    of = head_placements(mesh, q.shape[0],
                         (q.shape[q_head_dim], kv[0].shape[kv_head_dim]))
    q_pl, kv_pl = of(q_head_dim), of(kv_head_dim)
    # a row tensor broadcast over the batch (leading dim 1) stays whole
    row_pls = [of(None) if t.shape[0] == q.shape[0] else
               [Replicate()] * mesh.ndim for t in rows]
    local = ([_as_dtensor(q, mesh).redistribute(mesh, q_pl).to_local()]
             + [_as_dtensor(t, mesh).redistribute(mesh, kv_pl).to_local()
                for t in kv]
             + [_as_dtensor(t, mesh).redistribute(mesh, pl).to_local()
                for t, pl in zip(rows, row_pls)])
    out = fn(*(_ContiguousGrad.apply(t.contiguous()) for t in local))
    return _placed(out, mesh, q_pl, tuple(q.shape[:-1]) + (out.shape[-1],))


def on_local_rows(fn: Callable, batch: int, *tensors: torch.Tensor):
    """``fn(*tensors)`` on each rank's local rows of DTensor inputs (rows
    over the "pod" / "data" axes where ``batch`` divides; a tensor whose
    leading dim is not the batch, and every other dim, whole).  Each
    output has the batch leading and is placed by rows."""
    mesh = next(t for t in tensors if isinstance(t, DTensor)).device_mesh
    rows = head_placements(mesh, batch, ())(None)
    whole = [Replicate()] * mesh.ndim
    local = [_as_dtensor(t, mesh).redistribute(
        mesh, rows if t.shape[0] == batch else whole).to_local()
        for t in tensors]
    outs = fn(*(_ContiguousGrad.apply(t.contiguous()) for t in local))
    return tuple(_placed(o, mesh, rows, (batch,) + tuple(o.shape[1:]))
                 for o in outs)


def paged_prefill_write(k_new: torch.Tensor, v_new: torch.Tensor,
                        positions: torch.Tensor, block_table: torch.Tensor,
                        k_pages: torch.Tensor, v_pages: torch.Tensor) -> None:
    """Write prefill K/V into the paged pool through block tables, in place.

    k/v_new (B,T,Hkv,D) in the left-padded layout; positions (B,T) from
    ``models.transformer.make_positions`` (pads < 0, real tokens at their
    absolute position, which is the destination logical slot); block_table
    (B,nb); k/v_pages (P,pg,Hkv,D) of one layer.
    """
    if _on_cpu(k_new, "paged_prefill_write"):
        ref.paged_prefill_write_ref(k_new, v_new, positions, block_table,
                                    k_pages, v_pages)
        return
    _refuse_grad("paged_prefill_write", k_new, v_new, k_pages, v_pages)
    _write_kernel.paged_prefill_write(k_new, v_new, positions, block_table,
                                      k_pages, v_pages)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           slot_pos: torch.Tensor, q_pos: torch.Tensor,
                           window: Optional[int] = None) -> torch.Tensor:
    """Single-token GQA decode over a paged KV cache. q (B,Hq,D) ->
    (B,Hq,D)."""
    if _on_cpu(q, "paged_decode_attention"):
        return ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                              block_table, slot_pos, q_pos,
                                              window=window)
    _refuse_grad("paged_decode_attention", q, k_pages, v_pages)
    return _decode_kernel.paged_decode_attention(q, k_pages, v_pages,
                                                 block_table, slot_pos,
                                                 q_pos, window=window)


def fused_rope_prefill_write(k_new: torch.Tensor, v_new: torch.Tensor,
                             positions: torch.Tensor,
                             block_table: torch.Tensor,
                             k_pages: torch.Tensor, v_pages: torch.Tensor,
                             theta: float = 10000.0) -> None:
    """Rotate prefill K at its absolute positions and write K/V into the
    paged pool in one pass, in place.

    k/v_new (B,T,Hkv,D) left-padded *unrotated* projections; positions
    (B,T) from ``models.transformer.make_positions`` (pads < 0, real
    tokens at their absolute position == destination logical slot);
    block_table (B,nb); k/v_pages (P,pg,Hkv,D).  V is written unrotated;
    slots below a row's first real position (a shared-prefix tail) are
    left as they were, whether or not that position is page-aligned."""
    if _on_cpu(k_new, "fused_rope_prefill_write"):
        ref.fused_rope_prefill_write_ref(k_new, v_new, positions,
                                         block_table, k_pages, v_pages,
                                         theta=theta)
        return
    _refuse_grad("fused_rope_prefill_write", k_new, v_new, k_pages, v_pages)
    _fwrite_kernel.fused_rope_prefill_write(k_new, v_new, positions,
                                            block_table, k_pages, v_pages,
                                            theta=theta)


def fused_rope_decode_append(q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, block_table: torch.Tensor,
                             slot_pos: torch.Tensor, slots: torch.Tensor,
                             q_pos: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, theta: float = 10000.0,
                             window: Optional[int] = None) -> torch.Tensor:
    """Rotate the new q/k token, append its K/V to its page slot in place,
    and run paged decode attention over the pool after the append.

    q (B,Hq,D) and k/v_new (B,Hkv,D) *unrotated*; block_table (B,nb);
    slot_pos (B,nb·pg) already marking the new token's slot; slots (B,)
    destination logical slot; q_pos (B,) absolute position.  Returns
    (B,Hq,D)."""
    if _on_cpu(q, "fused_rope_decode_append"):
        return ref.fused_rope_decode_append_ref(
            q, k_new, v_new, block_table, slot_pos, slots, q_pos, k_pages,
            v_pages, theta=theta, window=window)
    _refuse_grad("fused_rope_decode_append", q, k_new, v_new, k_pages,
                 v_pages)
    return _fdecode_kernel.fused_rope_decode_append(
        q, k_new, v_new, block_table, slot_pos, slots, q_pos, k_pages,
        v_pages, theta=theta, window=window)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, window: Optional[int] = None,
                  prefix_len: int = 0) -> torch.Tensor:
    """Causal, left-pad-masked GQA prefill attention; keys at positions
    below ``prefix_len`` are seen by every valid query (a bidirectional
    prefix; 0: none). q (B,T,Hq,D), k/v (B,T,Hkv,D), positions (B,T) int32
    with pads < 0 -> (B,T,Hq,D).  DTensors run on their local shards
    (``on_local_heads``)."""
    if isinstance(q, DTensor) or isinstance(k, DTensor):
        return on_local_heads(
            lambda q, k, v, p: flash_prefill(q, k, v, p, window=window,
                                             prefix_len=prefix_len),
            q, (k, v), (positions,), 2, 2)
    if _on_cpu(q, "flash_prefill"):
        return ref.flash_prefill_ref(q, k, v, positions, window=window,
                                     prefix_len=prefix_len)
    _refuse_grad("flash_prefill", q, k, v)
    return _prefill_kernel.flash_prefill(q, k, v, positions, window=window,
                                         prefix_len=prefix_len)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor,
                     q_pos: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token GQA decode over a dense KV cache. q (B,Hq,D), k/v_cache
    (B,W,Hkv,D), slot_pos (B,W) and q_pos (B,) int32 -> (B,Hq,D).
    DTensors run on their local shards (``on_local_heads``)."""
    if isinstance(q, DTensor) or isinstance(k_cache, DTensor):
        return on_local_heads(
            lambda q, k, v, s, p: decode_attention(q, k, v, s, p,
                                                   window=window),
            q, (k_cache, v_cache), (slot_pos, q_pos), 1, 2)
    if _on_cpu(q, "decode_attention"):
        return ref.decode_attention_ref(q, k_cache, v_cache, slot_pos, q_pos,
                                        window=window)
    _refuse_grad("decode_attention", q, k_cache, v_cache)
    return _dense_decode_kernel.decode_attention(q, k_cache, v_cache,
                                                 slot_pos, q_pos,
                                                 window=window)


def ssd_chunked_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, chunk: int = 128):
    """Mamba-2 SSD chunked scan. x (B,T,H,P) float32; dt (B,T,H); A (H,);
    B/C (B,T,G,N), groups read per head (no broadcast) -> (y (B,T,H,P),
    final_state (B,H,P,N)).  T must be a multiple of ``chunk``.  DTensors
    run on each rank's local rows (``on_local_rows``: rows over the "pod"
    / "data" axes where the batch divides, heads and groups whole, so
    ``ssd_scan.plan``'s checks apply to the local shapes); the local call
    is the plain-tensor dispatch: the kernel for CUDA shards."""
    if x.shape[1] % chunk:
        raise ValueError(f"ssd_chunked_scan: T {x.shape[1]} is not a "
                         f"multiple of the chunk {chunk}")
    if isinstance(x, DTensor):  # each rank's rows: kernel or plain version
        return on_local_rows(
            lambda *t: ssd_chunked_scan(*t, chunk=chunk), x.shape[0], x, dt,
            A, B, C)
    if _on_cpu(x, "ssd_scan"):
        return ref.ssd_scan_ref(x, dt, A, B, C, chunk)
    _refuse_grad("ssd_scan", x, dt, A, B, C)
    return _ssd_kernel.ssd_scan(x, dt, A, B, C, chunk)


def graph_loop(step: torch.Tensor, done: torch.Tensor,
               limit: int) -> torch.Tensor:
    """The decode loop's condition ``step < limit and not all(done)``: step
    0-d int64, done (B,) bool -> 0-d bool, on their device.  On the card
    its kernel is what the captured loop's WHILE node reads
    (``graph_loop.build_loop``); this call launches it alone."""
    if _on_cpu(step, "graph_loop"):
        return ref.graph_loop_ref(step, done, limit)
    _refuse_grad("graph_loop", step, done)
    return _loop_kernel.graph_loop(step, done, limit)
