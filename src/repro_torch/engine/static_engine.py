"""Static-batching inference engine, dense or with persistent paged KV
storage.

PyTorch counterpart of ``repro.engine.static_engine``.  Semantics follow
the paper's §2.4 and the JAX engine exactly:

  * batched prompts are left-padded to the bucketed batch input length
    (``len_bucket``), batch sizes are bucketed to a power of two and
    decode block tables to a multiple of ``NB_BUCKET`` blocks;
  * a slice prefills the rows that are not resident, then decodes for at
    most ``slice_len`` iterations or until every row is done — finished
    rows keep generating *invalid* tokens, as in static batching;
  * ``forced_gen_lens`` emulates known EOS positions (``EOS_DRIVEN`` means
    the model's own EOS ends the row).

Dense layout (``serve_batch``, the default): each slice prefills prompt +
``already_generated`` into a fresh dense cache of exactly ``L + S`` slots
(Eq. 5) and decodes in it; a rescheduled request re-prefills everything
(the paper's §3.3 overhead, counted in ``ServeResult.reprefill_tokens``).
It takes the model as it is, and its cache whatever its type
(``KVCache``, ``MambaCache``, ``MoECache``, ``RGCache``, ``EncDecCache``):
the dense transformer's prefill and decode go through the
``flash_prefill`` / ``decode_attention`` kernels, as do mixtral-8x22b's
and recurrentgemma-9b's attention layers, the VLM's (its image prefix
bidirectional in ``flash_prefill``) and the encoder-decoder's encoder,
decoder self-attention and cross-attention decode, the Mamba-2 model's
prefill through ``ssd_scan``; deepseek-v2-lite's MLA attention, every MoE
dispatch, the RG-LRU scan and the encoder-decoder's cross-attention at
prefill are plain torch.  Only the dense family has a paged layout.

``extra_inputs`` (dense layout only) are the frontend stubs' embeddings,
one row per prompt of every batch the engine serves (``B_raw`` rows, or
the bucketed ``B``; pad rows repeat the last): ``prefix_embeds`` (B, P, d)
for the VLM, whose cache then holds ``L + P + slice_len`` slots, or
``src_embeds`` (B, S, d) and ``src_valid`` (B, S) for the
encoder-decoder, whose every prefill, a re-prefill included, re-runs the
encoder (``reprefill_tokens`` counts decoder tokens only).  So a slice
loop over a shrinking batch builds an engine per slice, over that
batch's rows.

Persistent paged storage (``kv_layout="paged"``, ``serve_batch_paged``):
the engine owns a page pool and per-request page
state that survives across ``serve_batch_paged`` calls.  A resumed
request remaps its retained pages into the batch block table and decodes
from its stored next token — the paper's §3.3 re-prefill becomes a
page-table remap.  Layout: logical slot == absolute position.

``attn_impl`` picks the paged path's attention: ``"unfused"`` (torch
RoPE, then the ``paged_prefill_write`` / ``paged_decode_attention``
kernels) or ``"fused"`` (the ``fused_rope_prefill_write`` /
``fused_rope_decode_append`` kernels).

The pools ``k_pages``/``v_pages`` are updated **in place**.  The JAX
engine threads immutable pools through ``jit`` with buffer donation; in
PyTorch a functional update would copy a pool that is most of the card's
memory and double it.  The JAX ``jit(while_loop)`` decode keeps its
semantics: the condition ``step < S and not all(done)`` is checked before
each step, ``done |= (cur == eos) | (step + 1 >= forced)``, and the token
computed last is kept as the resident's next token.  Pad rows read and
write the null page 0, which is never observable.

The JAX engine's compiled executables become ``engine.graphs``' captured
work per bucket (``step_graphs``, its ``_compiled``): CUDA graphs replayed
on the card, the same closures over the same static buffers on the CPU.
A slice's decode is one ``graphs.Loop``, the ``while_loop`` on the
device: one replay runs every step under a WHILE node whose condition a
kernel sets (``kernels.graph_loop``), and the host reads the loop's
out, steps, done and next tokens once.  A paged bucket's loop is
``("paged", attn_impl, B, nb, slice_len)`` over the engine's pools; its
prefill and tail prefill are ``graphs.Prefill``s, ``("prefill",
attn_impl, B, L, nb)`` and ``("tail", attn_impl, B, L, nb)``, whose first
tokens come back to the host as in JAX.  A dense bucket ``("dense", B, L,
slice_len, extra input shapes)`` is the JAX ``_serve_fn``: its prefill and
its loop in one graph, over one cache arena (``graphs.Arena``) that the
prefill's cache is copied into, sized by the largest bucket so far (when
it grows, every other dense graph is dropped and captured again).  The
eager paths serve where ``graphs.eager_reason`` says
(``graphs.disabled()``, DTensor parameters).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.request import bucket_len
from repro_torch.engine import graphs
from repro_torch.engine.sampling import greedy
from repro_torch.kvcache import (PageAllocator, PagedKVCache, PrefixIndex,
                                 batch_block_table, batch_slot_pos,
                                 init_page_pools)
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import check_impl
from repro_torch.models.registry import Model


def _pow2_bucket(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


#: decode-stage block tables are bucketed to multiples of this many blocks
NB_BUCKET = 4

#: forced-length sentinel: at/above it a row decodes until the model's own
#: EOS token (shared protocol with ``serving.backends.RealBackend``)
EOS_DRIVEN = 1 << 30


class _Resident:
    """Per-request page state retained across slices."""

    __slots__ = ("n_tokens", "next_token", "stamp")

    def __init__(self, n_tokens: int, next_token: int, stamp: int):
        self.n_tokens = n_tokens      # tokens whose K/V live in pages
        self.next_token = next_token  # precomputed first token of the resume
        self.stamp = stamp            # LRU clock for evict-on-pressure


class StaticEngine:
    """Static-batching engine on one device: ``serve_batch`` over a dense
    per-slice cache, or ``serve_batch_paged`` over an engine-owned page
    pool (``kv_layout="paged"``).

    ``device`` defaults to the CUDA card (and raises without one); the
    model's parameters must already live there."""

    def __init__(self, model: Model, params, eos_id: int = 1,
                 pad_id: int = 0, len_bucket: int = 16,
                 extra_inputs: Optional[Dict[str, np.ndarray]] = None,
                 kv_layout: str = "dense", page_tokens: int = 16,
                 kv_pool_tokens: Optional[int] = None,
                 prefix_sharing: bool = True, attn_impl: str = "unfused",
                 device: DeviceLike = None):
        check_impl(attn_impl)
        self.extra_inputs = extra_inputs or {}
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        cfg = model.cfg
        if kv_layout == "paged":
            if cfg.family != "dense":
                raise ValueError("persistent paged StaticEngine: dense "
                                 f"family only, got {cfg.family!r}")
            if self.extra_inputs:
                raise ValueError("persistent paged StaticEngine does not "
                                 "take frontend extra_inputs")
            if kv_pool_tokens is None or kv_pool_tokens <= 0:
                raise ValueError("kv_layout='paged' needs kv_pool_tokens "
                                 "(the engine-owned page pool size)")
            if kv_pool_tokens % page_tokens:
                raise ValueError(f"kv_pool_tokens {kv_pool_tokens} must be "
                                 f"a multiple of page_tokens {page_tokens}")
        self.device = resolve_device(device)
        if params.embed.table.device != self.device:
            raise ValueError(f"params live on {params.embed.table.device}, "
                             f"the engine on {self.device}")
        self.model = model
        self.params = params
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.len_bucket = len_bucket
        self.kv_layout = kv_layout
        self.attn_impl = attn_impl
        self.prefix_sharing = prefix_sharing and kv_layout == "paged"
        self.allocator: Optional[PageAllocator] = None
        #: device work counters: prefill model calls (a dense slice's
        #: prefill, stages A and A' of a paged slice), the stage-A' (tail)
        #: calls among them, and decode iterations — each runs one launch
        #: per layer of each kernel on its path
        self.n_prefill_stages = 0
        self.n_tail_prefill_stages = 0
        self.n_decode_steps = 0
        #: slices decoded through a ``graphs.Loop``: each tests its
        #: condition once per step and once before the first
        #: (``graph_loop``'s launches on the card)
        self.n_loops = 0
        #: the decode step of each bucket (captured on the card)
        self.step_graphs = graphs.GraphCache(self.device)
        if kv_layout == "dense":
            self._arena = graphs.Arena(self.device)
            return
        self.page_tokens = page_tokens
        self.allocator = PageAllocator(kv_pool_tokens // page_tokens,
                                       page_tokens)
        self._k_pages, self._v_pages = init_page_pools(
            cfg.n_layers, self.allocator.n_pages, page_tokens,
            cfg.n_kv_heads, cfg.head_dim, cfg.dtype, self.device)
        self._resident: Dict[int, _Resident] = {}
        self._prefix = PrefixIndex(page_tokens)
        self._stamp = 0
        self.n_evictions = 0

    # ------------------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _empty_cache(self, block_table: torch.Tensor) -> PagedKVCache:
        B = block_table.shape[0]
        W = block_table.shape[1] * self.page_tokens
        return PagedKVCache(
            self._k_pages, self._v_pages, block_table,
            torch.full((B, W), -1, dtype=torch.int32, device=self.device),
            torch.zeros((B,), dtype=torch.int32, device=self.device))

    def _prefill_paged(self, tokens: np.ndarray, lengths: np.ndarray,
                       block_table: np.ndarray) -> np.ndarray:
        self.n_prefill_stages += 1
        if not self._eager():
            return self._replay_prefill("prefill", block_table.shape[1],
                                        tokens=tokens, lengths=lengths,
                                        block_table=block_table)
        cache = self._empty_cache(self._tensor(block_table))
        logits, _ = tfm.prefill_paged(self.params, self.model.cfg,
                                      self._tensor(tokens),
                                      self._tensor(lengths), cache,
                                      attn_impl=self.attn_impl)
        return greedy(logits).cpu().numpy()  # host transfer: blocks

    def _prefill_tail_paged(self, tokens: np.ndarray, start: np.ndarray,
                            lengths: np.ndarray,
                            block_table: np.ndarray) -> np.ndarray:
        self.n_prefill_stages += 1
        self.n_tail_prefill_stages += 1
        if not self._eager():
            return self._replay_prefill("tail", block_table.shape[1],
                                        tokens=tokens, start=start,
                                        lengths=lengths,
                                        block_table=block_table)
        cache = self._empty_cache(self._tensor(block_table))
        logits, _ = tfm.prefill_tail_paged(self.params, self.model.cfg,
                                           self._tensor(tokens),
                                           self._tensor(start),
                                           self._tensor(lengths), cache,
                                           attn_impl=self.attn_impl)
        return greedy(logits).cpu().numpy()  # host transfer: blocks

    def _replay_prefill(self, kind: str, nb: int,
                        **inputs: np.ndarray) -> np.ndarray:
        """A paged prefill (``kind`` "prefill") or tail prefill ("tail")
        through its bucket's ``graphs.Prefill``, ``(kind, attn_impl, B, L,
        nb)`` (the JAX engine's jitted ``_prefill_paged`` /
        ``_prefill_tail_paged``): the inputs are copied into its static
        buffers, the pools are written in place, and the first tokens come
        back to the host (a blocking transfer, as in JAX)."""
        B, L = inputs["tokens"].shape
        key = (kind, self.attn_impl, B, L, nb)
        pre = self.step_graphs.get(key) or self._add_prefill(key, **inputs)
        for name, a in inputs.items():
            pre.bufs[name].copy_(torch.from_numpy(np.ascontiguousarray(a)))
        pre()
        return pre.bufs["first"].cpu().numpy()  # host transfer: blocks

    def _add_prefill(self, key, **inputs: np.ndarray) -> graphs.Prefill:
        """A paged bucket's ``Prefill`` over static tokens, lengths, block
        table (and, for a tail, start) of ``inputs``' shapes, the engine's
        pools, and the static first tokens (B,)."""
        bufs = {name: self._tensor(a) for name, a in inputs.items()}
        B = inputs["tokens"].shape[0]
        bufs["first"] = torch.zeros((B,), dtype=torch.int32,
                                    device=self.device)
        cache = bufs["cache"] = self._empty_cache(bufs["block_table"])
        cfg, impl = self.model.cfg, self.attn_impl

        def fn() -> None:
            if "start" in bufs:
                logits, _ = tfm.prefill_tail_paged(
                    self.params, cfg, bufs["tokens"], bufs["start"],
                    bufs["lengths"], cache, attn_impl=impl)
            else:
                logits, _ = tfm.prefill_paged(self.params, cfg,
                                              bufs["tokens"],
                                              bufs["lengths"], cache,
                                              attn_impl=impl)
            bufs["first"].copy_(greedy(logits))

        return self.step_graphs.add_prefill(key, fn, bufs)

    def _eager(self) -> bool:
        return graphs.eager_reason(self.params,
                                   self.model.cfg.family) is not None

    def _loop_bufs(self, B: int, slice_len: int,
                   **more: object) -> Dict[str, object]:
        """A bucket's loop state: out (B, S), done (B,), the step counter
        (0-d int64), cur and forced (B,), and ``more``."""
        dev = self.device
        return dict(
            out=torch.empty((B, slice_len), dtype=torch.int32, device=dev),
            done=torch.empty((B,), dtype=torch.bool, device=dev),
            step=torch.empty((), dtype=torch.int64, device=dev),
            cur=torch.empty((B,), dtype=torch.int32, device=dev),
            forced=torch.empty((B,), dtype=torch.int32, device=dev),
            **more)

    def _body(self, bufs: Dict[str, object], decode_step):
        """One iteration of the JAX ``while_loop``'s body over a bucket's
        loop state (``_loop_bufs``) and cache ``bufs["cache"]``, where
        ``decode_step(cur, step)`` runs the model's decode step over that
        cache and returns (logits, the new cache), whose new leaves are
        copied back into it."""
        out, done, step, cur, forced = (
            bufs[k] for k in ("out", "done", "step", "cur", "forced"))
        eos = self.eos_id

        def fn() -> None:
            out.index_copy_(1, step.view(1), cur[:, None])
            done.logical_or_((cur == eos) | (step + 1 >= forced))
            logits, new = decode_step(cur, step)
            graphs.copy_back(bufs["cache"], new)
            cur.copy_(greedy(logits))
            step.add_(1)

        return fn

    def _run_loop(self, loop: graphs.Loop, forced: np.ndarray,
                  first: Optional[np.ndarray] = None):
        """``_decode_loop`` through a bucket's ``Loop``: the loop state is
        reset (``cur`` from ``first``, or from the loop's own prefill),
        then one call runs the loop while ``step < S and not all(done)``
        and brings out, steps, done and the next tokens to the host in
        one transfer.  Returns them as ``_decode_loop`` does."""
        b = loop.bufs
        b["out"].fill_(-1)
        b["done"].zero_()
        if first is not None:
            b["cur"].copy_(torch.from_numpy(first))
        b["forced"].copy_(torch.from_numpy(forced))
        r = loop()
        steps = int(r["step"])
        self.n_loops += 1
        self.n_decode_steps += steps
        return r["out"], steps, r["done"], r["cur"]

    def _decode_loop(self, cur: torch.Tensor, forced: np.ndarray,
                     slice_len: int, step_fn):
        """The JAX ``while_loop`` as a Python loop, eagerly:
        ``step_fn(cur, step)`` runs one decode iteration and returns its
        logits.  Returns (out (B, S), steps, done (B,), next tokens (B,))
        on the host."""
        forced_t = self._tensor(forced)
        B = cur.shape[0]
        out = torch.full((B, slice_len), -1, dtype=torch.int32,
                         device=self.device)
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        step = 0
        while step < slice_len and not bool(done.all()):
            out[:, step] = cur
            done |= (cur == self.eos_id) | (step + 1 >= forced_t)
            cur = greedy(step_fn(cur, step))
            step += 1
            self.n_decode_steps += 1
        return (out.cpu().numpy(), step, done.cpu().numpy(),
                cur.cpu().numpy())

    def _decode_slice(self, slice_len: int, block_table: np.ndarray,
                      slot_pos: np.ndarray, row_len: np.ndarray,
                      first_tok: np.ndarray, forced: np.ndarray):
        """One paged decode slice through the per-row block tables."""
        cfg = self.model.cfg
        if not self._eager():
            B, nb = block_table.shape
            key = ("paged", self.attn_impl, B, nb, slice_len)
            loop = (self.step_graphs.get(key)
                    or self._paged_loop(key, B, nb, slice_len))
            c = loop.bufs["cache"]
            for buf, a in ((c.block_table, block_table),
                           (c.slot_pos, slot_pos), (c.lengths, row_len)):
                buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            return self._run_loop(loop, forced, first_tok)
        cache = PagedKVCache(self._k_pages, self._v_pages,
                             self._tensor(block_table),
                             self._tensor(slot_pos), self._tensor(row_len))

        def step_fn(cur: torch.Tensor, step: int) -> torch.Tensor:
            nonlocal cache
            q_pos = cache.lengths + step  # compact layout: slot == position
            logits, cache = tfm.decode_step_paged(self.params, cfg, cache,
                                                  cur, q_pos, q_pos,
                                                  attn_impl=self.attn_impl)
            return logits

        return self._decode_loop(self._tensor(first_tok), forced, slice_len,
                                 step_fn)

    def _paged_loop(self, key, B: int, nb: int,
                    slice_len: int) -> graphs.Loop:
        """A paged bucket's ``Loop`` over the engine's pools and static
        (B, nb) block table, (B, nb·pg) slot_pos and (B,) row lengths
        (compact layout: slot == position)."""
        i32 = dict(dtype=torch.int32, device=self.device)
        cache = PagedKVCache(self._k_pages, self._v_pages,
                             torch.zeros((B, nb), **i32),
                             torch.full((B, nb * self.page_tokens), -1,
                                        **i32),
                             torch.zeros((B,), **i32))
        bufs = self._loop_bufs(B, slice_len, cache=cache)

        def decode_step(cur: torch.Tensor, step: torch.Tensor):
            q_pos = cache.lengths + step
            return tfm.decode_step_paged(self.params, self.model.cfg, cache,
                                         cur, q_pos, q_pos,
                                         attn_impl=self.attn_impl)

        return self.step_graphs.add_loop(key, self._body(bufs, decode_step),
                                         bufs, slice_len)

    def _serve_dense(self, tokens: np.ndarray, lengths: np.ndarray,
                     forced: np.ndarray, slice_len: int,
                     extra: Dict[str, np.ndarray]):
        """Prefill into a dense cache of ``L + slice_len`` slots (``+ P``
        for the VLM's prefix), then the decode loop (the JAX
        ``_serve_fn``); returns (out, steps, done)."""
        cache_window = tokens.shape[1] + slice_len
        if self.model.cfg.family == "vlm" and "prefix_embeds" in extra:
            cache_window += extra["prefix_embeds"].shape[1]
        self.n_prefill_stages += 1
        inputs = {"tokens": tokens, "lengths": lengths, **extra}
        if not self._eager():
            key = ("dense", tokens.shape[0], tokens.shape[1], slice_len) \
                + tuple((k, v.shape) for k, v in sorted(extra.items()))
            loop = self.step_graphs.get(key) or self._dense_loop(
                key, inputs, slice_len, cache_window)
            for name, a in inputs.items():
                loop.bufs[name].copy_(
                    torch.from_numpy(np.ascontiguousarray(a)))
            out, steps, done, _ = self._run_loop(loop, forced)
            return out, steps, done
        batch = {k: self._tensor(v) for k, v in inputs.items()}
        logits, cache = self.model.prefill(self.params, batch, cache_window)

        def step_fn(cur: torch.Tensor, step: int) -> torch.Tensor:
            nonlocal cache
            logits, cache = self.model.decode_step(self.params, cache, cur,
                                                   step)
            return logits

        out, steps, done, _ = self._decode_loop(greedy(logits), forced,
                                                slice_len, step_fn)
        return out, steps, done

    def _dense_loop(self, key, inputs: Dict[str, np.ndarray],
                    slice_len: int, cache_window: int) -> graphs.Loop:
        """A dense bucket's ``Loop`` with its ``Prefill`` ahead of it in
        one graph (the JAX ``_serve_fn``): the prefill reads the static
        ``inputs`` (tokens, lengths, the extra inputs), copies its cache
        into the engine's arena (``graphs.Arena``; the ring index becomes
        its 0-d leaf) and sets ``cur`` to its first tokens; the loop
        decodes over the arena.  The arena's views are made at the first
        prefill, which knows the cache's layout; an arena that must grow
        for them drops every other bucket's graph first (they were captured
        over the old buffer)."""
        statics = {name: self._tensor(a) for name, a in inputs.items()}
        bufs = self._loop_bufs(inputs["tokens"].shape[0], slice_len,
                               **statics)

        def prefill() -> None:
            logits, cache = self.model.prefill(self.params, statics,
                                               cache_window)
            if "cache" not in bufs:
                if not self._arena.fits(cache):
                    self.step_graphs.clear(keep=key)
                bufs["cache"] = self._arena.views(cache)
            graphs.fill(bufs["cache"], cache)
            bufs["cur"].copy_(greedy(logits))

        body = self._body(bufs, lambda cur, step: self.model.decode_step(
            self.params, bufs["cache"], cur, step))
        return self.step_graphs.add_loop(key, body, bufs, slice_len,
                                         head=prefill)

    # ------------------------------------------------------------------
    def _evict(self, rid: int) -> None:
        """Drop a request's retained pages — its next dispatch falls back
        to the classic §3.3 re-prefill (memory safety over retention)."""
        self._resident.pop(rid, None)
        self._prefix.remove(rid)
        self.allocator.release(rid, missing_ok=True)
        self.n_evictions += 1

    def _lru_parked(self, protected) -> Optional[int]:
        """Oldest resident request NOT in the currently dispatched batch."""
        victims = [(res.stamp, rid) for rid, res in self._resident.items()
                   if rid not in protected]
        return min(victims)[1] if victims else None

    def _extend_evicting(self, rid: int, need: int, protected) -> None:
        """``allocator.extend`` with the LRU evict-on-pressure loop;
        re-raises ``MemoryError`` when no parked victim remains."""
        while True:
            try:
                # grows the caller's reservation; serve_batch_paged unwinds
                # it on MemoryError and retention frees it later via
                # release_request/_evict
                self.allocator.extend(rid, need)  # repro: transfer(allocator-pairing) — caller-owned reservation
                return
            except MemoryError:
                victim = self._lru_parked(protected)
                if victim is None:
                    raise
                self._evict(victim)

    def release_request(self, rid: int) -> int:
        """Free a request's retained pages (finish / cancel / migration);
        a no-op for unknown rids.  Returns pages freed."""
        self._resident.pop(rid, None)
        self._prefix.remove(rid)
        return self.allocator.release(rid, missing_ok=True)

    @property
    def retained_blocks(self) -> int:
        """Blocks currently held by retained/in-flight requests."""
        return self.allocator.used_blocks if self.allocator else 0

    @torch.no_grad()
    def serve_batch_paged(self, prompts: Sequence[np.ndarray],
                          slice_len: int, rids: Sequence[int],
                          forced_gen_lens: Optional[Sequence[int]] = None,
                          already_generated: Optional[Sequence[Sequence[int]]] = None,
                          ) -> "ServeResult":
        """Serve one slice with persistent paged KV storage.

          * a request whose pages are resident performs ZERO re-prefill —
            its retained pages are remapped into the batch block table and
            decode resumes from its stored next token;
          * a non-resident request (first dispatch, evicted, migrated)
            prefills prompt + ``already_generated`` into freshly reserved
            pages (counted in ``ServeResult.reprefill_tokens``), or only
            the tail past a prefix it shares with another resident;
          * at slice end every row is trimmed to its resident tokens and
            retained until ``release_request`` or evict-on-pressure.

        Each row's envelope is its exact ``resident + slice_len`` tokens;
        on pool pressure parked residents are evicted LRU, and a
        ``MemoryError`` with no parked victim means the batcher violated
        its own bound — the rows granted in this call are unwound first.
        """
        if self.kv_layout != "paged":
            raise ValueError("serve_batch_paged needs kv_layout='paged'; a "
                             "dense engine serves through serve_batch")
        pg = self.page_tokens
        B_raw = len(prompts)
        if len(rids) != B_raw:
            raise ValueError(f"{len(rids)} rids for {B_raw} prompts — page "
                             f"residency is keyed by rid, one per row")
        if B_raw == 0:
            raise ValueError("empty batch")
        eff: List[np.ndarray] = []
        prevs: List[list] = []
        for i, p in enumerate(prompts):
            prev = list(already_generated[i]) if already_generated else []
            prevs.append(prev)
            eff.append(np.concatenate([np.asarray(p, np.int32),
                                       np.asarray(prev, np.int32)])
                       if prev else np.asarray(p, np.int32))

        # --- capacity planning: extend residents, reserve the rest,
        # evicting parked requests LRU under pressure (all-or-nothing)
        batch_set = set(rids)
        is_resident = []
        fresh: List[int] = []               # reserved this call, no residency
        grown: List[Tuple[int, int]] = []   # (rid, resident tokens before)
        shared_start: Dict[int, int] = {}   # row index -> shared prefix tokens
        shared_blocks = 0
        try:
            for i, rid in enumerate(rids):
                res = self._resident.get(rid)
                if res is not None and res.n_tokens != len(eff[i]):
                    # stale residency: fall back to a fresh prefill
                    self._evict(rid)
                    res = None
                hit_pages: List[int] = []
                if res is None and self.prefix_sharing:
                    # cross-request prefix join; at least one tail token
                    # must remain to produce the next-token logits
                    hit_pages, _ = self._prefix.lookup(eff[i])
                    n_hit = min(len(hit_pages), (len(eff[i]) - 1) // pg)
                    hit_pages = hit_pages[:n_hit]
                need = (res.n_tokens if res else len(eff[i])) + slice_len
                if res is None and hit_pages:
                    # retained past this call by design (kv_retain=
                    # "request"): freed by release_request/_evict; the
                    # except MemoryError arm below unwinds rows granted
                    # in THIS call
                    self.allocator.share(rid, hit_pages)  # repro: transfer(allocator-pairing) — retention owns it
                    fresh.append(rid)
                    self._extend_evicting(rid, need, batch_set)
                    shared_start[i] = len(hit_pages) * pg
                    shared_blocks += len(hit_pages)
                else:
                    while True:
                        try:
                            if res is not None:
                                # both arms retained by design (see the
                                # share above): freed via release_request/
                                # _evict, unwound by the except MemoryError
                                # arm below
                                if self.allocator.extend(rid, need):  # repro: transfer(allocator-pairing) — retention owns it
                                    grown.append((rid, res.n_tokens))
                            else:
                                self.allocator.reserve(rid, need)  # repro: transfer(allocator-pairing) — see above
                                fresh.append(rid)
                            break
                        except MemoryError:
                            victim = self._lru_parked(batch_set)
                            if victim is None:
                                raise
                            self._evict(victim)
                is_resident.append(res is not None)
        except MemoryError:
            for rid in fresh:
                self.allocator.release(rid, missing_ok=True)
            for rid, n_before in grown:
                if rid in self._resident:  # not evicted meanwhile
                    self.allocator.shrink(rid, n_before)
            raise

        # --- stage A: paged prefill of the non-resident rows (the clock
        # starts just before device work, as in the JAX engine)
        t0 = time.perf_counter()
        t_prefill = 0.0
        first = np.zeros((B_raw,), np.int32)
        row_len = np.zeros((B_raw,), np.int64)
        pads = [0] * B_raw
        reprefill = 0
        prefix_hit = sum(shared_start.values())
        pre_idx = [i for i in range(B_raw)
                   if not is_resident[i] and i not in shared_start]
        tail_idx = sorted(shared_start)
        L_pre = 0
        if pre_idx:
            max_eff = max(len(eff[i]) for i in pre_idx)
            L_pre = bucket_len(max_eff, self.len_bucket)
            Bp = _pow2_bucket(len(pre_idx))
            toks = np.full((Bp, L_pre), self.pad_id, np.int32)
            lens = np.ones((Bp,), np.int32)
            nb_p = -(-L_pre // pg)
            btp = np.zeros((Bp, nb_p), np.int32)
            for s, i in enumerate(pre_idx):
                e = eff[i]
                toks[s, L_pre - len(e):] = e
                lens[s] = len(e)
                pages = self.allocator.pages_of(rids[i])
                btp[s, :min(len(pages), nb_p)] = pages[:nb_p]
                if prevs[i]:  # re-prefill beyond the first (§3.3 overhead)
                    reprefill += len(e)
            tok0 = self._prefill_paged(toks, lens, btp)
            for s, i in enumerate(pre_idx):
                first[i] = int(tok0[s])
                row_len[i] = len(eff[i])
                pads[i] = L_pre - len(eff[i])
        # --- stage A': tail-only prefill of the prefix-sharing rows
        if tail_idx:
            max_tail = max(len(eff[i]) - shared_start[i] for i in tail_idx)
            T_t = bucket_len(max_tail, self.len_bucket)
            Bt = _pow2_bucket(len(tail_idx))
            toks_t = np.full((Bt, T_t), self.pad_id, np.int32)
            start_t = np.zeros((Bt,), np.int32)
            lens_t = np.zeros((Bt,), np.int32)
            nb_t = bucket_len(
                max(len(self.allocator.pages_of(rids[i])) for i in tail_idx),
                NB_BUCKET)
            btt = np.zeros((Bt, nb_t), np.int32)
            for s, i in enumerate(tail_idx):
                e, st = eff[i], shared_start[i]
                toks_t[s, T_t - (len(e) - st):] = e[st:]
                start_t[s] = st
                lens_t[s] = len(e)
                pages = self.allocator.pages_of(rids[i])
                btt[s, :min(len(pages), nb_t)] = pages[:nb_t]
                if prevs[i]:  # only the tail re-runs on a reschedule
                    reprefill += len(e) - st
            tokt = self._prefill_tail_paged(toks_t, start_t, lens_t, btt)
            for s, i in enumerate(tail_idx):
                first[i] = int(tokt[s])
                row_len[i] = len(eff[i])
                pads[i] = T_t - (len(eff[i]) - shared_start[i])
        if pre_idx or tail_idx:
            t_prefill = time.perf_counter() - t0
        for i, rid in enumerate(rids):
            if is_resident[i]:
                res = self._resident[rid]
                first[i] = res.next_token
                row_len[i] = res.n_tokens

        # --- stage B: one decode slice over the whole batch through the
        # per-row block tables (remapped retained pages + fresh ones)
        B = _pow2_bucket(B_raw)
        max_pages = max(len(self.allocator.pages_of(r)) for r in rids)
        nb = bucket_len(max_pages, NB_BUCKET)
        pages_rows = [self.allocator.pages_of(r) for r in rids] \
            + [[] for _ in range(B - B_raw)]
        bt = batch_block_table(pages_rows, nb)
        lens_full = row_len.tolist() + [0] * (B - B_raw)
        sp = batch_slot_pos(lens_full, nb, pg)
        first_full = np.concatenate(
            [first, np.full((B - B_raw,), self.pad_id, np.int32)])
        forced = self._forced_array(forced_gen_lens, B, B_raw)
        out, steps, done, nxt = self._decode_slice(
            slice_len, bt, sp, np.asarray(lens_full, np.int32), first_full,
            forced)
        wall = time.perf_counter() - t0

        # --- retention: trim every row to its resident tokens
        results = self._assemble_results(out, steps, done, forced_gen_lens,
                                         pads)
        for i, rid in enumerate(rids):
            new_len = int(row_len[i]) + steps
            self._stamp += 1
            self._resident[rid] = _Resident(new_len, int(nxt[i]),
                                            self._stamp)
            self.allocator.shrink(rid, new_len)
            if self.prefix_sharing:
                # index the row's full pages for future prefix joins
                stream = np.concatenate([eff[i], out[i, :steps]])
                self._prefix.insert(rid, stream,
                                    self.allocator.pages_of(rid))
        L_rep = bucket_len(int(max(row_len)), self.len_bucket)
        return ServeResult(results=results, steps=steps, wall_time=wall,
                           batch_input_len=max(L_pre, L_rep),
                           batch_size=B_raw,
                           early_return=steps < slice_len,
                           reprefill_tokens=reprefill,
                           prefill_time=t_prefill,
                           prefix_hit_tokens=prefix_hit,
                           shared_blocks=shared_blocks)

    @torch.no_grad()
    def serve_batch(self, prompts: Sequence[np.ndarray], slice_len: int,
                    forced_gen_lens: Optional[Sequence[int]] = None,
                    already_generated: Optional[Sequence[Sequence[int]]] = None,
                    ) -> "ServeResult":
        """Serve one static batch for at most ``slice_len`` iterations.

        ``already_generated``: per-request previously generated tokens —
        an SCLS reschedule re-prefills prompt + generated (paper §3.3
        overhead, counted in ``reprefill_tokens``)."""
        B_raw = len(prompts)
        eff = []
        reprefill = 0
        for i, p in enumerate(prompts):
            prev = list(already_generated[i]) if already_generated else []
            if prev:  # §3.3: a reschedule re-prefills prompt + generated
                reprefill += len(p) + len(prev)
            eff.append(np.concatenate([np.asarray(p, np.int32),
                                       np.asarray(prev, np.int32)])
                       if prev else np.asarray(p, np.int32))
        lengths = np.array([len(e) for e in eff], np.int32)
        L = bucket_len(int(lengths.max()), self.len_bucket)
        B = _pow2_bucket(B_raw)
        tokens = np.full((B, L), self.pad_id, np.int32)
        for i, e in enumerate(eff):
            tokens[i, L - len(e):] = e  # left padding
        lengths_p = np.concatenate([lengths, np.ones(B - B_raw, np.int32)])
        forced = self._forced_array(forced_gen_lens, B, B_raw)
        extra = {k: self._pad_extra(v, B, B_raw)
                 for k, v in self.extra_inputs.items()}
        t0 = time.perf_counter()
        out, steps, done = self._serve_dense(tokens, lengths_p, forced,
                                             slice_len, extra)
        wall = time.perf_counter() - t0
        results = self._assemble_results(
            out, steps, done, forced_gen_lens,
            [L - int(lengths[i]) for i in range(B_raw)])
        return ServeResult(results=results, steps=steps, wall_time=wall,
                           batch_input_len=L, batch_size=B_raw,
                           early_return=steps < slice_len,
                           reprefill_tokens=reprefill)

    @staticmethod
    def _pad_extra(v: np.ndarray, B: int, B_raw: int) -> np.ndarray:
        """An extra input of ``B`` or ``B_raw`` rows as ``B`` rows: the
        batch's pad rows repeat the last row."""
        v = np.asarray(v)
        if v.shape[0] == B:
            return v
        return np.concatenate([v, np.repeat(v[-1:], B - B_raw, axis=0)],
                              axis=0)

    def _forced_array(self, forced_gen_lens: Optional[Sequence[int]],
                      B: int, B_raw: int) -> np.ndarray:
        """Per-row forced lengths padded to the bucketed batch size (pad
        rows get 1 so they finish immediately); None → EOS-driven rows."""
        if forced_gen_lens is None:
            return np.full((B,), EOS_DRIVEN, np.int32)
        return np.concatenate([np.asarray(forced_gen_lens, np.int32),
                               np.ones(B - B_raw, np.int32)])

    def _assemble_results(self, out: np.ndarray, steps: int, done,
                          forced_gen_lens: Optional[Sequence[int]],
                          pads: Sequence[int]) -> List[dict]:
        """Per-row slice outcomes: a forced length below the sentinel
        emulates a known EOS position; the sentinel (or no forced list)
        means EOS-driven — the model's own EOS token ends the row."""
        results = []
        for i, pad in enumerate(pads):
            toks = out[i, :steps]
            f = (int(forced_gen_lens[i]) if forced_gen_lens is not None
                 else EOS_DRIVEN)
            if f < EOS_DRIVEN:
                n_valid = min(f, steps)
            else:
                eos_pos = np.where(toks == self.eos_id)[0]
                n_valid = int(eos_pos[0]) + 1 if len(eos_pos) else steps
            results.append(dict(tokens=toks[:n_valid].tolist(),
                                n_valid=n_valid,
                                finished=n_valid < steps or bool(done[i]),
                                invalid=steps - n_valid,
                                pad=pad))
        return results


class ServeResult:
    def __init__(self, results: List[dict], steps: int, wall_time: float,
                 batch_input_len: int, batch_size: int, early_return: bool,
                 reprefill_tokens: int = 0,
                 prefill_time: Optional[float] = None,
                 prefix_hit_tokens: int = 0, shared_blocks: int = 0):
        self.results = results
        self.steps = steps
        self.wall_time = wall_time
        self.batch_input_len = batch_input_len
        self.batch_size = batch_size
        self.early_return = early_return
        #: tokens prefilled beyond each request's FIRST prefill this call —
        #: the paper's §3.3 rescheduling overhead, 0 for resumed residents
        self.reprefill_tokens = reprefill_tokens
        #: wall seconds of the prefill stages (0.0 when every row resumed
        #: resident)
        self.prefill_time = prefill_time
        #: prompt tokens satisfied by a cross-request prefix-page join
        #: this call, and the pages those joins took references on
        self.prefix_hit_tokens = prefix_hit_tokens
        self.shared_blocks = shared_blocks
