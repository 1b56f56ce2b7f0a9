"""Continuous-batching (iteration-level) engine: the ILS baseline.

PyTorch counterpart of ``repro.engine.continuous_engine``, with the same
slot-based, DeepSpeed-FastGen-like semantics:

  * a fixed number of slots (the conservative parallelism cap the paper
    criticizes);
  * at every iteration boundary finished requests exit and waiting
    requests join (FCFS), each join paying its own ``len_bucket``-padded
    prefill;
  * no padding or invalid tokens are ever generated.

KV layouts (``kv_layout``):

  * ``"dense"``: each slot owns a contiguous W-slot row of a shared cache,
    reserved worst-case at construction; decode runs
    ``models.transformer.decode_step_rowslots`` (the ``decode_attention``
    kernel on the card);
  * ``"paged"``: K/V live in a shared page pool; a join reserves exactly
    its slice envelope ``bucketed(L_i) + min(forced, max_gen)`` tokens of
    pages (paper Eq. 5), waits at the head of the line while pages are
    short, and frees them on exit; decode runs
    ``models.transformer.decode_step_paged`` (the ``paged_decode_attention``
    kernel on the card).

Both layouts prefill a join through ``models.transformer.prefill`` (the
``flash_prefill`` kernel on the card).  Rows advance independently through
per-row write slots.  The JAX engine's jitted join prefill and decode
become ``engine.graphs``' captured work (``step_graphs``): a
``graphs.Prefill`` per join width ``("join", L)`` into one static
single-row cache, which the join then inserts eagerly (JAX's ``.at[].set``
runs outside its jit too), and one ``graphs.Step`` (``"decode"``) over the
engine's fixed cache, whose tokens, positions and write slots are static
buffers: CUDA graphs replayed on the card, the same closures on the CPU;
the eager paths serve where ``graphs.eager_reason`` says.  Caches and page
pools are updated in place.  Dense-family models only, as
in the JAX package.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.request import bucket_len
from repro_torch.engine import graphs
from repro_torch.engine.sampling import greedy
from repro_torch.kvcache import (PageAllocator, clear_row,
                                 init_paged_kv_cache, write_prefill_pages)
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import KVCache
from repro_torch.models.registry import Model


class _Slot:
    __slots__ = ("req_idx", "cached", "base", "gen", "cur", "forced")

    def __init__(self):
        self.req_idx = -1
        self.cached = 0
        self.base = 0  # padded prefill width: decode writes go at base + gen
        self.gen = 0
        self.cur = 0
        self.forced = 1 << 30


class ContinuousEngine:
    """Iteration-level batching over ``max_slots`` rows on one device.

    ``device`` defaults to the CUDA card (and raises without one); the
    model's parameters must already live there."""

    def __init__(self, model: Model, params, max_slots: int = 8,
                 max_context: int = 2048, eos_id: int = 1, pad_id: int = 0,
                 len_bucket: int = 16, kv_layout: str = "dense",
                 page_tokens: int = 16,
                 total_kv_tokens: Optional[int] = None,
                 device: DeviceLike = None):
        cfg = model.cfg
        if cfg.family != "dense":
            raise ValueError(f"ILS engine: dense family only, got "
                             f"{cfg.family!r}")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        self.device = resolve_device(device)
        if params.embed.table.device != self.device:
            raise ValueError(f"params live on {params.embed.table.device}, "
                             f"the engine on {self.device}")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.W = max_context
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.len_bucket = len_bucket
        self.kv_layout = kv_layout
        #: device work counters: joins' prefills and decode iterations,
        #: each one kernel launch per layer on the card
        self.n_prefill_stages = 0
        self.n_decode_steps = 0
        #: the decode step over the fixed cache (captured on the card)
        self.step_graphs = graphs.GraphCache(self.device)
        #: the joins' static single-row cache (``_join``)
        self._single = None
        self.alloc: Optional[PageAllocator] = None
        if kv_layout == "paged":
            if self.W % page_tokens:
                raise ValueError(f"max_context {self.W} must be a multiple "
                                 f"of page_tokens {page_tokens}")
            self.page_tokens = page_tokens
            # byte-budget parity with dense by default: the same slot
            # count's worth of cache, allocated block by block on demand
            total = (total_kv_tokens if total_kv_tokens is not None
                     else max_slots * self.W)
            if total % page_tokens:
                raise ValueError(f"total_kv_tokens {total} must be a "
                                 f"multiple of page_tokens {page_tokens}")
            self.alloc = PageAllocator(total // page_tokens, page_tokens)
            self.cache = init_paged_kv_cache(
                cfg.n_layers, max_slots, self.alloc.n_pages, page_tokens,
                self.W // page_tokens, cfg.n_kv_heads, cfg.head_dim,
                cfg.dtype, self.device)
        else:
            shape = (cfg.n_layers, max_slots, self.W, cfg.n_kv_heads,
                     cfg.head_dim)
            self.cache = KVCache(
                k=torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                v=torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                slot_pos=torch.full((max_slots, self.W), -1,
                                    dtype=torch.int32, device=self.device),
                write_idx=0,
                lengths=torch.zeros((max_slots,), dtype=torch.int32,
                                    device=self.device))

    # ------------------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _run_prefill(self, prompt: np.ndarray):
        """A join's prefill of one row, left-padded to its ``len_bucket``
        width L, into a single-row cache of width W: through the
        ``("join", L)`` ``graphs.Prefill`` (the JAX engine's jitted
        prefill), or eagerly where ``graphs.eager_reason`` says.  Returns
        (first token, L, the single-row cache)."""
        L = bucket_len(len(prompt), self.len_bucket)
        toks = np.full((1, L), self.pad_id, np.int32)
        toks[0, L - len(prompt):] = prompt
        lens = np.asarray([len(prompt)], np.int32)
        self.n_prefill_stages += 1
        if graphs.eager_reason(self.params, self.cfg.family) is None:
            pre = self.step_graphs.get(("join", L)) or self._join(L)
            pre.bufs["tokens"].copy_(torch.from_numpy(toks))
            pre.bufs["lengths"].copy_(torch.from_numpy(lens))
            pre()
            return int(pre.bufs["first"][0]), L, self._single
        last_logits, single = tfm.prefill(
            self.params, self.cfg, self._tensor(toks), self._tensor(lens),
            self.W)
        return int(greedy(last_logits)[0]), L, single

    def _join(self, L: int) -> graphs.Prefill:
        """The ``Prefill`` of a join of width ``L``: static tokens (1, L)
        and lengths (1,) in, the first token (1,) and the single-row
        cache out.  Every width's prefill writes the one static
        single-row cache ``_single`` (its layout is W's, whatever L;
        made at the first join), which ``_insert`` / ``_insert_paged``
        read."""
        i32 = dict(dtype=torch.int32, device=self.device)
        bufs = dict(tokens=torch.zeros((1, L), **i32),
                    lengths=torch.ones((1,), **i32),
                    first=torch.zeros((1,), **i32))

        def fn() -> None:
            last, single = tfm.prefill(self.params, self.cfg, bufs["tokens"],
                                       bufs["lengths"], self.W)
            if self._single is None:
                self._single = graphs.Arena(self.device).views(single)
            graphs.fill(self._single, single)
            bufs["first"].copy_(greedy(last))

        return self.step_graphs.add_prefill(("join", L), fn, bufs)

    def _insert(self, row: int, prompt: np.ndarray):
        """Dense join, in place: returns (first_token, padded width)."""
        first, L, single = self._run_prefill(prompt)
        c = self.cache
        c.k[:, row] = single.k[:, 0]
        c.v[:, row] = single.v[:, 0]
        c.slot_pos[row] = single.slot_pos[0]
        c.lengths[row] = len(prompt)
        return first, L

    def _insert_paged(self, row: int, prompt: np.ndarray, pages: List[int]):
        """Paged join: scatter the prefill K/V into the reserved pages."""
        first, L, single = self._run_prefill(prompt)
        T = len(pages) * self.page_tokens  # covers prefill + decode envelope
        self.cache = write_prefill_pages(
            self.cache, row, pages, single.k[:, 0, :T], single.v[:, 0, :T],
            single.slot_pos[0, :T], len(prompt))
        return first, L

    def _tokens_needed(self, prompt_len: int, forced_cap: int) -> int:
        """The slice envelope (L_i + S) this join must reserve: Eq. 5."""
        base = bucket_len(prompt_len, self.len_bucket)
        return min(base + forced_cap, self.W)

    def _decode_fn(self):
        return (tfm.decode_step_paged if self.kv_layout == "paged"
                else tfm.decode_step_rowslots)

    def _decode(self, cur: np.ndarray, q_pos: np.ndarray,
                wslots: np.ndarray) -> np.ndarray:
        self.n_decode_steps += 1
        if graphs.eager_reason(self.params, self.cfg.family) is None:
            step = self.step_graphs.get("decode") or self._decode_step()
            b = step.bufs
            for name, a in (("cur", cur), ("q_pos", q_pos),
                            ("wslots", wslots)):
                b[name].copy_(torch.from_numpy(a))
            step()
            return b["next"].cpu().numpy()  # host transfer: blocks
        args = (self._tensor(cur), self._tensor(q_pos), self._tensor(wslots))
        logits, new = self._decode_fn()(self.params, self.cfg, self.cache,
                                        *args)
        graphs.copy_back(self.cache, new)  # the step's buffers stay valid
        return greedy(logits).cpu().numpy()  # host transfer: blocks

    def _decode_step(self) -> graphs.Step:
        """The ``Step`` over the engine's cache (``bufs["cache"]``): one
        decode iteration of every slot from the static (max_slots,)
        tokens, positions and write slots to the static next tokens."""
        cache, decode = self.cache, self._decode_fn()
        bufs = {name: torch.zeros((self.max_slots,), dtype=torch.int32,
                                  device=self.device)
                for name in ("cur", "q_pos", "wslots", "next")}
        bufs["cache"] = cache

        def fn() -> None:
            logits, new = decode(self.params, self.cfg, cache, bufs["cur"],
                                 bufs["q_pos"], bufs["wslots"])
            graphs.copy_back(cache, new)
            bufs["next"].copy_(greedy(logits))

        return self.step_graphs.add("decode", fn, bufs)

    # ------------------------------------------------------------------
    def serve(self, prompts: Sequence[np.ndarray],
              forced_gen_lens: Optional[Sequence[int]] = None,
              max_gen: int = 1024,
              max_iters: int = 100000) -> "ContinuousResult":
        """Serve all prompts to completion with continuous batching."""
        n = len(prompts)
        forced = (list(forced_gen_lens) if forced_gen_lens is not None
                  else [1 << 30] * n)
        if self.kv_layout == "paged":
            # validate every envelope BEFORE any reservation: raising
            # mid-run would leak in-flight requests' pages, and a
            # never-fitting request cannot just wait (it would starve
            # itself and everything FCFS behind it)
            for i, p in enumerate(prompts):
                need = self._tokens_needed(len(p), min(forced[i], max_gen))
                if self.alloc.blocks_for_tokens(need) > self.alloc.n_pages:
                    raise ValueError(
                        f"request {i}: envelope of {need} tokens exceeds "
                        f"the page pool ({self.alloc.n_pages} x "
                        f"{self.page_tokens})")
        waiting = list(range(n))
        slots = [_Slot() for _ in range(self.max_slots)]
        outputs: List[List[int]] = [[] for _ in range(n)]
        join_order: List[int] = []
        concurrency: List[int] = []
        t0 = time.perf_counter()
        iters = 0
        try:
            while iters < max_iters:
                iters += 1
                # joins (FCFS): dense is capped by the slot count alone;
                # paged also needs the request's (L_i + S) envelope in
                # free pages, so the cap becomes the actual free memory
                for s_i, s in enumerate(slots):
                    if s.req_idx < 0 and waiting:
                        ridx = waiting[0]
                        if self.kv_layout == "paged":
                            need = self._tokens_needed(
                                len(prompts[ridx]),
                                min(forced[ridx], max_gen))
                            if not self.alloc.can_reserve(need):
                                break  # FCFS: head of line waits for pages
                            pages = self.alloc.reserve(ridx, need)
                            waiting.pop(0)
                            first, base = self._insert_paged(
                                s_i, prompts[ridx], pages)
                        else:
                            waiting.pop(0)
                            first, base = self._insert(s_i, prompts[ridx])
                        s.req_idx = ridx
                        s.cached = len(prompts[ridx])
                        s.base = base
                        s.gen = 0
                        s.cur = first
                        s.forced = min(forced[ridx], max_gen)
                        join_order.append(ridx)
                active = [s for s in slots if s.req_idx >= 0]
                if not active:
                    break
                concurrency.append(len(active))
                # one decode iteration over all slots (inactive rows
                # write slot 0 of their own row or of the null page)
                cur = np.zeros((self.max_slots,), np.int32)
                q_pos = np.zeros((self.max_slots,), np.int32)
                wslots = np.zeros((self.max_slots,), np.int32)
                for s_i, s in enumerate(slots):
                    if s.req_idx >= 0:
                        cur[s_i] = s.cur
                        q_pos[s_i] = s.cached + s.gen
                        wslots[s_i] = (s.base + s.gen) % self.W
                nxt = self._decode(cur, q_pos, wslots)
                for s_i, s in enumerate(slots):
                    if s.req_idx < 0:
                        continue
                    outputs[s.req_idx].append(int(s.cur))
                    s.gen += 1
                    if s.cur == self.eos_id or s.gen >= s.forced:
                        if self.kv_layout == "paged":
                            self.alloc.release(s.req_idx)
                            self.cache = clear_row(self.cache, s_i)
                        s.req_idx = -1  # exits now; the slot joins next
                    else:
                        s.cur = int(nxt[s_i])
        finally:
            if self.kv_layout == "paged":
                # a mid-iteration exception (or max_iters) must not
                # strand in-flight envelopes: the allocator outlives this
                # call, so a stranded owner would wedge every later serve
                for s_i, s in enumerate(slots):
                    if s.req_idx >= 0:
                        self.alloc.release(s.req_idx)
                        self.cache = clear_row(self.cache, s_i)
                        s.req_idx = -1
        wall = time.perf_counter() - t0
        return ContinuousResult(outputs, wall, iters, join_order, concurrency)


class ContinuousResult:
    def __init__(self, outputs, wall_time, iterations, join_order,
                 concurrency=None):
        self.outputs = outputs
        self.wall_time = wall_time
        self.iterations = iterations
        self.join_order = join_order
        self.concurrency = concurrency or []

    @property
    def peak_parallel(self) -> int:
        return max(self.concurrency, default=0)

    @property
    def mean_parallel(self) -> float:
        return float(np.mean(self.concurrency)) if self.concurrency else 0.0
