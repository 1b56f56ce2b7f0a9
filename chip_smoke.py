#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which ends the script with a non-zero exit code when it
fails (nothing is caught):

1. device: the card's name and power limit from ``nvidia-smi``; float32
   matrix products are kept out of TF32;
2. build: ``nvcc`` compiles every CUDA kernel of the port from
   ``src/repro_torch/kernels/csrc`` (one process per source, all at once);
3. kernels: each kernel runs at the main path's full-width shapes
   (llama3.2-1b: 32 query heads, 8 KV heads, head_dim 64, 16-token pages,
   bf16, 8 rows of about 512 tokens over a page pool of the slice's size)
   and is held against its plain PyTorch version on the same inputs, then
   timed beside that plain version, a PyTorch library call computing the
   same function, and the least time the card could take;
4. reference: on a small input, the paged serving path (through the
   kernels) is held against the dense plain-PyTorch path of the same model;
5. slice: full-width llama3.2-1b in bf16 with random weights, built by
   ``repro_torch.launch.serve`` (SCLS, one worker, persistent paged KV with
   ``kv_retain="request"`` and prefix sharing), serves a CodeFuse trace
   plus requests that repeat an earlier prompt's leading pages.  Every
   request must complete, prefix sharing must hit, and each kernel must
   have launched exactly once per layer per prefill stage / decode step;
6. profile: one more slice (8 fresh 256-token requests, 32 decode steps)
   under ``torch.profiler``, for the device's busy share of its wall time.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the ``nvidia-smi`` reading and the one before that the
per-kernel JSON (launches from phase 5, times from phase 3).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
DECODE_TOL = 2e-2            # bf16 decode attention vs its plain version
REF_TOL = 5e-2               # logits, paged kernels vs dense plain path,
                             # relative to the largest |logit| (bf16, 16 layers)
ITERS = 50
SLEEP_CYCLES = 2_000_000     # ~1 ms of device sleep at the H100's clocks


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def card_reading() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, flush: torch.Tensor, iters: int = ITERS) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed by
    CUDA events with the L2 cache flushed before it (the main path reads
    16 layers' distinct pools, so the kernels find it cold).  A device-side
    sleep before the start event keeps the card busy while the host
    enqueues ``fn``, so the events time the device's work and not the
    wrapper's Python; a host synchronisation inside ``fn`` (the plain
    write's boolean indexing) still counts, as it does on the main path."""
    fn()  # warm-up
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound(n_bytes: float, n_flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the bf16 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: the kernels at full width
# ---------------------------------------------------------------------------
def pool_pages(cfg, m_available: float, page_tokens: int) -> int:
    from repro_torch.core.memory import PagedMemoryEstimator
    from repro_torch.models.registry import get_model
    mem = PagedMemoryEstimator(
        delta_bytes=get_model(cfg).kv_bytes_per_token(),
        m_available=m_available, zeta=0.9, page_tokens=page_tokens,
        bucket=8, kv_retain="request")
    return mem.total_blocks


def check_decode(cfg, n_pages: int, pg: int, gen: torch.Generator,
                 flush: torch.Tensor) -> dict:
    from repro_torch.core.request import bucket_len
    from repro_torch.engine.static_engine import NB_BUCKET
    from repro_torch.kernels import paged_decode_attention as kmod
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    B, Hq, Hkv, D = 8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # live slots per row (the current token included); the last row is a
    # batch-bucket pad row: null pages only, every slot masked
    n_live = [512, 497, 530, 505, 520, 489, 515, 0]
    nb = bucket_len(max(-(-n // pg) for n in n_live), NB_BUCKET)
    shape = (n_pages + 1, pg, Hkv, D)
    k_pages = torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)
    v_pages = torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)
    perm = torch.randperm(n_pages, generator=gen, device=dev) + 1
    bt = torch.zeros((B, nb), dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(n_live):
        k = -(-n // pg)
        bt[b, :k] = perm[used:used + k]
        used += k
    slots = torch.arange(nb * pg, device=dev)[None]
    lens = torch.tensor(n_live, device=dev)[:, None]
    slot_pos = torch.where(slots < lens, slots, -1).to(torch.int32)
    q_pos = (torch.tensor(n_live, device=dev) - 1).clamp(min=0).to(torch.int32)
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(cfg.dtype)

    out = kmod.paged_decode_attention(q, k_pages, v_pages, bt, slot_pos, q_pos)
    want = ref.paged_decode_attention_ref(q, k_pages, v_pages, bt, slot_pos,
                                          q_pos)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    log(f"paged_decode_attention: max |kernel - plain| = {err:.3e} "
        f"(tolerance {DECODE_TOL})")
    if not err <= DECODE_TOL:
        raise SystemExit("paged_decode_attention disagrees with its plain "
                         "version")

    # library yardstick: one SDPA call over the gathered window, the G
    # query heads of a KV head taken as G queries of that head
    G = Hq // Hkv
    kw = k_pages[bt.long()].reshape(B, nb * pg, Hkv, D).transpose(1, 2)
    vw = v_pages[bt.long()].reshape(B, nb * pg, Hkv, D).transpose(1, 2)
    kw, vw = kw.contiguous(), vw.contiguous()
    qg = q.reshape(B, Hkv, G, D)
    mask = (slot_pos >= 0)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_kernel = time_ms(lambda: kmod.paged_decode_attention(
        q, k_pages, v_pages, bt, slot_pos, q_pos), flush)
    t_plain = time_ms(lambda: ref.paged_decode_attention_ref(
        q, k_pages, v_pages, bt, slot_pos, q_pos), flush)
    t_lib = time_ms(lambda: sdpa(qg, kw, vw, attn_mask=mask), flush)
    n_valid = sum(n_live)
    elt = k_pages.element_size()
    n_bytes = (2 * n_valid * Hkv * D * elt          # live K and V slots
               + 2 * B * Hq * D * elt               # q in, out
               + bt.numel() * 4 + slot_pos.numel() * 4 + B * 4)
    n_flops = 4 * n_valid * Hq * D                  # QK^T and PV
    b_ms, b_by = bound(n_bytes, n_flops)
    log(f"paged_decode_attention: kernel {t_kernel:.4f} ms, plain "
        f"{t_plain:.4f} ms, library {t_lib:.4f} ms, bound {b_ms:.4f} ms")
    return dict(name="paged_decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
                replaces="src/repro/kernels/paged_decode_attention.py:107",
                max_abs_err=err, ms=t_kernel, kernel_ms=t_kernel,
                plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=t_lib, library="scaled_dot_product_attention "
                "on the pre-gathered window",
                shape=dict(B=B, Hq=Hq, Hkv=Hkv, D=D, pg=pg, nb=nb,
                           n_valid_tokens=n_valid, pool_pages=n_pages + 1))


def check_write(cfg, n_pages: int, pg: int, gen: torch.Generator,
                flush: torch.Tensor) -> dict:
    from repro_torch.kernels import paged_prefill_write as kmod
    from repro_torch.kernels import ref
    from repro_torch.models.transformer import make_positions
    dev = torch.device("cuda")
    B, T, Hkv, D = 8, 512, cfg.n_kv_heads, cfg.head_dim
    # a stage-A prefill batch: left-padded rows of their own lengths; the
    # last row is a stage-A' tail whose positions start past a 2-page
    # shared prefix (its slots below 32 must stay untouched)
    lengths = torch.tensor([512, 497, 480, 505, 460, 489, 300, 544],
                           device=dev)
    start = torch.tensor([0] * 7 + [2 * pg], device=dev)
    tokens = torch.zeros((B, T), dtype=torch.int32, device=dev)
    base = make_positions(tokens, lengths - start)
    positions = torch.where(base >= 0, base + start[:, None],
                            -1).to(torch.int32)
    nb = -(-int(lengths.max()) // pg)
    shape = (n_pages + 1, pg, Hkv, D)
    k_pool = torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)
    v_pool = torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)
    perm = torch.randperm(n_pages, generator=gen, device=dev) + 1
    bt = perm[:B * nb].reshape(B, nb).to(torch.int32).contiguous()
    k_new = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(cfg.dtype)
    v_new = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(cfg.dtype)

    k_a, v_a = k_pool.clone(), v_pool.clone()
    kmod.paged_prefill_write(k_new, v_new, positions, bt, k_a, v_a)
    k_b, v_b = k_pool.clone(), v_pool.clone()
    ref.paged_prefill_write_ref(k_new, v_new, positions, bt, k_b, v_b)
    torch.cuda.synchronize()
    err = max((k_a.float() - k_b.float()).abs().max().item(),
              (v_a.float() - v_b.float()).abs().max().item())
    exact = torch.equal(k_a, k_b) and torch.equal(v_a, v_b)
    log(f"paged_prefill_write: pools bit-identical to the plain version: "
        f"{exact} (max |diff| {err:.3e}, tolerance: exact)")
    if not exact:
        raise SystemExit("paged_prefill_write disagrees with its plain "
                         "version")
    del k_b, v_b

    valid = positions >= 0
    slot = positions.clamp(min=0).long()
    page = torch.gather(bt.long(), 1, slot // pg)[valid]
    off = (slot % pg)[valid]
    k_valid, v_valid = k_new[valid], v_new[valid]

    def library():
        k_a.index_put_((page, off), k_valid)
        v_a.index_put_((page, off), v_valid)

    t_kernel = time_ms(lambda: kmod.paged_prefill_write(
        k_new, v_new, positions, bt, k_a, v_a), flush)
    t_plain = time_ms(lambda: ref.paged_prefill_write_ref(
        k_new, v_new, positions, bt, k_a, v_a), flush)
    t_lib = time_ms(library, flush)
    n_valid = int(valid.sum())
    row = Hkv * D * k_new.element_size()
    n_bytes = (2 * 2 * n_valid * row                # K and V rows in and out
               + positions.numel() * 4 + n_valid * 4)   # positions, pages
    b_ms, b_by = bound(n_bytes, 0.0)
    log(f"paged_prefill_write: kernel {t_kernel:.4f} ms, plain "
        f"{t_plain:.4f} ms, library {t_lib:.4f} ms, bound {b_ms:.4f} ms")
    return dict(name="paged_prefill_write", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_prefill_write.cu",
                replaces="src/repro/kernels/paged_prefill_write.py:85",
                max_abs_err=err, ms=t_kernel, kernel_ms=t_kernel,
                plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=t_lib, library="index_put_ of the valid K and "
                "V rows at precomputed (page, offset) indices",
                shape=dict(B=B, T=T, Hkv=Hkv, D=D, pg=pg, nb=nb,
                           n_valid_tokens=n_valid, pool_pages=n_pages + 1))


# ---------------------------------------------------------------------------
# phase 4: paged kernels path against the dense plain path, small input
# ---------------------------------------------------------------------------
def check_reference(model, params, pg: int) -> dict:
    """Prefill 4 prompts and decode 4 steps through the paged path (the
    kernels) and the dense path (plain PyTorch), feeding both the same
    tokens; the logits must agree to ``REF_TOL`` of their largest
    magnitude."""
    import numpy as np
    from repro_torch.kvcache import PagedKVCache, init_page_pools
    from repro_torch.models import transformer as tfm
    cfg = model.cfg
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    lens = [40, 33, 17, 48]
    T, B, n_steps = 48, len(lens), 4
    toks = np.zeros((B, T), np.int32)
    for b, n in enumerate(lens):
        toks[b, T - n:] = rng.integers(2, cfg.vocab_size, size=n)
    tokens = torch.from_numpy(toks).to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    nb = -(-(T + n_steps) // pg)
    k_pages, v_pages = init_page_pools(cfg.n_layers, B * nb, pg,
                                       cfg.n_kv_heads, cfg.head_dim,
                                       cfg.dtype, dev)
    bt = (torch.arange(B * nb, dtype=torch.int32, device=dev)
          .reshape(B, nb) + 1)
    W = nb * pg
    cache = PagedKVCache(k_pages, v_pages, bt,
                         torch.full((B, W), -1, dtype=torch.int32,
                                    device=dev), lengths)
    with torch.no_grad():
        lp, cache = tfm.prefill_paged(params, cfg, tokens, lengths, cache)
        ld, dense = model.prefill(params, {"tokens": tokens,
                                           "lengths": lengths}, T + n_steps)
        worst = (lp.float() - ld.float()).abs().max().item() \
            / ld.float().abs().max().item()
        cur = torch.argmax(ld, -1).to(torch.int32)
        for step in range(n_steps):
            q_pos = lengths + step
            lp, cache = tfm.decode_step_paged(params, cfg, cache, cur, q_pos,
                                              q_pos)
            ld, dense = model.decode_step(params, dense, cur, step)
            rel = (lp.float() - ld.float()).abs().max().item() \
                / ld.float().abs().max().item()
            worst = max(worst, rel)
            cur = torch.argmax(ld, -1).to(torch.int32)
        torch.cuda.synchronize()
    ok = bool(torch.isfinite(lp).all()) and lp.shape == (B, cfg.vocab_size)
    log(f"reference: paged (kernels) vs dense (plain) logits over prefill + "
        f"{n_steps} decode steps: max relative difference {worst:.3e} "
        f"(tolerance {REF_TOL}), finite and shaped: {ok}")
    if not (ok and worst <= REF_TOL):
        raise SystemExit("the paged kernel path disagrees with the dense "
                         "reference path")
    return dict(max_rel_logit_diff=worst)


# ---------------------------------------------------------------------------
# phase 5: the slice, through the launcher's build_core
# ---------------------------------------------------------------------------
SLICE_ARGV = ["--backend", "real", "--arch", "llama3.2-1b",
              "--strategy", "scls", "--workers", "1", "--rate", "4",
              "--duration", "8", "--slice-len", "64", "--max-gen", "256",
              "--page-tokens", "16", "--m-available", "48e9",
              "--shared-prefix", "3", "--seed", "0"]


def run_slice():
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.parse_args(SLICE_ARGV)
    t0 = time.perf_counter()
    core, engines, vocab = serve.build_core(args)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    trace = serve.make_trace(args, vocab)
    model = engines[0].model
    ref_stats = check_reference(model, engines[0].params, args.page_tokens)

    split = [time_serve_calls(e) for e in engines]
    for e in engines:
        e.n_prefill_stages = e.n_decode_steps = 0
    ops.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = core.run(trace, args.duration)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()
    plain = dict(ops.plain_calls)

    n_layers = model.cfg.n_layers
    stages = sum(e.n_prefill_stages for e in engines)
    steps = sum(e.n_decode_steps for e in engines)
    want = {"paged_prefill_write": n_layers * stages,
            "paged_decode_attention": n_layers * steps}
    bad = [r.rid for r in trace
           if not r.done or r.output_tokens is None
           or len(r.output_tokens) != min(r.gen_len, r.max_gen)
           or not all(0 <= t < vocab for t in r.output_tokens)]
    summary = dict(dataclasses.asdict(metrics), wall_s=wall,
                   build_s=t_build, prefill_stages=stages,
                   decode_steps=steps, launches=launches,
                   plain_calls=plain, n_layers=n_layers,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   pool_pages=engines[0].allocator.n_pages,
                   serve_calls=sum(a["calls"] for a in split),
                   engine_s=sum(a["wall_s"] for a in split),
                   engine_prefill_s=sum(a["prefill_s"] for a in split),
                   **ref_stats)
    print(json.dumps({"slice": summary}), flush=True)
    if metrics.n_completed != metrics.n_requests or \
            metrics.n_requests != len(trace):
        raise SystemExit(f"{metrics.n_completed} of {len(trace)} requests "
                         f"completed")
    if bad:
        raise SystemExit(f"requests with missing or malformed output: {bad}")
    if metrics.prefix_hit_tokens <= 0:
        raise SystemExit("no prefix-sharing hit: the tail path never ran")
    if any(plain.values()):
        raise SystemExit(f"plain versions ran on the card: {plain}")
    if launches != want or min(launches.values()) <= 0:
        raise SystemExit(f"kernel launches {launches} != {want} implied by "
                         f"{stages} prefill stages and {steps} decode steps "
                         f"of {n_layers} layers")
    log(f"slice: {metrics.n_completed}/{metrics.n_requests} requests, "
        f"prefix hits {metrics.prefix_hit_tokens} tokens, launches "
        f"{launches} as implied")
    profile_window(engines[0], vocab)
    return launches


def time_serve_calls(engine) -> dict:
    """Sum each ``serve_batch_paged`` call's measured wall and prefill
    seconds (the engine's own clocks) into the returned dict."""
    acc = {"calls": 0, "wall_s": 0.0, "prefill_s": 0.0}
    serve = engine.serve_batch_paged

    def timed(*args, **kw):
        res = serve(*args, **kw)
        acc["calls"] += 1
        acc["wall_s"] += res.wall_time
        acc["prefill_s"] += res.prefill_time
        return res

    engine.serve_batch_paged = timed
    return acc


def profile_window(engine, vocab: int) -> None:
    """One slice of 8 fresh 256-token requests, 32 decode steps, under
    ``torch.profiler``: the device's busy share of the window's wall time
    and the kernel time by name."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2)
    ps = [rng.integers(2, vocab, size=256).astype(np.int32)
          for _ in range(8)]
    for warm in (True, False):
        rids = [10 ** 6 + i + (0 if warm else 100) for i in range(8)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = engine.serve_batch_paged(ps, 32, rids,
                                           forced_gen_lens=[32] * 8)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        for rid in rids:
            engine.release_request(rid)
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:8]
    print(json.dumps({"profile": dict(
        rows=8, prompt_tokens=256, steps=res.steps, wall_s=wall,
        prefill_s=res.prefill_time, device_busy_s=busy,
        device_busy_share=busy / wall,
        top_kernels_ms={e.key[:80]: dev_us(e) / 1e3 for e in top})}),
        flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    card = card_reading()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; TF32 off for float32 matmul and cuDNN")

    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {len(build.KERNELS)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    cfg = get_config("llama3.2-1b")
    pg = 16
    n_pages = pool_pages(cfg, 48e9, pg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = [check_decode(cfg, n_pages, pg, gen, flush),
            check_write(cfg, n_pages, pg, gen, flush)]
    del flush
    torch.cuda.empty_cache()

    launches = run_slice()
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
