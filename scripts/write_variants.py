#!/usr/bin/env python3
"""Where the prefill writes' time goes: variants of
``csrc/paged_prefill_write.cu`` and ``csrc/fused_rope_prefill_write.cu``
timed on one card, beside an empty launch and a contiguous copy of the
same bytes.

    python3 scripts/write_variants.py [--steps PATH] [ROOT]

Run from a checkout (ROOT, default this one).  Each variant is a kernel's
source with one text patch (the vectors of each tensor a thread moves, so
the tokens a block takes), compiled by ``nvcc`` into
``ROOT/build/write_variants/`` and called through its C launcher at
``chip_smoke.py``'s ``WRITE_SMOKE`` shape (8 left-padded rows of 512) and
at ``SHAPES`` of one and two rows (the paged slices' stages hold 1-4 rows
of a few hundred tokens), and with ``--steps`` at the median and largest
prefill stage of each paged slice that ``chip_smoke.py --save-steps PATH``
recorded (positions and block table as recorded, pad rows and all), over
pools of the slice's size with llama3.2-1b's heads (bf16):

- ``kernel``: the source as it is (64-thread blocks; 2 vectors of V a
  thread where that still gives each SM 4 blocks, else 1);
- ``per1``, ``per2``: 1 or 2 vectors a thread whatever the size;
- ``t128``: 128-thread blocks.

Each is held against its plain version (V and the unfused K
bit-identical, the fused K within one unit in the last place, on every
slot one token names; slots no token names untouched), then
timed by ``chip_smoke.time_ms`` twice: with the L2 cache flushed by a
write of 128 MB, as ``chip_smoke.py`` times every kernel (L2 then holds
dirty lines, which the call's own traffic must write back), and flushed by
a read of the same buffer (clean lines); and traced by ``torch.profiler``
for its device time (``compare_attention.traced_kernels``).  Beside them,
per shape: an empty launch (a device sleep of 0 cycles) and one
``copy_`` of a contiguous tensor holding the valid tokens' K and V rows
(the same bytes read and written, no index), timed the same ways.
Prints one JSON line per shape, then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ARGS = sys.argv[1:]
STEPS = None
if ARGS[:1] == ["--steps"]:
    STEPS, ARGS = os.path.abspath(ARGS[1]), ARGS[2:]
ROOT = os.path.abspath(ARGS[0] if ARGS else
                       os.path.dirname(os.path.dirname(__file__)))
OUT = os.path.join(ROOT, "build", "write_variants")
FORCE = "switch (vectors_per_thread("
PATCHES = {
    name: {"kernel": [],
           "per1": [(FORCE, "switch (1 + 0 * vectors_per_thread(")],
           "per2": [(FORCE, "switch (2 + 0 * vectors_per_thread(")],
           "t128": [("constexpr int kThreads = 64;",
                     "constexpr int kThreads = 128;")]}
    for name in ("paged_prefill_write", "fused_rope_prefill_write")}
#: (label, each row's valid tokens, each row's first position, T)
SHAPES = (None, ("1x384", (300,), (0,), 384),
          ("1x1024", (1024,), (0,), 1024),
          ("2x640", (600, 503), (0, 0), 640))


def build_variants(build) -> dict:
    """Compile every patched source, all at once; returns each variant's
    loaded C launcher by (kernel, variant)."""
    os.makedirs(OUT, exist_ok=True)
    jobs = []
    for name, variants in PATCHES.items():
        src = open(os.path.join(build.CSRC, f"{name}.cu")).read()
        for var, patch in variants.items():
            text = src
            for old, new in patch:
                if old not in text:
                    raise SystemExit(f"{name} {var}: patch text not found")
                text = text.replace(old, new)
            cu = os.path.join(OUT, f"{name}_{var}.cu")
            with open(cu, "w") as f:
                f.write(text)
            so = os.path.join(OUT, f"lib{name}_{var}.so")
            cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                   "-o", so, cu]
            jobs.append((name, var, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    fns = {}
    for name, var, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name} {var}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[variants] {name} {var}: {regs}", file=sys.stderr)
        fn = getattr(ctypes.CDLL(so), f"{name}_launch")
        if name == "paged_prefill_write":
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 \
                + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name, var] = fn
    return fns


class ReadFlush:
    """``time_ms``'s flush by a read of the buffer: L2 left clean."""

    def __init__(self, buf):
        self.buf = buf

    def zero_(self):
        self.buf.max()


def main() -> int:
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke as smoke
    from compare_attention import traced_kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.fused_rope_prefill_write import inv_freq
    if not torch.cuda.is_available():
        print("write_variants: no CUDA device", file=sys.stderr)
        return 1
    fns = build_variants(build)
    cfg = get_config("llama3.2-1b")
    Hkv, D, theta = cfg.n_kv_heads, cfg.head_dim, cfg.rope_theta
    pg = 16
    n_pages = smoke.pool_pages(cfg, 48e9, pg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flushes = {"dirty": buf, "clean": ReadFlush(buf)}
    k_pool, v_pool = smoke.paged_pools(cfg, n_pages, pg, gen)
    freqs = inv_freq(D, theta, torch.device("cuda"))
    cases = []
    for shape in SHAPES:
        if shape is None:
            cases.append((smoke.WRITE_SMOKE[0],
                          *smoke.smoke_write_indices(n_pages, pg, gen)))
            continue
        label, lengths, starts, T = shape
        positions = torch.full((len(lengths), T), -1, dtype=torch.int32)
        for b, (n, s0) in enumerate(zip(lengths, starts)):
            positions[b, T - n:] = torch.arange(s0, s0 + n)
        nb = -(-max(n + s0 for n, s0 in zip(lengths, starts)) // pg)
        bt = (torch.randperm(n_pages, generator=gen, device="cuda")
              [:len(lengths) * nb] + 1).to(torch.int32).reshape(
                  len(lengths), nb).contiguous()
        cases.append((label, positions.cuda(), bt))
    if STEPS:
        writes = torch.load(STEPS)["write_stages"]
        for _, run in smoke.ENGINE_WRITES:
            for label, st, _ in smoke.timed_writes(writes[run]):
                if st["pool"][0] > k_pool.shape[0]:
                    raise SystemExit(f"{run} {label}: a pool of "
                                     f"{st['pool'][0]} pages")
                cases.append((f"{run} {label}", st["positions"].cuda(),
                              st["bt"].cuda()))
    for label, positions, bt in cases:
        B, T = positions.shape
        k_new, v_new = (torch.randn((B, T, Hkv, D), generator=gen,
                                    device="cuda").to(cfg.dtype)
                        for _ in range(2))
        b_ms, b_by, n_valid = smoke.write_bound(positions, Hkv, D, 2, False)
        named = smoke.written_slots(positions, bt, pg, k_pool.shape[0],
                                    times=0)
        once = smoke.written_slots(positions, bt, pg, k_pool.shape[0])
        stream = torch.cuda.current_stream().cuda_stream
        out = dict(shape=label, n_valid_tokens=n_valid, bound_ms=b_ms,
                   bound_by=b_by)
        want_k, want_v = k_pool.clone(), v_pool.clone()
        ref.paged_prefill_write_ref(k_new, v_new, positions, bt, want_k,
                                    want_v)
        fk, fv = k_pool.clone(), v_pool.clone()
        ref.fused_rope_prefill_write_ref(k_new, v_new, positions, bt, fk, fv,
                                         theta=theta)
        for (name, var), fn in fns.items():
            fused = name == "fused_rope_prefill_write"

            def call(ka, va, fn=fn, fused=fused):
                if fused:
                    args = (1, k_new.data_ptr(), v_new.data_ptr(),
                            positions.data_ptr(), bt.data_ptr(),
                            freqs.data_ptr(), ka.data_ptr(), va.data_ptr(),
                            B, T, bt.shape[1], pg, Hkv, D, stream)
                else:
                    args = (k_new.data_ptr(), v_new.data_ptr(),
                            positions.data_ptr(), bt.data_ptr(),
                            ka.data_ptr(), va.data_ptr(), B, T,
                            bt.shape[1], pg, Hkv * D * 2, stream)
                err = fn(*args)
                if err:
                    raise SystemExit(f"{name} {var}: CUDA error {err}")

            ka, va = k_pool.clone(), v_pool.clone()
            call(ka, va)
            torch.cuda.synchronize()
            wk, wv = (fk, fv) if fused else (want_k, want_v)
            ok = (torch.equal(va[once], wv[once])
                  and torch.equal(va[~named], v_pool[~named])
                  and torch.equal(ka[~named], k_pool[~named])
                  and (smoke.max_ulps(ka[once], wk[once]) <= smoke.MAX_ULPS
                       if fused else torch.equal(ka[once], wk[once])))
            if not ok:
                raise SystemExit(f"{name} {var} {label} disagrees with its "
                                 f"plain version")
            entry = {f"{mode}_ms": smoke.time_ms(
                lambda: call(ka, va), f, label=f"{name} {var} {label} {mode}")
                for mode, f in flushes.items()}
            kernels = traced_kernels(smoke, lambda: call(ka, va), buf,
                                     ("prefill_write_kernel",))
            entry["device_us"] = sum(e["dur"] for e in kernels) / max(
                len(kernels), 1)
            out[f"{name} {var}"] = entry
            del ka, va
        src = torch.randn((2, n_valid, Hkv * D), generator=gen,
                          device="cuda").to(cfg.dtype)
        dst = torch.empty_like(src)
        out["copy"] = {f"{mode}_ms": smoke.time_ms(
            lambda: dst.copy_(src), f, label=f"copy {label} {mode}")
            for mode, f in flushes.items()}
        kernels = traced_kernels(smoke, lambda: dst.copy_(src), buf,
                                 ("copy_kernel", "Memcpy"))
        out["copy"]["device_us"] = sum(e["dur"] for e in kernels) / max(
            len(kernels), 1)
        out["empty_launch"] = {f"{mode}_ms": smoke.time_ms(
            lambda: torch.cuda._sleep(0), f, label=f"empty {label} {mode}")
            for mode, f in flushes.items()}
        print(json.dumps(out), flush=True)
        del want_k, want_v, fk, fv
        torch.cuda.empty_cache()
    print(smoke.card_reading(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
