#!/usr/bin/env python3
"""Where ssd_scan's time goes: variants of ``csrc/ssd_scan.cu`` timed on one
card, and the card's peak rates of the two routes a product can take.

    python3 scripts/ssd_variants.py [ROOT]

Run from a checkout (ROOT, default this one).  Each variant is the
kernel's source with one text patch, compiled by ``nvcc`` into
``ROOT/build/ssd_variants/`` and called through the wrapper at
``chip_smoke.py``'s 8 x 512 shape and at one row of 1,024 tokens
(mamba2-130m's widths); each prints its time (``chip_smoke.time_ms``),
each pass's profiler time (``compare_attention.profile_passes``) and its
largest |y - plain| relative to the plain version's largest |y|:

- ``kernel``: the source as it is;
- ``serial``: the passes launched one after another (no programmatic
  dependents), so that each pass's profiler time is its own;
- ``serial_nosplit``: and no hi + lo split (hi the raw bits, lo 0; three
  products still), the time of the products without the splits' work;
- ``serial_noload``: and no cp.async copies, the time without the loads;
- ``serial_1xtf32``: and one TF32 product a_hi b_hi, the error of plain
  TF32.

The last three give wrong results by design.  ``peaks`` runs
``mma.sync`` m16n8k8 TF32 and float32 FMAs from registers on every SM.
Prints one JSON line per variant, then the peaks, then the card's name
and power limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.dirname(os.path.dirname(__file__)))
OUT = os.path.join(ROOT, "build", "ssd_variants")
SERIAL = [("  asm volatile(\"griddepcontrol.launch_dependents;\\n\" ::: "
           "\"memory\");", ""),
          ("  asm volatile(\"griddepcontrol.wait;\\n\" ::: \"memory\");", ""),
          ("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")]
NOSPLIT = [("  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(hi) : \"f\"(v));",
            "  hi = __float_as_uint(v); lo = 0u; return;")]
NOLOAD = [("  const unsigned s = static_cast<unsigned>("
           "__cvta_generic_to_shared(dst));", "  return;\n  unsigned s;")]
ONE = [("mma_tf32(acc[i][j], a[i].lo, b[j].hi);", ";"),
       ("mma_tf32(acc[i][j], a[i].hi, b[j].lo);", ";"),
       ("mma_tf32(acc[j], a.lo, b[j].hi);", ";"),
       ("mma_tf32(acc[j], a.hi, b[j].lo);", ";")]
VARIANTS = {"kernel": [], "serial": SERIAL,
            "serial_nosplit": SERIAL + NOSPLIT,
            "serial_noload": SERIAL + NOLOAD, "serial_1xtf32": SERIAL + ONE}
PEAKS = r"""
#include <cuda_runtime.h>
#include <cstdint>
#include <cstdio>
__global__ void mma_loop(float* out, int iters, uint32_t seed) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (seed * (threadIdx.x + i)) & 0x3f800000u;
  for (int i = 0; i < 2; ++i) b[i] = (seed * (threadIdx.x + 7 * i)) & 0x3f800000u;
  float acc[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  float s = 0;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  if (s == 12345.f) out[0] = s;
}
__global__ void fma_loop(float* out, int iters, float seed) {
  float x[8][8], a[8], b[8];
  for (int i = 0; i < 8; ++i) { a[i] = seed + i; b[i] = seed - i; }
  for (int i = 0; i < 8; ++i) for (int j = 0; j < 8; ++j) x[i][j] = seed * (i + j);
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) x[i][j] = fmaf(a[i], b[j], x[i][j]);
  float s = 0;
  for (int i = 0; i < 8; ++i) for (int j = 0; j < 8; ++j) s += x[i][j];
  if (s == 12345.f) out[0] = s;
}
int main() {
  float* out; cudaMalloc(&out, 4);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int warps = 8, iters = 20000;
  float ms;
  mma_loop<<<sms, 32 * warps>>>(out, 10, 3);
  cudaEventRecord(e0); mma_loop<<<sms, 32 * warps>>>(out, iters, 3);
  cudaEventRecord(e1); cudaEventSynchronize(e1); cudaEventElapsedTime(&ms, e0, e1);
  const double mma = 2.0 * sms * warps * iters * 8 * 16 * 8 * 8 / ms / 1e9;
  fma_loop<<<sms, 32 * warps>>>(out, 10, 1.f);
  cudaEventRecord(e0); fma_loop<<<sms, 32 * warps>>>(out, iters, 1.f);
  cudaEventRecord(e1); cudaEventSynchronize(e1); cudaEventElapsedTime(&ms, e0, e1);
  const double fma = 2.0 * sms * warps * 32 * iters * 64 / ms / 1e9;
  printf("{\"peaks\": {\"mma_sync_tf32_tflops\": %.1f, \"fp32_fma_tflops\": %.1f}}\n", mma, fma);
  return cudaGetLastError() != cudaSuccess;
}
"""


def patched(src: str, patches) -> str:
    for old, new in patches:
        if old not in src:
            raise SystemExit(f"ssd_variants: {old!r} is not in ssd_scan.cu")
        src = src.replace(old, new)
    return src


def main() -> int:
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT, os.path.join(ROOT,
                                                                   "scripts")]
    import torch
    if not torch.cuda.is_available():
        print("ssd_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    import compare_attention as cmp
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ssd_scan as kmod
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(build.CSRC, "ssd_scan.cu")) as f:
        src = f.read()
    jobs = {}
    for name, patches in VARIANTS.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(patched(src, patches))
        jobs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o",
             os.path.join(OUT, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    peaks_cu = os.path.join(OUT, "peaks.cu")
    with open(peaks_cu, "w") as f:
        f.write(PEAKS)
    peaks_bin = os.path.join(OUT, "peaks")
    jobs["peaks"] = subprocess.Popen(
        [build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
         "-o", peaks_bin, peaks_cu], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"ssd_variants: nvcc failed for {name}:\n{log}")
    cfg = get_config("mamba2-130m")
    Q = cfg.ssm_chunk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    shapes = {"8x512": smoke.SSD_SMOKE[1:], "1x1024": ([1000], 1024)}
    inputs = {k: smoke.ssd_inputs(cfg, lens, T, gen)
              for k, (lens, T) in shapes.items()}
    plain = {k: ref.ssd_scan_ref(*a, Q) for k, a in inputs.items()}
    for name in VARIANTS:
        fn = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so")).ssd_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        kmod._fn = fn
        out = {}
        for label, args in inputs.items():
            y, _ = kmod.ssd_scan(*args, Q)
            y_ref = plain[label][0]
            rel = ((y - y_ref).abs().max() / y_ref.abs().max()).item()

            def call():
                kmod.ssd_scan(*args, Q)

            out[label] = dict(ms=smoke.time_ms(call, flush,
                                               label=f"{name} {label}"),
                              max_rel_err=rel,
                              profile=cmp.profile_passes(smoke, call, flush))
        print(json.dumps({name: out}), flush=True)
    print(subprocess.run([peaks_bin], check=True, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(smoke.card_reading(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
