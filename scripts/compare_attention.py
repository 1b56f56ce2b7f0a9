#!/usr/bin/env python3
"""Time the port's attention kernels, its SSD scan and its prefill writes
of several source trees on one card, in turns, each beside PyTorch
yardsticks.

    python3 scripts/compare_attention.py
        [--kernels dense|paged|ssd|write|all] [--steps PATH] [--pages 16,32]
        ROOT [ROOT ...]

Each ROOT is a checkout (or an unpacked ``git archive``) of this
repository whose kernels are built from its own sources; each turn runs in
a fresh process that imports ``repro_torch`` from ``ROOT/src``.  Give the
roots in the order to run them (for two versions: old, new, new, old).
Inputs, timing (``time_ms``) and bounds are this checkout's
``chip_smoke.py``'s.

``dense`` (flash_prefill at ``PREFILL_TIMED``, decode_attention at
``DECODE_TIMED``, each beside one SDPA call) and ``paged``
(paged_decode_attention beside one SDPA call over the window gathered
beforehand, fused_rope_decode_append beside torch RoPE + ``index_put_`` +
that SDPA call and beside the unfused chain on ROOT's
paged_decode_attention; both at ``PAGED_SMOKE`` over a pool of the
slices' size, and with ``--steps`` at the engines' recorded decode steps
``ENGINE_STEPS``, which ``chip_smoke.py --save-steps PATH`` writes, and
with ``--pages`` at each of those page sizes over ``PAGED_SMOKE`` and
``ILS_LIKE`` at llama3.2-1b's heads and over ``PAGED_SMOKE`` at
``PAGED_HEADS``; a tree that refuses a page size records the refusal), and
``ssd`` (ssd_scan at ``SSD_SMOKE``, and with ``--steps`` at the median
and largest Mamba-2 prefill stages that the same file holds, beside the
least time the card could take), and ``write`` (paged_prefill_write and
fused_rope_prefill_write at ``WRITE_SMOKE``, and with ``--steps`` at the
median and largest prefill stages of their own slices that the same file
holds, each beside its plain version, its yardsticks, its bound and an
empty launch, and each call's device time from a trace).

The three kernels on the split-slot loop (decode_attention and the two
paged ones) also run ``PROFILE_CALLS`` times per shape under
``torch.profiler`` (the L2 cache flushed and the card kept busy by a
device sleep before each call); the trace gives the mean device time of
the call's first kernel (pass 1, or the whole kernel of a one-kernel
tree), of its merge kernel where there is one (launched as a programmatic
dependent, it starts while pass 1 runs, so its time includes that wait),
and of the span from the first kernel's start to the last one's end, over
the calls the trace holds.  ssd_scan's calls run the same way; the
trace gives each of its kernels' mean device time (one kernel in a tree
before the four-pass design, the passes ``ssd_cb_kernel``,
``ssd_state_kernel``, ``ssd_pass_kernel`` and ``ssd_output_kernel``
after it) and the span of a call.  Prints one JSON line per turn, then
the card's name and power limit; exits 2 before any turn when a ROOT
holds no ``src/repro_torch``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE_CALLS = 20
#: kernel names of the profiled wrappers, in either tree
KERNEL_WORDS = ("split_kernel", "merge_kernel", "decode_attention",
                "fused_rope_decode_append")
#: the prefill writes' kernels, in either tree
WRITE_WORDS = ("paged_prefill_write_kernel", "fused_rope_prefill_write_kernel")
#: ssd_scan's kernels: the one-block kernel before the four passes, then
#: the passes in launch order (a call starts with the first or second)
SSD_WORDS = ("ssd_scan_kernel", "ssd_cb_kernel", "ssd_state_kernel",
             "ssd_pass_kernel", "ssd_output_kernel")


def traced_kernels(smoke, fn, flush, words) -> list:
    """The device kernels (and copies) whose names hold one of ``words``,
    in order of start, from a ``torch.profiler`` trace of
    ``PROFILE_CALLS`` calls of ``fn``, each after an L2 flush and 1 ms of
    device sleep."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cycles = int(smoke.sleep_cycles_per_ms())   # 1 ms before each call
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_CALLS):
            flush.zero_()
            torch.cuda._sleep(cycles)
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sorted((e for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy")
                   and any(w in e["name"] for w in words)),
                  key=lambda e: e["ts"])


def profile_passes(smoke, fn, flush) -> dict:
    """ssd_scan's kernels by name (``SSD_WORDS``): mean device µs of each,
    and of the span from a call's first kernel's start to its last one's
    end, over the calls the trace holds."""
    kernels = traced_kernels(smoke, fn, flush, SSD_WORDS)
    calls = []
    for e in kernels:
        word = next(w for w in SSD_WORDS if w in e["name"])
        if word in SSD_WORDS[:2] or not calls:
            calls.append({"start": e["ts"], "end": 0.0})
        calls[-1][word] = calls[-1].get(word, 0.0) + e["dur"]
        calls[-1]["end"] = max(calls[-1]["end"], e["ts"] + e["dur"])
    if not calls:
        raise SystemExit("profile: no ssd_scan kernel in the trace")
    n = len(calls)
    out = {f"{w}_us": sum(c.get(w, 0.0) for c in calls) / n
           for w in SSD_WORDS if any(w in c for c in calls)}
    return dict(out, span_us=sum(c["end"] - c["start"] for c in calls) / n,
                calls_traced=n)


def profile_calls(smoke, fn, flush) -> dict:
    """Mean device µs of pass 1, of the merge (0 without one) and of the
    span of one call of ``fn``, over the calls a ``torch.profiler`` trace
    holds (``calls_traced`` of ``PROFILE_CALLS``)."""
    kernels = traced_kernels(smoke, fn, flush, KERNEL_WORDS)
    calls, merge = [], []
    for e in kernels:
        if "merge_kernel" in e["name"] and calls:
            merge.append(e["dur"])
            calls[-1][1] = e["ts"] + e["dur"]
        else:
            calls.append([e["ts"], e["ts"] + e["dur"], e["dur"]])
    if not calls:
        raise SystemExit("profile: no kernel of the wrapper in the trace")
    n = len(calls)  # the trace may drop a few of the calls made
    return dict(pass1_us=sum(c[2] for c in calls) / n,
                merge_us=sum(merge) / max(len(merge), 1),
                span_us=sum(c[1] - c[0] for c in calls) / n,
                calls_traced=n)


def write_turn(smoke, cfg, gen, flush, steps_path) -> dict:
    """The prefill writes at ``WRITE_SMOKE`` and, with ``steps_path``, at
    their slices' recorded stages (``ENGINE_WRITES``): each held and timed
    by ``hold_write``, with the mean device µs of its kernel in a trace of
    ``PROFILE_CALLS`` calls."""
    import torch
    from repro_torch.kernels import fused_rope_prefill_write as fkmod
    from repro_torch.kernels import paged_prefill_write as kmod
    pg = 16
    n_pages = smoke.pool_pages(cfg, 48e9, pg)
    positions, bt = smoke.smoke_write_indices(n_pages, pg, gen)
    cases = [(name, smoke.WRITE_SMOKE[0], (n_pages + 1, pg), positions, bt)
             for name in smoke.WRITES]
    if steps_path:
        writes = torch.load(steps_path)["write_stages"]
        for name, run in smoke.ENGINE_WRITES:
            cases += [(name, f"{run} {label}", st["pool"][:2],
                       st["positions"].cuda(), st["bt"].cuda())
                      for label, st, _ in smoke.timed_writes(writes[run])]
    out = {name: {} for name in smoke.WRITES}
    out["empty_launch_ms"] = smoke.empty_launch_ms(flush)
    for name, label, (P, pg), pos, bt in cases:
        fused = name == "fused_rope_prefill_write"
        pools = smoke.paged_pools(cfg, P - 1, pg, gen)
        entry = smoke.hold_write((kmod, fkmod), cfg, pools, pos, bt, gen,
                                 flush, label, fused)
        k_new, v_new = (torch.randn((*pos.shape, cfg.n_kv_heads,
                                     cfg.head_dim), generator=gen,
                                    device="cuda").to(cfg.dtype)
                        for _ in range(2))
        if fused:
            def fn():
                fkmod.fused_rope_prefill_write(k_new, v_new, pos, bt, *pools,
                                               theta=cfg.rope_theta)
        else:
            def fn():
                kmod.paged_prefill_write(k_new, v_new, pos, bt, *pools)
        kernels = traced_kernels(smoke, fn, flush, WRITE_WORDS)
        if not kernels:
            raise SystemExit(f"profile: no {name} kernel in the trace")
        out[name][label] = dict(
            {k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "yardsticks_ms", "shape")
             if k in entry},
            device_us=sum(e["dur"] for e in kernels) / len(kernels),
            calls_traced=len(kernels))
        del pools, entry
        torch.cuda.empty_cache()
    return out


def dense_turn(smoke, cfg, gen, flush) -> dict:
    from repro_torch.kernels import decode_attention as dkmod
    from repro_torch.kernels import flash_prefill as pkmod
    out = {"flash_prefill": {}, "decode_attention": {}}
    for label, lens, T in smoke.PREFILL_TIMED:
        q, k, v, pos = smoke.prefill_inputs(cfg, lens, T, gen)
        t, lib, b_ms, b_by, _ = smoke.time_prefill(pkmod, q, k, v, pos,
                                                   flush, label)
        out["flash_prefill"][label] = dict(ms=t, library_ms=lib,
                                           bound_ms=b_ms, bound_by=b_by)
    for label, rows, W in smoke.DECODE_TIMED:
        args = smoke.dense_decode_inputs(cfg, rows, W, gen)
        t, lib, b_ms, b_by, _ = smoke.time_dense_decode(dkmod, args, flush,
                                                        label)
        out["decode_attention"][label] = dict(
            ms=t, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
            profile=profile_calls(smoke, lambda: dkmod.decode_attention(
                *args), flush))
    return out


#: a paged ILS step's rows, drawn once (numpy seed 0): 17 rows of 16 to
#: 1015 tokens beside 47 rows without a page, over 1280 slots a row (the
#: paged ILS engine's typical step holds 17 own rows of 64, 8,699 live
#: slots, the longest 1015)
ILS_LIKE = ("ils-like 64x1280",
            tuple((int(n), False) for n in np.random.default_rng(0).integers(
                16, 1016, 17)) + ((0, True),) * 47, 1280)
#: (arch, paged_decode_attention, fused_rope_decode_append) of the heads
#: at which ``--pages`` times both kernels: each config's own slice's
#: heads, over pools of chip_smoke's ``CONFIG_M_AVAILABLE``
PAGED_HEADS = (("codeqwen1.5-7b", True, False), ("minitron-4b", False, True),
               ("gemma-2b", True, True))


def paged_turn(smoke, cfg, gen, flush, steps_path, pages=()) -> dict:
    import torch
    pg = 16
    n_pages = smoke.pool_pages(cfg, 48e9, pg)
    label, rows, nb = smoke.PAGED_SMOKE
    pools = smoke.paged_pools(cfg, n_pages, pg, gen)
    cases = [("paged_decode_attention", label, pools,
              smoke.paged_decode_inputs(cfg, n_pages, pg, rows, nb, gen)),
             ("fused_rope_decode_append", label, pools,
              smoke.paged_decode_inputs(cfg, n_pages, pg, rows, nb, gen,
                                        fused=True))]
    if steps_path:
        steps = torch.load(steps_path)
        for name, run in smoke.ENGINE_STEPS:
            fused = name == "fused_rope_decode_append"
            shape, step_pools, args = smoke.step_inputs(cfg, steps[run], gen,
                                                        fused)
            cases.append((name, f"{run} {shape}", step_pools, args))
    out = {"paged_decode_attention": {}, "fused_rope_decode_append": {}}
    run_cases(smoke, cfg, cases, flush, out)
    del cases, pools
    for p in pages:
        paged_pages_turn(smoke, cfg, gen, flush, p, out)
    return out


def paged_pages_turn(smoke, cfg, gen, flush, pg: int, out: dict) -> None:
    """Both paged decode kernels at pages of ``pg`` slots: at llama3.2-1b's
    heads over ``PAGED_SMOKE`` and ``ILS_LIKE``, and at ``PAGED_HEADS``
    over ``PAGED_SMOKE``, labelled "pg <pg> ...".  A tree whose wrapper
    refuses the page size records the refusal."""
    from repro_torch.configs import get_config
    label, rows, nb = smoke.PAGED_SMOKE
    ils_label, ils_rows, ils_slots = ILS_LIKE
    heads = [(cfg, 48e9, True, True, [(label, rows, nb),
                                      (ils_label, ils_rows,
                                       ils_slots // pg)])]
    heads += [(get_config(arch), smoke.CONFIG_M_AVAILABLE, b1, b4,
               [(f"{arch} {label}", rows, nb)])
              for arch, b1, b4 in PAGED_HEADS]
    for hcfg, budget, b1, b4, shapes in heads:
        n_pages = smoke.pool_pages(hcfg, budget, pg)
        pools = smoke.paged_pools(hcfg, n_pages, pg, gen)
        for tag, srows, snb in shapes:
            cases = []
            if b1:
                cases.append(("paged_decode_attention", f"pg {pg} {tag}",
                              pools, smoke.paged_decode_inputs(
                                  hcfg, n_pages, pg, srows, snb, gen)))
            if b4:
                cases.append(("fused_rope_decode_append", f"pg {pg} {tag}",
                              pools, smoke.paged_decode_inputs(
                                  hcfg, n_pages, pg, srows, snb, gen,
                                  fused=True)))
            run_cases(smoke, hcfg, cases, flush, out)
        del pools, cases
        smoke.release_cuda()


def run_cases(smoke, cfg, cases, flush, out: dict) -> None:
    from repro_torch.kernels import fused_rope_decode_append as fkmod
    from repro_torch.kernels import paged_decode_attention as kmod
    for name, label, (k_pages, v_pages), args in cases:
        try:
            if name == "paged_decode_attention":
                t, lib, b_ms, b_by, _ = smoke.time_paged_decode(
                    kmod, k_pages, v_pages, args, flush, label)
                entry = dict(ms=t, library_ms=lib)
                q, bt, slot_pos, q_pos = args

                def fn():
                    kmod.paged_decode_attention(q, k_pages, v_pages, bt,
                                                slot_pos, q_pos)
            else:
                t, t_a, t_b, b_ms, b_by, _ = smoke.time_fused_decode(
                    fkmod, kmod, k_pages, v_pages, args, cfg.rope_theta,
                    flush, label)
                entry = dict(ms=t, yardstick_a_ms=t_a, yardstick_b_ms=t_b)

                def fn():
                    fkmod.fused_rope_decode_append(*args, k_pages, v_pages,
                                                   theta=cfg.rope_theta)
        except ValueError as e:  # a page size the tree does not take
            out[name][label] = dict(refused=str(e))
            continue
        out[name][label] = dict(entry, bound_ms=b_ms, bound_by=b_by,
                                profile=profile_calls(smoke, fn, flush))


def ssd_turn(smoke, gen, flush, steps_path) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as kmod
    cfg = get_config("mamba2-130m")
    Q = cfg.ssm_chunk
    cases = [smoke.SSD_SMOKE]
    if steps_path:
        stages = torch.load(steps_path)["ssd_stages"]
        cases += [(label, st["lengths"], st["T"])
                  for label, st, _ in smoke.timed_stages(stages)]
    out = {}
    for label, lengths, T in cases:
        args = smoke.ssd_inputs(cfg, lengths, T, gen)

        def fn():
            kmod.ssd_scan(*args, Q)

        t = smoke.time_ms(fn, flush, label=f"ssd_scan {label}")
        b_ms, b_by, _, _ = smoke.ssd_bound(args[0], args[3], Q)
        out[label] = dict(ms=t, bound_ms=b_ms, bound_by=b_by,
                          profile=profile_passes(smoke, fn, flush))
    return {"ssd_scan": out}


def one_turn(root: str, kernels: str, steps_path, pages=()) -> dict:
    import torch
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    assert build.__file__.startswith(os.path.abspath(root))
    cfg = get_config("llama3.2-1b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {"root": root}
    if kernels in ("dense", "all"):
        out.update(dense_turn(smoke, cfg, gen, flush))
    if kernels in ("paged", "all"):
        out.update(paged_turn(smoke, cfg, gen, flush, steps_path, pages))
    if kernels in ("ssd", "all"):
        out.update(ssd_turn(smoke, gen, flush, steps_path))
    if kernels in ("write", "all"):
        out.update(write_turn(smoke, cfg, gen, flush, steps_path))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", choices=("dense", "paged", "ssd", "write", "all"),
                    default="all")
    ap.add_argument("--steps", default=None,
                    help="decode steps, Mamba-2 and paged prefill stages "
                         "from chip_smoke.py --save-steps")
    ap.add_argument("--pages", default="",
                    help="page sizes (comma-separated) at which the paged "
                         "turn also times both paged decode kernels at "
                         "PAGED_SMOKE, ILS_LIKE and PAGED_HEADS")
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("roots", nargs="+")
    a = ap.parse_args()
    steps = os.path.abspath(a.steps) if a.steps else None
    pages = tuple(int(p) for p in a.pages.split(",") if p)
    if a.turn:
        print(json.dumps(one_turn(a.roots[0], a.kernels, steps, pages)),
              flush=True)
        return 0
    missing = [r for r in a.roots if not os.path.isfile(
        os.path.join(r, "src", "repro_torch", "kernels", "build.py"))]
    if missing:
        print(f"compare_attention: no src/repro_torch under {missing}",
              file=sys.stderr)
        return 2
    for root in a.roots:
        cmd = [sys.executable, os.path.abspath(__file__), "--turn",
               "--kernels", a.kernels, os.path.abspath(root)]
        if steps:
            cmd[3:3] = ["--steps", steps]
        if pages:
            cmd[3:3] = ["--pages", a.pages]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        sys.stderr.write(proc.stdout + proc.stderr)
        if proc.returncode:
            print(f"compare_attention: the turn of {root} exited "
                  f"{proc.returncode}", file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
