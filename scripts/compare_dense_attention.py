#!/usr/bin/env python3
"""Time the port's dense attention kernels (flash_prefill, decode_attention)
of several source trees on one card, in turns, at the shapes the dense
slices run, each beside one SDPA call computing the same function.

    python3 scripts/compare_dense_attention.py ROOT [ROOT ...]

Each ROOT is a checkout (or an unpacked ``git archive``) of this
repository whose kernels are built from its own sources; each turn runs in
a fresh process that imports ``repro_torch`` from ``ROOT/src``.  Give the
roots in the order to run them (for two versions: old, new, new, old).
The shapes (``PREFILL_TIMED``, ``DECODE_TIMED``), inputs, timing
(``time_ms``) and bounds are this checkout's ``chip_smoke.py``'s.  Prints
one JSON line per turn, then the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_turn(root: str) -> dict:
    import torch
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dkmod
    from repro_torch.kernels import flash_prefill as pkmod
    assert pkmod.__file__.startswith(os.path.abspath(root))
    cfg = get_config("llama3.2-1b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {"root": root, "flash_prefill": {}, "decode_attention": {}}
    for label, lens, T in smoke.PREFILL_TIMED:
        q, k, v, pos = smoke.prefill_inputs(cfg, lens, T, gen)
        t, lib, b_ms, b_by, _ = smoke.time_prefill(pkmod, q, k, v, pos,
                                                   flush, label)
        out["flash_prefill"][label] = dict(ms=t, library_ms=lib,
                                           bound_ms=b_ms, bound_by=b_by)
    for label, rows, W in smoke.DECODE_TIMED:
        args = smoke.dense_decode_inputs(cfg, rows, W, gen)
        t, lib, b_ms, b_by, _ = smoke.time_dense_decode(dkmod, rows, args,
                                                        flush, label)
        out["decode_attention"][label] = dict(ms=t, library_ms=lib,
                                              bound_ms=b_ms, bound_by=b_by)
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--turn":
        print(json.dumps(one_turn(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in sys.argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--turn", os.path.abspath(root)],
                              capture_output=True, text=True)
        sys.stderr.write(proc.stdout + proc.stderr)
        if proc.returncode:
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
