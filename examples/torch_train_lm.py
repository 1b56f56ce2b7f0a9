"""Train a reduced-config LM end to end on the PyTorch/CUDA port
(substrate check: data pipeline -> model -> AdamW -> checkpoint), for any
assigned architecture; the counterpart of examples/train_lm.py.

  PYTHONPATH=src python examples/torch_train_lm.py [--arch mamba2-130m] \\
      [--steps 150] [--device cpu]

It drives the launcher ``repro_torch.launch.train`` (on the card unless
``--device cpu``) and checks that the loss improved and that the
checkpoint it wrote (``build/train_lm_ckpt`` under the repository unless
``--ckpt``) loads back into the same weights.  The exit code is 1 when a
check fails.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint.store import load_checkpoint  # noqa: E402
from repro_torch.launch import train  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "train_lm_ckpt"))
    args = ap.parse_args(argv)
    # the launcher is the real entry point; this example just drives it
    launch = ["--arch", args.arch, "--steps", str(args.steps), "--batch",
              str(args.batch), "--seq", str(args.seq), "--ckpt", args.ckpt]
    if args.device:
        launch += ["--device", args.device]
    res = train.main(launch)
    losses = res["losses"]
    k = min(10, len(losses) // 2)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    params = res["model"].init(1, device=args.device)
    load_checkpoint(args.ckpt, params)
    same = all(torch.equal(a, b) for a, b in zip(
        params.state_dict().values(), res["params"].state_dict().values()))
    print(f"[train_lm] loss {first:.4f} -> {last:.4f}; checkpoint "
          f"{'loads back bit-equal' if same else 'DIFFERS'}")
    return dict(first_loss=first, last_loss=last, improved=last < first,
                checkpoint_equal=same, steps=len(losses))


if __name__ == "__main__":
    out = main()
    raise SystemExit(0 if out["improved"] and out["checkpoint_equal"] else 1)
