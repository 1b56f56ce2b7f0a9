"""Training launcher (counterpart of ``repro.launch.train``: every arch is
trainable end to end).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --reduced --steps 200 --batch 8 --seq 64 [--device cpu]

The flags are the reference's, ``--reduced`` included: it is declared
``store_true`` with a default of True, so it cannot be turned off and the
launcher trains reduced configs only (ROADMAP C7).  ``--device`` places
the run as ``repro_torch.launch.serve`` does (default: the CUDA card).
The loop is ``train``, which takes any config, so a full-width config
trains through it from code.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint.store import save_checkpoint
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import SyntheticCorpus, TokenBatcher
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig, init_adamw

#: source frames of the encoder-decoder's seeded ``src_embeds``
SRC_FRAMES = 16


def train(cfg: ModelConfig, steps: int = 200, batch: int = 8, seq: int = 64,
          lr: float = 1e-3, seed: int = 0, log_every: int = 20,
          ckpt: Optional[str] = None,
          device: DeviceLike = None) -> Dict[str, Any]:
    """Train ``cfg`` from random weights (seed ``seed``) for ``steps``
    steps of ``batch`` x ``seq`` tokens of ``SyntheticCorpus``, printing
    the reference launcher's lines; AdamW at ``lr`` with a warm-up of
    ``max(steps // 20, 5)`` steps and a cosine decay to ``steps``.
    Returns the losses, each step's wall time in ms (the loss read back
    each step, so the card's work is in it), the model and the optimiser
    state."""
    dev = resolve_device(device)
    model = get_model(cfg)
    params = model.init(seed, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[train] {cfg.name}: {n_params/1e6:.2f}M params, "
          f"B={batch} T={seq}")

    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                          total_steps=steps)
    opt = init_adamw(params)
    step_fn = make_train_step(model, opt_cfg)

    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seed=seed)
    data = TokenBatcher(corpus, batch, seq)
    rng = np.random.default_rng(seed)

    def frontend(shape):
        x = torch.from_numpy(rng.standard_normal(shape))
        return x.to(device=dev, dtype=cfg.dtype)

    losses: List[float] = []
    step_ms: List[float] = []
    t0 = time.time()
    for step, np_batch in zip(range(steps), data):
        t_step = time.perf_counter()
        b = {"tokens": torch.from_numpy(np_batch["tokens"]).to(dev)}
        if cfg.family == "encdec":
            b["src_embeds"] = frontend((batch, SRC_FRAMES, cfg.d_model))
        if cfg.family == "vlm":
            b["prefix_embeds"] = frontend((batch, cfg.n_prefix_tokens,
                                           cfg.d_model))
        params, opt, loss = step_fn(params, opt, b)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        if step % log_every == 0 or step == steps - 1:
            rate = (step + 1) * batch * seq / (time.time() - t0)
            print(f"step {step:5d}  loss {losses[-1]:.4f}  tok/s {rate:,.0f}")

    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    if ckpt:
        save_checkpoint(ckpt, params, opt, step=steps)
        print(f"[train] checkpoint -> {ckpt}")
    return dict(losses=losses, step_ms=step_ms, params=params, opt=opt,
                model=model, n_params=n_params)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of the run (default: the CUDA card; "
                         "'cpu' to train on the CPU)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, seed=args.seed, log_every=args.log_every,
                 ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
