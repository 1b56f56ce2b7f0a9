"""The near-tie rule for comparing two greedy token streams, shared by
``chip_smoke.py`` and the tests that hold the card's engines against
the CPU's, or the port's against the JAX package's.

Float32 sums taken in another order can flip a greedy choice where the
two largest logits nearly tie; after that token the streams are
conditioned on different contexts and are no longer comparable.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

#: top-2 logit gap below which two greedy streams may part
NEAR_TIE = 1e-4


def prefill_logits(model, params,
                   extra: Optional[Dict[str, np.ndarray]] = None
                   ) -> Callable[[np.ndarray], np.ndarray]:
    """The reference ``stream_tie`` takes for the port's ``model`` with
    ``params`` (e.g. the CPU copy): the last-token logits of a prefill of
    one context, as a float32 numpy vector.  ``extra`` holds one
    request's frontend inputs (a leading axis of 1: a VLM's
    ``prefix_embeds``, whose tokens the cache also holds, or an
    encoder-decoder's ``src_embeds`` and ``src_valid``)."""
    dev = params.embed.table.device
    extra = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in (extra or {}).items()}
    n_prefix = (extra["prefix_embeds"].shape[1] if "prefix_embeds" in extra
                else 0)

    def logits_of(ctx: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            logits, _ = model.prefill(
                params, {"tokens": torch.from_numpy(ctx[None]).to(dev),
                         "lengths": torch.tensor([len(ctx)],
                                                 dtype=torch.int32,
                                                 device=dev), **extra},
                len(ctx) + n_prefix + 1)
        return logits[0].float().cpu().numpy()

    return logits_of


def stream_tie(ref_logits: Callable[[np.ndarray], np.ndarray],
               prompt: Sequence[int], want: Sequence[int],
               got: Sequence[int],
               rel_tol: Optional[float] = None) -> Optional[float]:
    """None when ``got`` equals the reference stream ``want``.  Where they
    first part, the gap of the top-2 of ``ref_logits(prompt + want[:j])``
    (an int32 context in, the reference's last-token logits out): it is
    returned when below ``NEAR_TIE`` (or, given ``rel_tol``, below
    ``rel_tol`` times the largest |logit|; the rest of the streams is not
    compared), else ``AssertionError`` is raised.  Streams of different
    lengths that never part raise too."""
    want, got = list(want), list(got)
    for j, (a, b) in enumerate(zip(want, got)):
        if a == b:
            continue
        ctx = np.concatenate([np.asarray(prompt, np.int32),
                              np.asarray(want[:j], np.int32)])
        logits = np.asarray(ref_logits(ctx), np.float32)
        top2 = np.sort(logits)[-2:]
        gap = float(top2[1] - top2[0])
        tie = NEAR_TIE if rel_tol is None else rel_tol * np.abs(logits).max()
        if not gap < tie:
            raise AssertionError(f"token {j} of a {len(prompt)}-token "
                                 f"prompt: {b} != reference {a}, top-2 gap "
                                 f"{gap:.3e} is no near-tie")
        return gap
    if len(want) != len(got):
        raise AssertionError(f"stream lengths differ: {len(got)} != "
                             f"reference {len(want)}")
    return None
