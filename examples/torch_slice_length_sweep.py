"""Slice-length trade-off (paper §5.5, Figs. 18-21) on the PyTorch/CUDA
port's scheduler: sweep S and watch the throughput curve rise then fall
as reschedule overhead trades against batch size and request waiting;
the counterpart of examples/slice_length_sweep.py.

Also sweeps SCLS-PRED (``repro_torch.predict``) at each S: calibrated
length caps act as a *ceiling* on the slice -- a request predicted to
finish within S is served an exact shorter slice, one predicted to
outlive S falls back to plain SCLS slicing -- which flattens the right
side of the curve.

Simulation only (the paper-testbed latency model, virtual time): it runs
on the host and needs no card.

  PYTHONPATH=src python examples/torch_slice_length_sweep.py \\
      [--duration 300] [--slice-lens 16,32,64,128,256,512,1024]
"""
import argparse
import copy
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.cluster.trace import CODEFUSE, generate_trace  # noqa: E402
from repro_torch.core.memory import RuleBasedMemoryEstimator  # noqa: E402
from repro_torch.serving import (ServingConfig,  # noqa: E402
                                 default_sim_environment)

SLICE_LENS = (16, 32, 64, 128, 256, 512, 1024)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=300.0)
    ap.add_argument("--slice-lens", default=",".join(map(str, SLICE_LENS)))
    args = ap.parse_args(argv)
    slice_lens = [int(s) for s in args.slice_lens.split(",")]
    true_lat, est, _ = default_sim_environment("ds")
    trace = generate_trace(20.0, args.duration, CODEFUSE, seed=1)
    out: dict = {}
    for strat in ("scls", "scls-pred"):
        print(f"--- {strat} ---")
        print(f"{'S':>5s} {'thr':>7s} {'resp(s)':>8s} {'slices':>7s} "
              f"{'batch':>6s} {'pads':>7s} {'early%':>7s} {'CTstd':>6s}")
        for S in slice_lens:
            cfg = ServingConfig(strategy=strat, workers=8, slice_len=S,
                                fixed_batch_size=12, gamma=3.0,
                                noise_sigma=0.02, seed=2)
            server = cfg.build_sim(true_lat, est, RuleBasedMemoryEstimator())
            reqs = copy.deepcopy(trace)
            server.replay(reqs)
            m = server.drain(args.duration)
            done = [r for r in reqs if r.done]
            assert done, f"{strat} S={S}: no request completed"
            sched = np.mean([r.n_schedules for r in done])
            print(f"{S:5d} {m.throughput:7.2f} {m.mean_response:8.1f} "
                  f"{sched:7.2f} {m.avg_batch_size:6.1f} "
                  f"{m.avg_pad_tokens:7.1f} {100*m.early_return_ratio:7.2f} "
                  f"{m.ct_std:6.1f}")
            out[(strat, S)] = dict(throughput=m.throughput,
                                   slices=float(sched),
                                   n_completed=m.n_completed)
    return out


if __name__ == "__main__":
    main()
