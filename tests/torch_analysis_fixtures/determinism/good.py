"""GOOD fixture: the same step on the event clock, seeded and sorted."""
import numpy as np


def pick(queue, waiting, now, seed):
    rng = np.random.default_rng(seed)
    for rid in sorted(waiting):
        queue.append((now, rid, rng.random()))
    return sorted(queue)


waiting = {3, 1, 2}
