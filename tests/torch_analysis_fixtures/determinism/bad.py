"""BAD fixture: a scheduler step that is not reproducible."""
import time

import numpy as np


def pick(queue, waiting):
    stamp = time.perf_counter()
    rng = np.random.default_rng()
    for rid in waiting:
        queue.append((stamp, rid, rng.random()))
    return sorted(queue, key=id)


waiting = {3, 1, 2}
