"""The port's copies of the page allocator and the prefix index
(``repro_torch.kvcache``) against the JAX package's originals: the same
seeded random churn of reserve / extend / shrink / release / share / fork
(and insert / remove / lookup) drives both, and after every operation
their results, errors and states must agree; the pool must conserve its
pages and return to its baseline."""
import numpy as np
import pytest

from repro.kvcache import PageAllocator as JaxAllocator
from repro.kvcache import PrefixIndex as JaxPrefix
from repro_torch.kvcache import PageAllocator, PrefixIndex


def _apply(alloc, op, args):
    """(result, error type) of one operation."""
    try:
        return getattr(alloc, op)(*args), None
    except (KeyError, MemoryError, ValueError, IndexError) as e:
        return None, type(e)


def _state(a):
    return (a.free_blocks, a.used_blocks, a.shared_blocks,
            {o: a.pages_of(o) for o in a.owners()})


@pytest.mark.parametrize("seed", range(4))
def test_allocator_churn_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n_pages, pg = 24, 4
    ours, theirs = PageAllocator(n_pages, pg), JaxAllocator(n_pages, pg)
    for _ in range(400):
        owner = int(rng.integers(0, 8))
        kind = rng.choice(["reserve", "extend", "shrink", "release",
                           "share", "fork"])
        if kind in ("reserve", "extend", "shrink"):
            args = (owner, int(rng.integers(0, 40)))
        elif kind == "release":
            args = (owner,)
        elif kind == "share":
            donors = [o for o in theirs.owners() if theirs.pages_of(o)]
            if not donors:
                continue
            donor = theirs.pages_of(donors[int(rng.integers(len(donors)))])
            args = (owner, donor[:int(rng.integers(1, len(donor) + 1))])
        else:
            args = (owner, int(rng.integers(0, 6)))
        assert _apply(ours, kind, args) == _apply(theirs, kind, args), \
            (kind, args)
        assert _state(ours) == _state(theirs)
        assert ours.used_blocks + ours.free_blocks == n_pages
    for o in ours.owners():
        ours.release(o)
    assert ours.free_blocks == n_pages and ours.shared_blocks == 0


@pytest.mark.parametrize("seed", range(2))
def test_prefix_index_churn_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pg = 4
    ours, theirs = PrefixIndex(pg), JaxPrefix(pg)
    base = rng.integers(0, 5, size=64)   # a small alphabet: many shared heads
    for step in range(200):
        owner = int(rng.integers(0, 6))
        stream = base[:int(rng.integers(0, 48))].copy()
        if len(stream) and rng.random() < 0.5:   # part from base somewhere
            cut = int(rng.integers(len(stream)))
            stream[cut:] = (stream[cut:] + 1) % 5
        kind = rng.choice(["insert", "remove", "lookup"])
        if kind == "insert":
            pages = [100 * owner + i for i in range(len(stream) // pg + 1)]
            ours.insert(owner, stream, pages)
            theirs.insert(owner, stream, pages)
        elif kind == "remove":
            ours.remove(owner)
            theirs.remove(owner)
        else:
            assert ours.lookup(stream) == theirs.lookup(stream), step
        assert sorted(ours.owners()) == sorted(theirs.owners())
