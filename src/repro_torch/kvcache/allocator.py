"""Page-table KV allocator: fixed-size token blocks with a free list.

Host-side bookkeeping only — the device arrays live in
``kvcache.paged.PagedKVCache``.  Page 0 is reserved as the *null page*:
block-table rows of inactive slots and the padding entries of short rows
all point at it, so masked writes land somewhere harmless and gathers
through a padded table never index out of bounds.  The null page is never
handed out and its slots are permanently masked (``slot_pos = -1``).

``reserve(owner, n_tokens)`` is keyed to the scheduler's ``(L_i + S)``
bound (paper Eq. 5): the engine reserves exactly the slice envelope at
join/slice-start and releases it at eviction/slice-end, so the tight
per-slice memory analysis survives all the way down to the allocator.

Pages are *refcounted*: ``share(owner, pages)`` maps a new owner onto
pages another owner already holds (cross-request prefix sharing), and a
page only returns to the free list when its last reference drops.  The
copy-on-write obligation is that a page with refcount > 1 is never
mutated — writers call ``fork(owner, index)`` first, which swaps in a
private copy when (and only when) the page is shared.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# single source of the block-rounding rule, shared with the estimator
from repro_torch.core.memory import blocks_for


class PageAllocator:
    """Fixed-size token-block allocator with per-owner block lists.

    ``n_pages`` counts usable pages (the null page is allocated on top of
    it), so capacity comparisons against a dense layout stay apples to
    apples: ``n_pages * page_tokens`` usable cache slots.
    """

    NULL_PAGE = 0

    def __init__(self, n_pages: int, page_tokens: int):
        if n_pages <= 0:
            raise ValueError(f"need at least one usable page, got {n_pages}")
        if page_tokens <= 0:
            raise ValueError(f"page_tokens must be positive, got {page_tokens}")
        self.page_tokens = page_tokens
        self.n_pages = n_pages
        # page ids 1..n_pages are usable; 0 is the null page
        self._free: List[int] = list(range(n_pages, 0, -1))  # pop() -> low ids
        self._owned: Dict[int, List[int]] = {}
        # live reference count per page; absent == page is on the free list
        self._refs: Dict[int, int] = {}

    # ------------------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def shared_blocks(self) -> int:
        """Number of distinct pages currently held by more than one owner."""
        return sum(1 for r in self._refs.values() if r > 1)

    def ref_count(self, page: int) -> int:
        """Live references on ``page`` (0 == on the free list)."""
        return self._refs.get(page, 0)

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return blocks_for(n_tokens, self.page_tokens)

    def can_reserve(self, n_tokens: int) -> bool:
        return self.blocks_for_tokens(n_tokens) <= self.free_blocks

    # ------------------------------------------------------------------
    def reserve(self, owner: int, n_tokens: int) -> List[int]:
        """Reserve pages for ``n_tokens`` cache slots; returns the page ids.

        All-or-nothing: raises ``MemoryError`` when the free list is short
        (callers gate with ``can_reserve`` — a waiting request simply stays
        queued, which is the whole point: parallelism is bounded by *real*
        free memory, not a conservative slot count).
        """
        if owner in self._owned:
            raise KeyError(f"owner {owner} already holds pages")
        need = self.blocks_for_tokens(n_tokens)
        if need > self.free_blocks:
            raise MemoryError(
                f"owner {owner}: need {need} blocks, {self.free_blocks} free")
        pages = [self._free.pop() for _ in range(need)]
        for p in pages:
            self._refs[p] = 1
        self._owned[owner] = pages
        return list(pages)

    def extend(self, owner: int, n_tokens: int) -> List[int]:
        """Grow ``owner``'s reservation to cover ``n_tokens`` cache slots;
        returns the newly added page ids (``[]`` when it already covers).

        The retention path's slice-start call (kv_retain="request"): a
        resumed request holds its trimmed prefix pages and only the slice
        growth ``+S`` is new.  All-or-nothing like ``reserve`` — on
        ``MemoryError`` the owner's existing pages are untouched.
        """
        pages = self._owned.get(owner)
        if pages is None:
            raise KeyError(f"owner {owner} holds no pages — use reserve()")
        need = self.blocks_for_tokens(n_tokens) - len(pages)
        if need <= 0:
            return []
        if need > self.free_blocks:
            raise MemoryError(
                f"owner {owner}: extend needs {need} blocks, "
                f"{self.free_blocks} free")
        new = [self._free.pop() for _ in range(need)]
        for p in new:
            self._refs[p] = 1
        pages.extend(new)
        return list(new)

    def shrink(self, owner: int, n_tokens: int) -> int:
        """Return ``owner``'s trailing pages beyond ``n_tokens`` coverage to
        the free list; returns the count freed.

        The retention path's slice-end trim: the slice envelope reserved
        ``(resident + S)`` but only ``steps <= S`` tokens were written, so
        the slack pages go back to the pool while the prefix stays
        resident.  Pages are freed from the tail (highest logical blocks),
        so the retained prefix mapping is untouched.
        """
        pages = self._owned.get(owner)
        if pages is None:
            raise KeyError(f"owner {owner} holds no pages")
        keep = self.blocks_for_tokens(n_tokens)
        freed = 0
        while len(pages) > max(keep, 0):
            self._drop_ref(pages.pop())
            freed += 1
        return freed

    def release(self, owner: int, *, missing_ok: bool = False) -> int:
        """Return ``owner``'s pages to the free list; returns the count.

        Releasing an owner that holds nothing is a bug by default — the
        classic shape is cancel-then-slice-end calling ``release`` twice,
        which with a laxer allocator would silently double-free pages onto
        the free list and hand the same page to two owners.  It raises a
        descriptive ``KeyError``; pass ``missing_ok=True`` at call sites
        where release is legitimately idempotent (then it is an explicit
        no-op returning 0).
        """
        pages = self._owned.pop(owner, None)
        if pages is None:
            if missing_ok:
                return 0
            raise KeyError(
                f"owner {owner} holds no pages — double release? "
                f"(live owners: {sorted(self._owned)})")
        for p in pages:
            self._drop_ref(p)
        return len(pages)

    # ------------------------------------------------------------------
    def share(self, owner: int, pages: Sequence[int]) -> List[int]:
        """Map a *new* owner onto ``pages`` already held by someone else.

        The cross-request prefix join: a request whose token prefix matches
        a resident's full pages takes a reference on those pages instead of
        re-prefilling them.  No allocation happens — the shared pages become
        the head of ``owner``'s block list (callers ``extend`` afterwards
        for the novel tail).  Every page must be live (refcount >= 1);
        sharing a free-list page would alias freshly handed-out memory.
        """
        if owner in self._owned:
            raise KeyError(f"owner {owner} already holds pages")
        for p in pages:
            if self._refs.get(p, 0) < 1:
                raise ValueError(f"page {p} is not live — cannot share")
            if p == self.NULL_PAGE:
                raise ValueError("cannot share the null page")
        for p in pages:
            self._refs[p] += 1
        self._owned[owner] = list(pages)
        return list(pages)

    def fork(self, owner: int, index: int) -> Tuple[int, int]:
        """Copy-on-write: make ``owner``'s ``index``-th page privately
        writable; returns ``(old_page, new_page)``.

        When the page is exclusively held (refcount == 1) this is a no-op
        and ``old == new``.  When it is shared, a fresh page is allocated
        (``MemoryError`` if the pool is dry), the shared page loses one
        reference, and the owner's block table entry is swapped — the
        caller must then copy the device-side page contents ``old -> new``
        before writing.  The shared page itself is never mutated.
        """
        pages = self._owned.get(owner)
        if pages is None:
            raise KeyError(f"owner {owner} holds no pages")
        page = pages[index]
        if self._refs[page] == 1:
            return page, page
        if not self._free:
            raise MemoryError(f"owner {owner}: fork needs 1 block, 0 free")
        new = self._free.pop()
        self._refs[new] = 1
        self._refs[page] -= 1
        pages[index] = new
        return page, new

    def _drop_ref(self, page: int) -> bool:
        """Drop one reference; free the page when the last one goes."""
        r = self._refs[page] - 1
        if r == 0:
            del self._refs[page]
            self._free.append(page)
            return True
        self._refs[page] = r
        return False

    def pages_of(self, owner: int) -> List[int]:
        return list(self._owned[owner])

    def owners(self) -> List[int]:
        return list(self._owned)
