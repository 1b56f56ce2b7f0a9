"""Page-granular prefix index: longest-common-prefix lookup over resident KV.

The cross-request sharing map (multi-turn sessions and shared prompt
prefixes): a trie keyed by *full-page token content* — each edge is the
``page_tokens``-tuple of token ids filling one KV page — whose nodes record,
per resident owner, the physical page holding exactly that content.  A new
request walks the trie with its own prompt and receives the longest chain of
already-resident pages whose content matches its prefix; the engine then
``share()``s those pages and prefills only the novel tail.

Only *full* pages are indexed.  An owner writes KV solely at its frontier
(the next empty slot), so a full page behind the frontier is immutable for
the rest of the owner's lifetime — sharing it can never observe a write,
which is what makes page-granular sharing safe without fork-on-write on the
decode hot path (``PageAllocator.fork`` covers the general COW contract).

Content equality is the correctness argument: KV at a slot depends only on
the token ids at and before it (plus position), so two rows with identical
token prefixes have bitwise-identical KV for those slots and may point their
block tables at the same physical pages.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("children", "owners")

    def __init__(self) -> None:
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.owners: Dict[int, int] = {}  # owner -> physical page id


class PrefixIndex:
    """Trie of full-page token content over resident owners' pages."""

    def __init__(self, page_tokens: int):
        if page_tokens <= 0:
            raise ValueError(f"page_tokens must be positive, got {page_tokens}")
        self.page_tokens = page_tokens
        self._root = _Node()
        # owner -> the node path it is registered on (depth order)
        self._paths: Dict[int, List[_Node]] = {}

    # ------------------------------------------------------------------
    def insert(self, owner: int, tokens: Sequence[int],
               pages: Sequence[int]) -> int:
        """(Re-)index ``owner``'s resident stream; returns #pages indexed.

        ``tokens`` is the owner's full resident token stream and ``pages``
        its physical block list; only the leading full pages (both token-
        and page-covered) enter the trie.  Re-inserting an owner replaces
        its previous entry.
        """
        if owner in self._paths:
            self.remove(owner)
        pg = self.page_tokens
        n_full = min(len(tokens) // pg, len(pages))
        node, path = self._root, []
        for i in range(n_full):
            key = tuple(int(t) for t in tokens[i * pg:(i + 1) * pg])
            node = node.children.setdefault(key, _Node())
            node.owners[owner] = int(pages[i])
            path.append(node)
        if path:
            self._paths[owner] = path
        return len(path)

    def remove(self, owner: int) -> None:
        """Drop ``owner``'s entry (no-op when absent); prunes empty nodes."""
        path = self._paths.pop(owner, None)
        if path is None:
            return
        for node in path:
            node.owners.pop(owner, None)
        # prune bottom-up: a node with no owners has no live subtree either
        # (every descendant registration also registers the ancestors)
        parents = [self._root] + path[:-1]
        for node, parent in zip(reversed(path), reversed(parents)):
            if node.owners:
                break
            for key, child in list(parent.children.items()):
                if child is node:
                    del parent.children[key]
                    break

    def lookup(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest resident full-page prefix of ``tokens``.

        Returns ``(pages, hit_tokens)`` — the physical pages covering the
        match (possibly contributed by different owners at different
        depths; content equality makes the mix coherent) and the number of
        tokens they cover.  ``([], 0)`` on a miss.
        """
        pg = self.page_tokens
        node, pages = self._root, []
        for i in range(len(tokens) // pg):
            key = tuple(int(t) for t in tokens[i * pg:(i + 1) * pg])
            child = node.children.get(key)
            if child is None or not child.owners:
                break
            # deterministic donor: the lowest live owner id at this depth
            pages.append(child.owners[min(child.owners)])
            node = child
        return pages, len(pages) * pg

    # ------------------------------------------------------------------
    def owners(self) -> List[int]:
        return list(self._paths)

    def __contains__(self, owner: int) -> bool:
        return owner in self._paths
