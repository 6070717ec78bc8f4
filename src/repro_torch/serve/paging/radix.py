"""Prefix-sharing radix cache over the paged KV pool (vLLM/SGLang-style;
port of ``repro/serve/paging/radix.py``, pure Python, copied).

Token prefixes are interned at PAGE granularity: each node's key is a run of
whole pages (``len(key) == len(pages) * page``) and its ``pages`` list holds
the refcounted physical ids whose KV rows hold exactly those tokens.  The
tree answers two questions:

  * ``match(tokens)`` — the longest cached prefix of a new prompt: the run
    of fully-matched pages (mappable into a block table with zero copies)
    plus, when the match ends mid-page, the physical page holding the
    partially-matching rows (the copy-on-write source).
  * ``insert(tokens, pages)`` — donate a retired prompt's pages.  First
    writer wins: extents already cached are NOT replaced (the donor's
    duplicate pages stay slot-owned and free at retire), only genuinely new
    suffix pages are attached and retained on behalf of the tree.

Structure is maintained by splitting nodes at page boundaries when an insert
diverges mid-node, so sibling keys always differ in their first page and
child lookup is a dict hit on that page's token tuple.

Eviction is LRU **tail truncation** over unpinned leaf pages: under pool
pressure the least-recently-matched leaf gives up trailing pages one at a
time (a node with a truncated tail is still a valid cache entry for its
remaining prefix), and empty nodes unlink from their parents.  Pinned pages
(some in-flight request depends on them) are never popped, and because a
consumer pins a path *prefix*, pinned pages always form a prefix of any
node's page run — the unpinned suffix stays reachable by truncation.  The
allocator's ``evict_hook`` calls into :meth:`RadixCache.evict` so a dry free
heap reclaims cache pages on demand and lazy allocation stays infallible.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.paging.allocator import PageAllocator


class RadixNode:
    """One page-granular tree node: token key, donated pages, children."""
    __slots__ = ("key", "pages", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], pages: List[int],
                 parent: Optional["RadixNode"]):
        self.key = key
        self.pages = pages
        self.children: Dict[Tuple[int, ...], RadixNode] = {}
        self.parent = parent
        self.last_used = 0


class PrefixMatch:
    """Result of a longest-prefix lookup."""

    __slots__ = ("pages", "tokens", "partial")

    def __init__(self, pages: List[int], tokens: int, partial: Optional[int]):
        self.pages = pages  # fully-matched pages, in prefix order
        self.tokens = tokens  # matched token count (may end mid-page)
        self.partial = partial  # page holding the trailing partial match


class RadixCache:
    """Page-granularity radix tree over retired prompts' KV pages.

    First writer wins; lookups share pages by refcount; eviction
    truncates LRU leaf tails under pool pressure (module docstring).
    """
    def __init__(self, page: int, alloc: PageAllocator):
        assert page >= 1
        self.page = int(page)
        self.alloc = alloc
        self.root = RadixNode((), [], None)
        self.cached_pages = 0
        self.nodes = 0
        self.splits_total = 0
        self.evicted_pages_total = 0
        self._tick = 0

    # -- lookup ----------------------------------------------------------------

    def _match_tail(self, node: RadixNode, tokens: Sequence[int], i: int,
                    j: int) -> int:
        """Token-level match length inside page ``j`` of ``node`` from
        absolute token offset ``i`` (strictly less than ``page``)."""
        base = j * self.page
        limit = min(self.page, len(node.key) - base, len(tokens) - i)
        n = 0
        while n < limit and node.key[base + n] == tokens[i + n]:
            n += 1
        return n

    def match(self, tokens: Sequence[int]) -> PrefixMatch:
        """Longest cached prefix of ``tokens``; touches every node on the
        matched path for LRU."""
        tokens = [int(t) for t in tokens]
        self._tick += 1
        cur = self.root
        i = 0
        pages: List[int] = []
        partial: Optional[int] = None
        while True:
            child = None
            if len(tokens) - i >= self.page:
                child = cur.children.get(tuple(tokens[i:i + self.page]))
            if child is None:
                # no full-page child: the best we can do is a partial match
                # inside some child's first page
                best, best_n = None, 0
                for c in cur.children.values():
                    n = self._match_tail(c, tokens, i, 0)
                    if n > best_n:
                        best, best_n = c, n
                if best is not None:
                    best.last_used = self._tick
                    partial = best.pages[0]
                    i += best_n
                break
            child.last_used = self._tick
            done = False
            j = 0
            while j < len(child.pages):
                lo = j * self.page
                if (len(tokens) - i >= self.page
                        and tuple(tokens[i:i + self.page]) == child.key[lo:lo + self.page]):
                    pages.append(child.pages[j])
                    i += self.page
                    j += 1
                    continue
                n = self._match_tail(child, tokens, i, j)
                if n > 0:
                    partial = child.pages[j]
                    i += n
                done = True
                break
            if done:
                break
            cur = child
        return PrefixMatch(pages=pages, tokens=i, partial=partial)

    # -- insertion ---------------------------------------------------------------

    def _split(self, node: RadixNode, j: int):
        """Split ``node`` at page boundary ``j`` (0 < j < len(pages)): the
        node keeps its first ``j`` pages, a new child inherits the rest along
        with the node's children.  Physical ids and refcounts are untouched,
        so in-flight consumers of either half are unaffected."""
        page = self.page
        tail = RadixNode(node.key[j * page:], node.pages[j:], node)
        tail.children = node.children
        for c in tail.children.values():
            c.parent = tail
        tail.last_used = node.last_used
        node.children = {tail.key[:page]: tail}
        node.key = node.key[:j * page]
        node.pages = node.pages[:j]
        self.nodes += 1
        self.splits_total += 1

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> List[int]:
        """Intern ``pages`` (whole pages of ``tokens``) into the tree.  Only
        pages beyond the already-cached extent are attached; those are
        retained on behalf of the tree and returned.  First writer wins —
        a duplicate donation attaches nothing."""
        page = self.page
        tokens = [int(t) for t in tokens]
        n = len(pages)
        assert len(tokens) >= n * page, "insert needs whole pages of tokens"
        if n == 0:
            return []
        self._tick += 1
        cur = self.root
        i = 0  # page index into our donation
        while i < n:
            key_page = tuple(tokens[i * page:(i + 1) * page])
            child = cur.children.get(key_page)
            if child is None:
                node = RadixNode(tuple(tokens[i * page:n * page]),
                                 list(pages[i:]), cur)
                node.last_used = self._tick
                cur.children[key_page] = node
                self.nodes += 1
                new = list(pages[i:])
                for phys in new:
                    self.alloc.retain(phys)
                self.cached_pages += len(new)
                return new
            child.last_used = self._tick
            j = 0
            while (j < len(child.pages) and i + j < n
                   and tuple(tokens[(i + j) * page:(i + j + 1) * page])
                   == child.key[j * page:(j + 1) * page]):
                j += 1
            if j == len(child.pages):
                cur = child
                i += j
                continue
            if i + j == n:
                return []  # our donation is a prefix of cached content
            self._split(child, j)
            cur = child
            i += j
        return []

    # -- eviction ----------------------------------------------------------------

    def _leaves(self) -> List[RadixNode]:
        out, stack = [], [self.root]
        while stack:
            nd = stack.pop()
            if nd is not self.root and not nd.children:
                out.append(nd)
            stack.extend(nd.children.values())
        return out

    def _unlink(self, node: RadixNode):
        parent = node.parent
        for k, v in list(parent.children.items()):
            if v is node:
                del parent.children[k]
                break
        self.nodes -= 1

    def evict(self, need: int) -> int:
        """Free at least ``need`` pages by LRU tail truncation of unpinned
        leaf pages; returns how many actually went back to the free list
        (pages still mapped by a live slot drop out of the tree without
        freeing).  Stops early when every remaining leaf tail is pinned."""
        freed = 0
        while freed < need:
            candidates = [nd for nd in self._leaves()
                          if nd.pages and self.alloc.pin_count(nd.pages[-1]) == 0]
            if not candidates:
                break
            victim = min(candidates, key=lambda nd: nd.last_used)
            while (victim.pages and freed < need
                   and self.alloc.pin_count(victim.pages[-1]) == 0):
                phys = victim.pages.pop()
                victim.key = victim.key[:len(victim.pages) * self.page]
                self.cached_pages -= 1
                self.evicted_pages_total += 1
                if self.alloc.release_page(phys):
                    freed += 1
            if not victim.pages:
                self._unlink(victim)
        return freed

    # -- scrape surface ----------------------------------------------------------

    def metrics(self, prefix: str = "radix_") -> Dict[str, float]:
        """Flat gauge dict of cache size / hit / eviction counters."""
        return {
            f"{prefix}cached_pages": float(self.cached_pages),
            f"{prefix}nodes": float(self.nodes),
            f"{prefix}splits_total": float(self.splits_total),
            f"{prefix}evicted_pages_total": float(self.evicted_pages_total),
        }
