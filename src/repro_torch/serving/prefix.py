"""Shared-prefix radix cache of the port: tier-scoped prompt-prefix reuse
over paged blocks.

A copy of ``repro/serving/prefix.py`` (pure Python; the port cannot import
it, because the JAX package's ``repro.core`` imports JAX).  Identical
tokens at identical positions under the same ``(tier, version)`` weight
view produce identical KV blocks, so this module retains those blocks
after their request finishes and hands them to later requests:

* :class:`PrefixCache` keeps one radix tree **per (tier, version)
  scope**.  Scoping is the licensing boundary: a cached block encodes
  activations of a *masked weight view*, so a ``free``-tier prefix must
  never seed a ``pro``-tier request even when the tokens match.  Each
  tree node covers one physical block (up to ``block_size`` tokens; the
  last node of a chain may be *partial*).  Keys are the TRUE unpadded
  prompt tokens the chunked prefill donates, so chains match across
  prompt-*length* boundaries.  A partial tail node matches only when it
  covers the remaining tokens *exactly* (:meth:`_walk`), so partial
  fills terminate a chain without node splitting.
* Retention holds one allocator **reference** per tree-referenced
  block.  A block whose refcount is exactly 1 is held by the tree alone
  and is *reclaimable*.  The evictable set — reclaimable blocks whose
  node is a **leaf** — is maintained *incrementally* as an ordered dict
  (``note_release`` appends, ``match`` adoption removes, ``insert``
  refreshes/de-leafs, eviction promotes drained parents), so
  :meth:`evict` pops from the front in O(1) per block.  Order is LRU in
  the access sense.  A request's table holds the whole chain of any
  block it holds, so a refcount-1 node can never have a request-pinned
  descendant — its entire subtree drains leaf-first.  Set
  ``debug = True`` to re-derive the set from a full walk at every
  eviction and assert the incremental bookkeeping never drifted.
* :meth:`match` returns the longest cached chain for a prompt and takes
  a reference on every returned block for the caller; :meth:`insert`
  donates a freshly prefilled chain (the tree takes its own references)
  so the *first* request with a prompt populates the cache for the rest.

Writes never target a shared block: the gateway routes prefill
write-back of adopted blocks to the null block, and decode
copy-on-writes a shared tail block before its first write into it
(``PagedCachePool.copy_block``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from repro_torch.serving.paging import BlockAllocator


class _Node:
    """One cached block: ``tokens`` (its chunk, ``fill`` of them) under a
    parent chunk chain.  ``children`` is keyed by the child's full token
    tuple, so full-block lookup is one dict probe."""

    __slots__ = ("tokens", "block", "parent", "children", "last_used")

    def __init__(self, tokens: Tuple[int, ...], block: int,
                 parent: "_Node"):
        self.tokens = tokens
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0

    @property
    def fill(self) -> int:
        return len(self.tokens)


class _Root(_Node):
    def __init__(self):
        super().__init__((), -1, None)  # type: ignore[arg-type]


class PrefixCache:
    """Radix trees of retained prompt-block chains, one per scope.

    The allocator is shared with the gateway's :class:`PagedCachePool`;
    the cache only ever moves *references*, never block contents.
    """

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.allocator = allocator
        self.block_size = int(block_size)
        self._scopes: Dict[Hashable, _Root] = {}
        self._by_block: Dict[int, _Node] = {}   # block id -> retaining node
        # count of tree blocks whose ONLY reference is the tree's — the
        # reclaimable set.  Kept O(1)-exact across every transition: the
        # tree sees its own incref/decref sites, and the gateway reports
        # request releases via note_release().  Admission reads this
        # every scheduling step, so it must not walk the tree.
        self._retained = 0
        # the persistent eviction structure: reclaimable LEAF blocks in
        # LRU order (front = evict next).  note_release appends (the
        # releasing request was the last user), match-adoption removes,
        # insert refreshes a re-donated leaf / removes a de-leafed
        # parent, and evict promotes a drained chain's parent to the
        # front so chains keep draining oldest-first.  evict(1) is O(1).
        self._evictable: "OrderedDict[int, _Node]" = OrderedDict()
        self.debug = False               # recount-assert at every evict()
        # bumped whenever tree CONTENT changes (insert/evict/drop/forget)
        # — i.e. whenever a previous peek()/match() result may be stale
        self.epoch = 0
        self._clock = 0                  # LRU tick, bumped on every touch
        self.hits = 0                    # match() calls that reused >=1 block
        self.misses = 0
        self.hit_tokens = 0              # cumulative tokens served from cache
        self.inserted_blocks = 0         # chains donated by finished prefills
        self.evicted_blocks = 0          # tree references dropped under pressure
        self.dropped_blocks = 0          # scope invalidations (version GC,
                                         # tier redefinition) — not pressure

    # ----------------------------------------------------------- structure
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _nodes(self, root: _Node) -> List[_Node]:
        out, stack = [], list(root.children.values())
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    def num_blocks(self) -> int:
        """Total blocks referenced by all trees (any refcount)."""
        return len(self._by_block)

    def reclaimable(self) -> int:
        """Blocks held by the tree alone (allocator refcount == 1) —
        exactly the blocks :meth:`evict` can return to the free list.
        A request holds the full chain of every block it shares, so a
        refcount-1 node cannot have a request-pinned descendant; the
        count is exact (an O(1) maintained counter, asserted against a
        full recount in the tests)."""
        return self._retained

    def note_release(self, block: int) -> None:
        """Gateway hook: a request dropped its reference on ``block`` and
        exactly one reference remains.  If that survivor is the tree's,
        the block just became reclaimable — and, when its node is a
        leaf, joins the back of the eviction order (the releasing
        request was its most recent user)."""
        node = self._by_block.get(block)
        if node is not None:
            self._retained += 1
            if not node.children:
                self._evictable[block] = node

    def _walk(self, scope: Hashable, tokens: List[int]) -> List["_Node"]:
        """Longest cached chain for ``tokens``: the nodes in logical
        order.  The ONE matching rule shared by :meth:`match` and
        :meth:`peek` — full-block chunks by dict probe, then a partial
        tail node only when it covers the remaining tokens exactly."""
        root = self._scopes.get(scope)
        path: List[_Node] = []
        if root is None:
            return path
        node = root
        i = 0
        while i < len(tokens):
            child = None
            if i + self.block_size <= len(tokens):
                child = node.children.get(
                    tuple(tokens[i: i + self.block_size]))
            if child is None:
                tail = node.children.get(tuple(tokens[i:]))
                if tail is not None and tail.fill < self.block_size:
                    child = tail
            if child is None:
                break
            path.append(child)
            i += child.fill
            node = child
        return path

    # --------------------------------------------------------------- match
    def match(self, scope: Hashable, tokens: Sequence[int]) \
            -> Tuple[List[int], int]:
        """Longest cached chain for ``tokens`` under ``scope``.

        Returns ``(blocks, matched_tokens)`` in logical order; every
        returned block has been ``incref``-ed for the caller (so a
        concurrent eviction can never free it under the caller), and the
        matched path is LRU-touched.  ``matched_tokens`` counts the real
        tokens the chain covers — a partial tail node matches only when
        it covers the remaining tokens exactly.
        """
        path = self._walk(scope, [int(t) for t in tokens])
        blocks = [n.block for n in path]
        matched = sum(n.fill for n in path)
        for n in path:
            n.last_used = self._tick()
        for b in blocks:
            if self.allocator.incref(b) == 2:
                self._retained -= 1          # was tree-only, now adopted
                self._evictable.pop(b, None)
        if matched:
            self.hits += 1
            self.hit_tokens += matched
        else:
            self.misses += 1
        return blocks, matched

    def peek(self, scope: Hashable, tokens: Sequence[int]) -> int:
        """Length of the longest cached chain for ``tokens`` — the same
        :meth:`_walk` as :meth:`match` with NO side effects: no
        references taken, no LRU touch, no hit/miss accounting, so a
        probe never distorts the eviction order or pins anything."""
        return sum(n.fill for n in self._walk(scope,
                                              [int(t) for t in tokens]))

    # -------------------------------------------------------------- insert
    def insert(self, scope: Hashable, tokens: Sequence[int],
               blocks: Sequence[int]) -> int:
        """Donate a freshly prefilled chain: ``blocks[j]`` holds tokens
        ``[j*bs, min((j+1)*bs, len(tokens)))``.

        Chunks already present keep the tree's existing block (two
        same-prompt requests prefilled in one micro-batch both compute
        the chain; the second's copy stays private to it and dies with
        it).  New chunks take one tree reference on the request's block.
        Returns the number of newly retained blocks.
        """
        tokens = [int(t) for t in tokens]
        root = self._scopes.setdefault(scope, _Root())
        node: _Node = root
        donated = 0
        for j, block in enumerate(blocks):
            chunk = tuple(tokens[j * self.block_size:
                                 (j + 1) * self.block_size])
            if not chunk:
                break
            child = node.children.get(chunk)
            if child is None:
                # the parent stops being a leaf: out of the evictable set
                # (it may re-enter via promotion once its subtree drains)
                if not isinstance(node, _Root):
                    self._evictable.pop(node.block, None)
                child = _Node(chunk, int(block), node)
                node.children[chunk] = child
                self.allocator.incref(int(block))
                self._by_block[int(block)] = child
                donated += 1
            elif child.block in self._evictable:
                # re-donated chunk: the tree keeps its block, but this is
                # a fresh use — refresh its LRU position
                self._evictable.move_to_end(child.block)
            child.last_used = self._tick()
            node = child
        self.inserted_blocks += donated
        if donated:
            self.epoch += 1
        return donated

    # ------------------------------------------------------------ eviction
    def _recount_evictable(self) -> Tuple[int, Dict[int, "_Node"]]:
        """Ground truth by full walk: (reclaimable count, evictable leaf
        blocks).  Debug-mode oracle for the incremental structures."""
        retained = 0
        evictable: Dict[int, _Node] = {}
        for root in self._scopes.values():
            for node in self._nodes(root):
                if self.allocator.refcount(node.block) == 1:
                    retained += 1
                    if not node.children:
                        evictable[node.block] = node
        return retained, evictable

    def _check(self) -> None:
        retained, evictable = self._recount_evictable()
        assert retained == self._retained, (retained, self._retained)
        assert set(evictable) == set(self._evictable), \
            (sorted(evictable), sorted(self._evictable))

    def evict(self, n_blocks: int) -> int:
        """Drop LRU refcount-0 chains until ``n_blocks`` blocks actually
        returned to the free list (or nothing more is evictable).

        Pops the persistent evictable dict front-first — no tree walk,
        no heap rebuild: ``evict(1)`` is O(1) however many nodes the
        trees hold.  Only leaves are evictable (an interior block is the
        prefix of its children); when a leaf's eviction drains its
        parent into a reclaimable leaf, :meth:`_promote` places the
        parent at the front when it is no younger than the current LRU
        head (chains drain oldest-first) and at the back when a
        diverging match kept the prefix hot.  Returns the number of
        blocks freed.
        """
        if self.debug:
            self._check()
        freed = 0
        if n_blocks <= 0:
            return freed
        while self._evictable and freed < n_blocks:
            block, node = self._evictable.popitem(last=False)
            assert self.allocator.refcount(block) == 1, \
                (block, self.allocator.refcount(block))
            self.allocator.decref(block)
            self.evicted_blocks += 1
            self._retained -= 1
            freed += 1
            parent = node.parent
            del parent.children[node.tokens]
            self._by_block.pop(block, None)
            self._promote(parent)
        if freed:
            self.epoch += 1
        return freed

    def _promote(self, parent: "_Node") -> None:
        """A leaf eviction may leave its parent a reclaimable leaf.  In
        the common chain-drain case the parent's last touch is the same
        walk that touched the evicted child, so it belongs at the FRONT
        (drain the chain oldest-first).  But a parent can be *younger*
        than its drained child — a diverging match re-touches the shared
        prefix without touching the stale branch — and front-promoting a
        recently-hot prefix would evict it before genuinely colder
        leaves; those keep their recency at the back instead."""
        if isinstance(parent, _Root) or parent.children \
                or self.allocator.refcount(parent.block) != 1 \
                or parent.block in self._evictable:
            return
        self._evictable[parent.block] = parent
        head = next(iter(self._evictable))
        if head != parent.block and \
                parent.last_used <= self._evictable[head].last_used:
            self._evictable.move_to_end(parent.block, last=False)

    # ------------------------------------------------------------- scoping
    def drop_scope(self, *, tier: Optional[str] = None,
                   version: Optional[int] = None) -> int:
        """Release every tree reference of the matching scopes (None = any
        on that axis) — weight-version GC and tier redefinition/revocation
        must not keep serving stale activations.  Blocks still pinned by
        in-flight requests stay alive until those requests release them.
        """
        dropped = 0
        for scope in [s for s in self._scopes
                      if (tier is None or s[0] == tier)
                      and (version is None or s[1] == version)]:
            for node in self._nodes(self._scopes.pop(scope)):
                if self.allocator.refcount(node.block) == 1:
                    self._retained -= 1    # was tree-only before the drop
                self.allocator.decref(node.block)
                self._by_block.pop(node.block, None)
                self._evictable.pop(node.block, None)
                dropped += 1
        self.dropped_blocks += dropped
        if dropped:
            self.epoch += 1
        return dropped

    def forget_block(self, block: int) -> bool:
        """Drop the tree's reference on one retained *leaf* block so its
        remaining holder can write it in place.

        This is the pressure valve behind copy-on-write: when a request
        must write into its shared prompt tail but the pool has no spare
        block for a copy, forfeiting the tail's future hits beats
        preempting a running request.  Interior nodes are refused —
        their content is the prefix of live children.  Returns True if a
        reference was dropped.
        """
        node = self._by_block.get(block)
        if node is None or node.children:
            return False
        parent = node.parent
        del parent.children[node.tokens]
        del self._by_block[block]
        self._evictable.pop(block, None)
        if self.allocator.refcount(block) == 1:
            self._retained -= 1            # was tree-only before the drop
        self.allocator.decref(block)
        self.evicted_blocks += 1
        self.epoch += 1
        # the forgotten block's holder pins its whole chain, so the
        # newly-leafed parent is never reclaimable here — but direct API
        # callers may violate that, so keep the structure exact anyway
        self._promote(parent)
        return True

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {
            "hits": self.hits, "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
            # raw matched tokens; the gateway's ``prefix_tokens_reused``
            # stat is the capped number actually skipped at prefill
            "matched_tokens": self.hit_tokens,
            "cached_blocks": len(self._by_block),
            "retained_blocks": self._retained,
            "evictable_leaves": len(self._evictable),
            "inserted_blocks": self.inserted_blocks,
            "evicted_blocks": self.evicted_blocks,
            "dropped_blocks": self.dropped_blocks,
            "scopes": len(self._scopes),
        }
