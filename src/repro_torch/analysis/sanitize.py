"""Opt-in runtime sanitizers for the port's serving path.

A copy of ``repro/analysis/sanitize.py`` (pure Python; the JAX
package's module is not importable without JAX).  Two independent
detectors, wired into a gateway by constructing it with
``sanitize=True`` (or exporting ``REPRO_SANITIZE=1``):

* **Block sanitizer** — a shadow refcount model of the
  :class:`~repro_torch.serving.paging.BlockAllocator`, mirrored by
  wrapping the allocator's four mutators on the live instance.  It
  catches, at the *first wrong operation* rather than at the eventual
  crash: double-free / decref of a dead block, free of a still-shared
  block, allocation handing out a live block, a block-table entry
  pointing at a freed block, a decode write landing on a shared block
  that should have been CoW-copied first, and blocks still held after
  the gateway drains with no request or prefix-tree reference to them
  (a leak).
* **Retrace sentinel** — counts the distinct step shapes per entry
  family against the pow2-bucket bound the gateway's design promises
  (chunked-prefill ``(batch, cols)`` buckets, decode table width).  In
  the JAX package each shape is one jit compilation; in the port it is
  one set of kernel launch shapes (and, once the decode step is
  captured, one CUDA graph), so the same bound applies.  A shape that
  escapes its bucket shows up as an over-bound family.

Every violation raises :class:`SanitizerError` — loud and synchronous,
because the sanitizer's job is pinpointing the op that broke the
invariant.  The wrappers cost one dict op per allocator call and are
never installed unless sanitizing, so production serving pays nothing.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, Set

__all__ = ["SanitizerError", "RetraceSentinel", "ServingSanitizer",
           "sanitize_from_env"]


class SanitizerError(RuntimeError):
    """A serving invariant was violated (block lifecycle or retracing)."""


def sanitize_from_env() -> bool:
    """The ``REPRO_SANITIZE`` opt-in (the CI sanitizer lane sets it)."""
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


# --------------------------------------------------------------- retracing
class RetraceSentinel:
    """Count distinct step-shape keys per entry family.

    ``note(family, key)`` records one specialization; exceeding the
    family's declared bound raises — the bound IS the design contract
    (pow2 bucketing keeps the shapes logarithmic in config, not linear
    in traffic)."""

    def __init__(self) -> None:
        self._keys: Dict[str, Set[Any]] = {}
        self._bounds: Dict[str, int] = {}

    def bound(self, family: str, n: int) -> None:
        self._bounds[family] = int(n)

    def note(self, family: str, key: Any) -> None:
        keys = self._keys.setdefault(family, set())
        if key in keys:
            return
        keys.add(key)
        bound = self._bounds.get(family)
        if bound is not None and len(keys) > bound:
            raise SanitizerError(
                f"retracing sentinel: step family {family!r} reached "
                f"{len(keys)} distinct specializations, over its bound "
                f"of {bound} — a shape is escaping its pow2 bucket "
                f"(keys: {sorted(map(repr, keys))})")

    def stats(self) -> Dict[str, int]:
        return {f: len(k) for f, k in self._keys.items()}


# ----------------------------------------------------------- block shadow
class ServingSanitizer:
    """Shadow-model sanitizer for one gateway/slot.

    ``attach_allocator`` must run before any block traffic (the shadow
    assumes it sees every mutation); the gateway calls the ``check_*``
    hooks at its step boundaries."""

    def __init__(self) -> None:
        self.shadow: Dict[int, int] = {}         # block id -> refcount
        self.retrace = RetraceSentinel()
        self._allocator: Any = None

    # ------------------------------------------------- allocator mirror
    def attach_allocator(self, allocator: Any) -> None:
        if self._allocator is not None:
            raise SanitizerError("sanitizer already attached")
        self._allocator = allocator
        if getattr(allocator, "num_held", 0):
            raise SanitizerError(
                "attach_allocator on an allocator with live blocks; the "
                "shadow must see every allocation")
        orig_alloc = allocator.alloc
        orig_free = allocator.free
        orig_incref = allocator.incref
        orig_decref = allocator.decref
        shadow = self.shadow

        def alloc(n: int):
            got = orig_alloc(n)
            if got is not None:
                for b in got:
                    if b in shadow:
                        raise SanitizerError(
                            f"allocator handed out block {b} which the "
                            f"shadow believes is live (ref "
                            f"{shadow[b]}) — free-list corruption")
                    shadow[b] = 1
                self._cross_check("alloc")
            return got

        def incref(b: int) -> int:
            if b not in shadow:
                raise SanitizerError(
                    f"incref of non-live block {b} (use-after-free)")
            ref = orig_incref(b)
            shadow[b] += 1
            self._cross_check("incref")
            return ref

        def decref(b: int) -> int:
            if b not in shadow:
                raise SanitizerError(
                    f"decref of non-live block {b} (double free)")
            ref = orig_decref(b)
            shadow[b] -= 1
            if shadow[b] == 0:
                del shadow[b]
            self._cross_check("decref")
            return ref

        def free(blocks) -> None:
            blist = list(blocks)
            for b in blist:
                if b not in shadow:
                    raise SanitizerError(
                        f"free of non-live block {b} (double free)")
                if shadow[b] != 1:
                    raise SanitizerError(
                        f"free of block {b} with shadow refcount "
                        f"{shadow[b]} — shared blocks must drop via decref")
            orig_free(blist)
            for b in blist:
                del shadow[b]
            self._cross_check("free")

        allocator.alloc = alloc
        allocator.incref = incref
        allocator.decref = decref
        allocator.free = free

    def _cross_check(self, op: str) -> None:
        real = getattr(self._allocator, "_ref", None)
        if real is not None and dict(real) != self.shadow:
            raise SanitizerError(
                f"shadow/allocator divergence after {op}: allocator "
                f"{dict(real)!r} vs shadow {self.shadow!r}")

    # ---------------------------------------------------- gateway hooks
    def check_decode_writes(self, reqs: Iterable[Any], pool: Any) -> None:
        """Post-CoW pre-write check: every table entry of every decoding
        request is live, and the block the next token lands in is
        exclusively owned (CoW must have split it)."""
        bs = int(pool.block_size)
        for req in reqs:
            if not req.blocks:
                continue
            for b in req.blocks:
                if b not in self.shadow:
                    raise SanitizerError(
                        f"request {req.rid}: block table entry {b} points "
                        f"at a freed block")
            w = min(req.pos // bs, len(req.blocks) - 1)
            tail = req.blocks[w]
            if self.shadow.get(tail, 0) > 1:
                raise SanitizerError(
                    f"request {req.rid}: decode write targets block "
                    f"{tail} with refcount {self.shadow[tail]} — write "
                    f"to a shared block without CoW")

    def after_step(self, gw: Any) -> None:
        """Step-boundary sweep: every request-held block is still live."""
        sched = gw.scheduler
        for req in list(sched.running) + list(sched.waiting):
            for b in req.blocks:
                if b not in self.shadow:
                    raise SanitizerError(
                        f"request {req.rid}: holds freed block {b} after "
                        f"step")
        self._cross_check("step")

    def check_drained(self, gw: Any) -> None:
        """Leak check at drain: a live block with no request and no
        prefix-tree node retaining it is unreachable — nothing can ever
        free it."""
        sched = gw.scheduler
        reachable: Set[int] = set()
        for req in list(sched.running) + list(sched.waiting):
            reachable.update(req.blocks)
        prefix = getattr(gw, "prefix", None)
        if prefix is not None:
            reachable.update(prefix._by_block.keys())
        leaked: List[int] = sorted(set(self.shadow) - reachable)
        if leaked:
            raise SanitizerError(
                f"leak at drain: blocks {leaked} still held with no "
                f"request or prefix reference "
                f"(refs {[self.shadow[b] for b in leaked]})")
