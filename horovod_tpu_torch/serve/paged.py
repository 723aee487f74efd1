"""Paged KV memory: a pure, rank-deterministic page allocator and
per-slot block tables — the vLLM block-table idea (Kwon et al. 2023,
PAPERS.md) reduced to the serving plane's SPMD essentials.

A copy of ``horovod_tpu/serve/paged.py`` (pure Python), so the port
imports nothing of the JAX package; held against it by
``tests/test_torch_paged.py``.  The lint registration described below is
the reference file's.

The contiguous slot pool reserves ``slots x cache_len`` rows whether or
not a request ever writes them; the reference measured the cost
(``serve.kv.waste_ratio`` ~0.6+ on mixed-length traffic).  Here KV rows
live in fixed-size **pages** (``page_size`` token rows each) handed out
from a free list as positions actually advance, and each slot's cache
is the ordered list of pages in its **block table** — so allocated
bytes track tokens written, not worst-case length, and admission
capacity is judged in free pages rather than free slots.

Like the scheduler (serve/scheduler.py), this module is a **pure state
machine** — the serving HVD001 invariant: every rank of the serving
world feeds its own instance the SAME calls in the SAME order and must
derive the IDENTICAL page assignment, because the block table is an
input to the compiled decode step and a rank-divergent table would
desync the decode math the whole plane's bitwise-replay story rests
on.  Nothing here may read a clock, ``hvd.rank()``, ``random``, or an
unordered dict iteration; hvdtpu-lint HVD012 registers this file as a
determinism contract, and tests replay one trace through N instances.

Allocation policy (all deterministic):

* the free list is a min-heap — ``alloc`` always returns the
  LOWEST-numbered free page (heapq's ordering is a pure function of
  its contents);
* pages are **refcounted** so prefix caching can later map one
  physical page into several block tables (prefix caching); a page
  returns to the free list when its count reaches zero;
* admission reserves nothing physically but **commits** the request's
  worst case (``ceil((len(prompt+resume) + max_new_tokens) /
  page_size)`` pages): a request is admitted only when the sum of all
  active commitments plus its own fits the pool, so a mid-decode page
  allocation can never fail and no preemption/swap path is needed
  (the honest trade vs vLLM's swapping).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence

__all__ = ["pages_for", "page_reject_reason", "PagedKV"]


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` rows (0 tokens -> 0 pages)."""
    if tokens <= 0:
        return 0
    return -(-int(tokens) // int(page_size))


def page_reject_reason(prompt_len: int, max_new_tokens: int,
                       page_size: int, num_pages: int) -> Optional[str]:
    """Permanent page-infeasibility verdict for one request, or None.

    Pure — every rank (and every group of a width-sharded fleet)
    reaches the same verdict for the same log entry, like
    ``frontend.validate_request``.  A request whose worst case exceeds
    the WHOLE pool can never be admitted no matter how long it queues;
    rejecting it loudly beats a permanently head-blocked FCFS queue.
    """
    need = pages_for(prompt_len + max_new_tokens, page_size)
    if need > num_pages:
        return (
            f"request needs {need} KV pages worst-case "
            f"(prompt {prompt_len} + max_new_tokens {max_new_tokens} at "
            f"{page_size} rows/page) but the pool holds {num_pages}"
        )
    return None


class PagedKV:
    """Block tables + free-list page allocator for one slot pool.

    Tracks, per slot: the ordered page list (the block table), the
    write position, and the worst-case page commitment made at
    admission.  The device-side pool (models/decode.py
    ``init_paged_pool``) is indexed by these page ids; ``null_page``
    (== ``num_pages``) pads table rows past the allocated prefix — out
    of bounds by construction, so scatter-``drop`` discards writes to
    it and gather-``fill`` reads zeros (masked by ``pos`` anyway).
    """

    def __init__(self, num_slots: int, num_pages: int, page_size: int,
                 max_len: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError("num_pages and page_size must be >= 1")
        self.num_slots = int(num_slots)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # Per-slot virtual capacity: the block table's fixed width.  The
        # compiled decode gathers exactly this many pages per slot, so
        # it is the serving context rounded UP to whole pages.
        self.max_pages_per_slot = pages_for(max_len, page_size)
        self.null_page = self.num_pages
        self._free: List[int] = list(range(self.num_pages))
        heapq.heapify(self._free)
        self._ref: List[int] = [0] * self.num_pages
        self._tables: Dict[int, List[int]] = {}
        self._pos: Dict[int, int] = {}
        self._committed: Dict[int, int] = {}

    # ------------------------------------------------------------ queries

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def committed_pages(self) -> int:
        return sum(self._committed.values())

    def table(self, slot: int) -> List[int]:
        return list(self._tables.get(slot, ()))

    def position(self, slot: int) -> int:
        return self._pos.get(slot, 0)

    def can_admit(self, total_len: int) -> bool:
        """Admission judgement in pages: does the pool have room for
        this request's WORST CASE on top of every active commitment?
        Committed-not-yet-allocated pages count against the pool so a
        mid-decode ``ensure_capacity`` can never fail — the price is
        capacity bounded by budgets, not by live usage (documented)."""
        need = pages_for(total_len, self.page_size)
        if need > self.max_pages_per_slot:
            return False
        return self.committed_pages + need <= self.num_pages

    def admission_gate(self):
        """Batch form of :meth:`can_admit` for ONE scheduling round:
        the returned callable accumulates the round's accepted worst
        cases, so two requests admitted in the same round cannot both
        be judged against the same free pool (the engine-side admit of
        the second would then overcommit and raise — a rank-killing
        accounting bug, regression-tested).  Build a fresh gate every
        round; acceptance order is the FCFS order, so every rank's
        gate makes identical judgements."""
        pending = [0]

        def gate(total_len: int) -> bool:
            need = pages_for(total_len, self.page_size)
            if need > self.max_pages_per_slot:
                return False
            if self.committed_pages + pending[0] + need <= self.num_pages:
                pending[0] += need
                return True
            return False

        return gate

    # --------------------------------------------------------- allocation

    def _alloc_page(self) -> int:
        if not self._free:
            raise RuntimeError(
                "page pool exhausted — the commitment invariant was "
                "violated (admission must gate on can_admit)"
            )
        page = heapq.heappop(self._free)
        self._ref[page] = 1
        return page

    def admit(self, slot: int, prefill_len: int, total_len: int) -> List[int]:
        """Allocate the pages ``prefill_len`` written rows need, set the
        slot's position, and commit the request's worst case
        (``total_len`` rows).  Returns the slot's block table."""
        if slot in self._tables:
            raise ValueError(f"slot {slot} already holds a block table")
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} outside the {self.num_slots}-"
                             f"slot pool")
        if not self.can_admit(total_len):
            raise RuntimeError(
                f"admitting {total_len} rows would overcommit the "
                f"{self.num_pages}-page pool (can_admit gate skipped?)"
            )
        if prefill_len > total_len:
            raise ValueError("prefill_len exceeds the committed total")
        table = [self._alloc_page()
                 for _ in range(pages_for(prefill_len, self.page_size))]
        self._tables[slot] = table
        self._pos[slot] = int(prefill_len)
        self._committed[slot] = pages_for(total_len, self.page_size)
        return list(table)

    def ensure_capacity(self, slot: int) -> bool:
        """Make sure the slot's NEXT write position has a page; returns
        True when a page was newly allocated (the device block table
        must be refreshed).  Called before every decode step for every
        active slot — under the commitment invariant this cannot fail.
        """
        table = self._tables.get(slot)
        if table is None:
            raise KeyError(f"slot {slot} has no block table")
        pos = self._pos[slot]
        page_idx = pos // self.page_size
        if page_idx < len(table):
            return False
        if page_idx >= self.max_pages_per_slot:
            # Writing past the virtual capacity is the decode overrun
            # the NaN-poison contract covers; no page to allocate.
            return False
        if len(table) >= self._committed[slot]:
            raise RuntimeError(
                f"slot {slot} grew past its {self._committed[slot]}-page "
                f"commitment — admission accounting is broken"
            )
        table.append(self._alloc_page())
        return True

    def advance(self, slot: int) -> None:
        """Host mirror of the device-side position advance (one token
        written by the decode step)."""
        if slot not in self._pos:
            raise KeyError(f"slot {slot} has no block table")
        self._pos[slot] += 1

    def release(self, slot: int) -> None:
        """Evict: drop the slot's table, decref its pages (freed at
        zero), release its commitment.  Free-list re-entry keeps the
        heap ordering, so page reuse is deterministic."""
        table = self._tables.pop(slot, None)
        if table is None:
            return
        self._pos.pop(slot, None)
        self._committed.pop(slot, None)
        for page in table:
            self._ref[page] -= 1
            if self._ref[page] == 0:
                heapq.heappush(self._free, page)

    def retain(self, pages: Sequence[int]) -> None:
        """Bump refcounts (prefix caching maps shared pages into a
        second block table; the page frees only when BOTH release)."""
        for page in pages:
            if self._ref[page] < 1:
                raise ValueError(f"page {page} is not allocated")
            self._ref[page] += 1

    def adopt(self, slot: int, pages: Sequence[int], prefill_len: int,
              total_len: int) -> None:
        """Install an externally assembled (e.g. prefix-shared) table.
        Caller must have ``retain``-ed shared pages first."""
        if slot in self._tables:
            raise ValueError(f"slot {slot} already holds a block table")
        self._tables[slot] = list(pages)
        self._pos[slot] = int(prefill_len)
        self._committed[slot] = pages_for(total_len, self.page_size)

    def reset(self) -> None:
        """Drop everything (elastic epoch rebuild): all pages free, no
        tables — the deterministic replay of admissions from the
        request log rebuilds identical tables on every rank."""
        self._free = list(range(self.num_pages))
        heapq.heapify(self._free)
        self._ref = [0] * self.num_pages
        self._tables.clear()
        self._pos.clear()
        self._committed.clear()

    # ------------------------------------------------------------- arrays

    def table_row(self, slot: int) -> List[int]:
        """The slot's block table padded to ``max_pages_per_slot`` with
        ``null_page`` — the row the compiled decode step consumes."""
        table = self._tables.get(slot, [])
        pad = self.max_pages_per_slot - len(table)
        return list(table) + [self.null_page] * pad

    # -------------------------------------------------------------- stats

    def stats(self, row_bytes: float) -> dict:
        """Page-granular occupancy: ``allocated`` is pages actually
        handed out (times their row capacity), ``live`` is positions
        written — the successor of memplane.kv_occupancy's fixed-row
        math, recomputed from the block table so the waste a partial
        last page carries is the ONLY waste left.  Pages belong to
        exactly the admitted-not-yet-evicted slots, so no active-set
        argument is needed: a released slot's pages left with it."""
        used = self.used_pages
        allocated = used * self.page_size * float(row_bytes)
        live = 0.0
        for s in sorted(self._tables):
            cap = len(self._tables[s]) * self.page_size
            live += min(self._pos.get(s, 0), cap) * float(row_bytes)
        return {
            "slots_in_use": len(self._tables),
            "allocated_bytes": int(allocated),
            "live_bytes": int(live),
            "waste_ratio": (1.0 - live / allocated) if allocated else 0.0,
            "page_size": self.page_size,
            "pages_free": self.free_pages,
            "pages_used": used,
            "pages_committed": self.committed_pages,
        }
