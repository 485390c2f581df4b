"""KV cache pools + page allocator (counterpart of ``repro/serve/cache.py``).

Two pool layouts back the engine:

- **Paged (default).** Attention leaves hold ``num_pages`` fixed-size
  physical pages — ``(layers, num_pages, page_size, KV, hd)`` — shared by
  every slot through a per-slot *block table* (``(max_slots,
  pages_per_slot)`` int32 of physical page ids). Reads fetch pages inside
  ``flash_decode_paged`` (or gather lanes on the ``ref`` path), writes
  scatter rows through the table, and the host-side :class:`PageAllocator`
  owns the free list, refcounts, the hashed prefix cache and copy-on-write
  bookkeeping. SSM conv/state leaves have no sequence axis to page and
  keep one lane per slot: ``(layers, max_slots, ...)``.
- **Contiguous.** ``model.init_cache(max_slots, max_seq)``: one private
  ``max_seq`` lane per slot — the parity oracle for the paged engine.

Physical page 0 is the **null page**: block tables start (and reset) at
0, idle slots and pad-row scatters land there harmlessly, and it is never
on the free list.

Unlike the JAX package's pure functions, the device ops here update the
pool in place (``copy_page``, the writes through ``slot_view`` and
``paged_view``) and return the pool they were given. :class:`PageAllocator` and
:func:`hash_prefix_chunk` are host-side copies of the originals, pinned to
them by ``tests/test_torch_host.py``.

A pool is a list of segments, each a dict of groups (``"attn"``,
``"ssm"``) of named tensors; a leaf's *path* is ``(segment, group,
name)``.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque

import numpy as np

NULL_PAGE = 0


# ---------------------------------------------------------------------------
# pool construction / views
# ---------------------------------------------------------------------------

def make_pool(model, max_slots: int, max_seq: int):
    """Contiguous pool: one lane per slot, ``max_seq`` rows each."""
    return model.init_cache(max_slots, max_seq)


def make_paged_pool(model, max_slots: int, page_size: int, num_pages: int):
    """Paged pool: attention leaves are (layers, num_pages, page_size, ...)
    physical pages."""
    return model.init_paged_cache(max_slots, page_size, num_pages)


def leaves_with_path(pool):
    """((segment, group, name), tensor) for every cache tensor."""
    return [((i, grp, n), t) for i, seg in enumerate(pool)
            for grp, ts in seg.items() for n, t in ts.items()]


def leaves(pool):
    """Every cache tensor of the pool."""
    return [t for _, t in leaves_with_path(pool)]


def is_paged_leaf(path) -> bool:
    """True for attention K/V and MLA latent leaves (page-granular in a
    paged pool); False for SSM conv/state lanes (slot-granular, no
    sequence axis)."""
    return "attn" in path


def _map_views(pool, fn):
    """The pool's structure with ``fn(path, tensor)`` at every leaf."""
    return [{grp: {n: fn((i, grp, n), t) for n, t in ts.items()}
             for grp, ts in seg.items()} for i, seg in enumerate(pool)]


def _lane(t, slot: int):
    """Slot ``slot`` of a slot-granular leaf, as a (layer, 1, ...) view:
    segments stack their caches as (layer, slot, ...). (In a paged pool,
    axis 1 of an attention leaf is the page id.)"""
    return t.narrow(1, slot, 1)


def _fold(pool, slot: int, view, paged: bool):
    """Copy each slot lane of ``view`` into the pool unless it is already
    a view of it (attention leaves of a paged pool were written in
    place)."""
    for (i, grp, n), t in leaves_with_path(pool):
        if paged and is_paged_leaf((i, grp, n)):
            continue
        dst, src = _lane(t, slot), view[i][grp][n]
        if src.data_ptr() != dst.data_ptr():
            dst.copy_(src)
    return pool


def slot_view(pool, slot: int):
    """Slot ``slot`` of a contiguous pool as a batch-1 cache: views, so
    writes through them land in the pool."""
    return _map_views(pool, lambda p, t: _lane(t, slot))


def slot_write(pool, slot: int, view):
    """Fold a batch-1 cache back into the pool at ``slot``: a no-op for the
    views :func:`slot_view` hands out, a copy for anything else."""
    return _fold(pool, slot, view, paged=False)


def paged_view(pool, slot: int):
    """Prefill view of a paged pool: page-granular leaves pass through
    whole (chunk writes scatter through the block table), slot-granular
    SSM leaves are sliced to the (1, ...) lane the batched path expects
    (views: writes land in the pool)."""
    return _map_views(pool, lambda p, t: t if is_paged_leaf(p)
                      else _lane(t, slot))


def paged_write(pool, slot: int, view):
    """Fold a :func:`paged_view` back: pages were written in place; SSM
    lanes fold to their slot as :func:`slot_write` folds them."""
    return _fold(pool, slot, view, paged=True)


def reset_slot_ssm(pool, slot: int):
    """Zero one slot's SSM conv/state lanes only, in place. Attention
    rows need no zeroing (a previous occupant's rows are causally masked
    until the new request overwrites them in order, and a paged slot
    starts from fresh pages); the SSM lanes do, since their state carries
    across prefill chunks by design. Works on both pool layouts."""
    for p, t in leaves_with_path(pool):
        if not is_paged_leaf(p):
            _lane(t, slot).zero_()
    return pool


def copy_page(pool, dst: int, src: int):
    """Copy one physical page across all layers of every page-granular
    leaf, in place — the copy-on-write device op."""
    for p, t in leaves_with_path(pool):
        if is_paged_leaf(p):
            t[:, dst] = t[:, src]
    return pool


# ---------------------------------------------------------------------------
# page allocator (host-side copy)
# ---------------------------------------------------------------------------

class OutOfPages(RuntimeError):
    """Page pool exhausted: no free page and nothing evictable. Admission
    reservations make this unreachable from the engine loop; hitting it
    means allocator bookkeeping is broken."""


def hash_prefix_chunk(prev: bytes, tokens) -> bytes:
    """One hash-chain step over a page of prompt tokens: ``H(prev ||
    tokens)``. Module-level so tests can monkeypatch it to force
    collisions; collisions are survivable (entries store the full token
    prefix and verify it on hit) — just cache misses."""
    h = hashlib.sha1(prev)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


class PageAllocator:
    """Free-list page allocator + refcounts + hashed prefix cache.

    All host-side numpy/dict state; the engine uploads ``tables`` as a
    same-shaped int32 array per dispatch. Invariants:

    - ``refs[pid]`` counts owners: one per slot whose table maps the page,
      plus one if the prefix cache holds it. Page 0 (the null page) is
      pinned and never allocated or freed.
    - A page registered in the prefix cache is **never written again**
      (registration happens after prefill finishes the prompt; decode
      writes land strictly beyond the prompt's full pages).
    - A write to a shared page (refs > 1) must copy first:
      :meth:`ensure_writable` returns the (dst, src) device copies.
    - Admission reserves its worst-case page count up front
      (:meth:`try_admit`), so mid-flight allocation never fails.
    - Cache-only pages (refs == 1, held only by the prefix cache) are
      evictable, oldest-hit first (LRU).
    """

    def __init__(self, num_pages: int, page_size: int, max_slots: int,
                 pages_per_slot: int, *, prefix_cache: bool = True):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (null + 1), got {num_pages}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_slots = max_slots
        self.pages_per_slot = pages_per_slot
        self.prefix_cache = prefix_cache
        self.refs = np.zeros(num_pages, np.int64)
        self.refs[NULL_PAGE] = 1                 # pinned
        self.free: deque[int] = deque(range(1, num_pages))
        self.tables = np.zeros((max_slots, pages_per_slot), np.int32)
        self._reserved = np.zeros(max_slots, np.int64)
        # prefix cache: chain digest -> (pid, full token prefix); LRU over
        # digests orders eviction
        self._entries: dict[bytes, tuple[int, tuple]] = {}
        self._by_pid: dict[int, bytes] = {}
        self._lru: OrderedDict[bytes, None] = OrderedDict()
        # pages withheld from circulation by fault injection (pagepress)
        self.held: list[int] = []
        # counters (pages unless noted; read by EngineStats / bench)
        self.hits = 0
        self.lookups = 0
        self.hit_tokens = 0
        self.cow_copies = 0
        self.evictions = 0
        self.collisions = 0

    # -- capacity -----------------------------------------------------------

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def _evictable(self) -> int:
        return sum(1 for pid in self._by_pid if self.refs[pid] == 1)

    def available(self) -> int:
        """Pages an admission could claim right now: free + evictable,
        minus what already-admitted requests still have reserved."""
        return (len(self.free) + self._evictable()
                - int(self._reserved.sum()))

    @property
    def allocated(self) -> int:
        """Pages holding live or cached rows (excludes the null page)."""
        return self.num_pages - 1 - len(self.free)

    def occupancy(self) -> float:
        return self.allocated / max(self.num_pages - 1, 1)

    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    # -- page ops -----------------------------------------------------------

    def _alloc(self, slot: int | None) -> int:
        if not self.free and not self._evict_one():
            raise OutOfPages(
                f"no free page ({self.allocated}/{self.num_pages - 1} "
                f"allocated, nothing evictable)")
        pid = self.free.popleft()
        assert self.refs[pid] == 0
        self.refs[pid] = 1
        if slot is not None and self._reserved[slot] > 0:
            self._reserved[slot] -= 1
        return pid

    def _evict_one(self) -> bool:
        for key in self._lru:            # oldest-hit first
            pid = self._entries[key][0]
            if self.refs[pid] == 1:      # cache-only: safe to drop
                self._drop_entry(key)
                self.refs[pid] = 0
                self.free.append(pid)
                self.evictions += 1
                return True
        return False

    def _drop_entry(self, key: bytes) -> None:
        pid, _ = self._entries.pop(key)
        self._by_pid.pop(pid, None)
        self._lru.pop(key, None)

    def _unref(self, pid: int) -> None:
        if pid == NULL_PAGE:
            return
        self.refs[pid] -= 1
        assert self.refs[pid] >= 0, f"refcount underflow on page {pid}"
        if self.refs[pid] == 0:
            self.free.append(pid)

    # -- admission ----------------------------------------------------------

    def _match_prefix(self, tokens) -> list[int]:
        """Longest chain of cached full prompt pages (hash-chain walk with
        token verification — a digest collision is a miss, not corruption)."""
        ps = self.page_size
        pids: list[int] = []
        prev = b""
        for j in range(len(tokens) // ps):
            prev = hash_prefix_chunk(prev, tokens[j * ps:(j + 1) * ps])
            self.lookups += 1
            ent = self._entries.get(prev)
            if ent is None:
                break
            pid, prefix = ent
            if tuple(tokens[:(j + 1) * ps]) != prefix:
                self.collisions += 1
                break
            pids.append(pid)
        return pids

    def try_admit(self, slot: int, tokens, max_new: int) -> int | None:
        """Install prefix hits into ``slot``'s table and reserve the
        worst-case remaining page count. Returns the hit token count
        (prefill resumes there), or None — with zero state mutated — if
        the pool can't hold the request yet."""
        ps = self.page_size
        S0 = len(tokens)
        total = self.pages_needed(S0 + max_new)
        hits = self._match_prefix(tokens) if self.prefix_cache else []
        h = len(hits)
        full_hit = h * ps == S0
        # full-prompt hit still re-runs the final prompt token for its
        # sampling logits; that write COWs the shared last page: +1
        need = total - h + (1 if full_hit else 0)
        if need > self.available():
            return None
        row = self.tables[slot]
        assert not row.any() and self._reserved[slot] == 0, \
            f"slot {slot} admitted while holding pages"
        for j, pid in enumerate(hits):
            self.refs[pid] += 1
            row[j] = pid
            self._lru.move_to_end(self._by_pid[pid])
        self._reserved[slot] = need
        self.hits += h
        self.hit_tokens += h * ps
        return h * ps

    def ensure_writable(self, slot: int, position: int) -> list[tuple[int, int]]:
        """Make the page covering ``position`` privately writable before a
        dispatch writes it: allocate on first touch, copy-on-write when
        shared. Returns the (dst, src) device copies to run (at most one)."""
        j = position // self.page_size
        row = self.tables[slot]
        pid = int(row[j])
        if pid == NULL_PAGE:
            row[j] = self._alloc(slot)
            return []
        if self.refs[pid] > 1:           # shared with the cache/other slots
            new = self._alloc(slot)
            row[j] = new
            self.refs[pid] -= 1          # this slot's ref moves to the copy
            self.cow_copies += 1
            return [(new, pid)]
        return []

    def register_prefix(self, slot: int, tokens) -> None:
        """Publish the request's full prompt pages into the prefix cache
        (+1 ref each; cache entries are never written afterwards). Pages
        that arrived as hits, or whose digest is already published by a
        twin request, are skipped."""
        if not self.prefix_cache:
            return
        ps = self.page_size
        prev = b""
        row = self.tables[slot]
        for j in range(len(tokens) // ps):
            prev = hash_prefix_chunk(prev, tokens[j * ps:(j + 1) * ps])
            if prev in self._entries:    # hit-installed or twin (or a
                continue                 # colliding digest: first wins)
            pid = int(row[j])
            if pid == NULL_PAGE or pid in self._by_pid:
                continue
            self.refs[pid] += 1
            self._entries[prev] = (pid, tuple(tokens[:(j + 1) * ps]))
            self._by_pid[pid] = prev
            self._lru[prev] = None
        # hits/twins referenced above stay MRU even when nothing new was
        # published (the loop body touched move_to_end at admission)

    def release_slot(self, slot: int) -> None:
        """Free-list page release at request finish: drop the slot's ref on
        every mapped page (pages the prefix cache still holds survive with
        refs >= 1 for future hits) and clear its table row + reservation."""
        row = self.tables[slot]
        for j in range(self.pages_per_slot):
            pid = int(row[j])
            row[j] = NULL_PAGE
            self._unref(pid)
        self._reserved[slot] = 0

    # -- fault injection: page-pool pressure --------------------------------

    def hold_pages(self, n: int) -> int:
        """Withhold up to ``n`` free pages from circulation (the
        ``pagepress`` fault: a shrunken usable pool). Held pages vanish
        from the free list — ``available()`` drops, ``occupancy()`` rises
        (brownout sees real pressure) — and come back via
        :meth:`release_held`. Takes from the free list's tail so the
        allocation order of the surviving pages is unchanged (replay
        determinism). Returns how many were actually held."""
        took = 0
        while self.free and took < n:
            self.held.append(self.free.pop())
            took += 1
        return took

    def release_held(self) -> int:
        """Return every held page to the free list (tail, reversed — the
        exact inverse of :meth:`hold_pages`)."""
        n = len(self.held)
        while self.held:
            self.free.append(self.held.pop())
        return n

    # -- invariants ---------------------------------------------------------

    def check_consistency(self) -> None:
        """Assert the allocator's global refcount invariant:

        every non-null page is exactly one of {free, held, live}, and a
        live page's refcount equals its slot-table mappings plus its
        prefix-cache hold — i.e. ``free + held + mapped/prefix-held +
        null == num_pages`` with per-page refs exact. Raises
        AssertionError with the first violation; any interleaving of
        finish/cancel/evict/COW must keep this true (property-tested)."""
        expect = np.zeros(self.num_pages, np.int64)
        expect[NULL_PAGE] = 1                      # pinned
        for row in self.tables:
            for pid in row:
                if pid != NULL_PAGE:
                    expect[pid] += 1
        for pid, _ in self._entries.values():
            expect[pid] += 1
        assert np.array_equal(self.refs, expect), (
            f"refcount drift: refs={self.refs.tolist()} "
            f"expected={expect.tolist()}")
        free = set(self.free)
        held = set(self.held)
        assert len(free) == len(self.free), "duplicate page on free list"
        assert len(held) == len(self.held), "duplicate held page"
        assert not (free & held), "page both free and held"
        assert NULL_PAGE not in free | held, "null page left the pool"
        live = {pid for pid in range(self.num_pages)
                if self.refs[pid] > 0}
        assert not (live & (free | held)), (
            f"referenced page on the free/held list: "
            f"{sorted(live & (free | held))}")
        assert len(free) + len(held) + len(live) == self.num_pages, (
            f"page leak: {len(free)} free + {len(held)} held + "
            f"{len(live)} live != {self.num_pages}")
        assert self.refs[NULL_PAGE] == 1, "null page unpinned"
        # prefix entries and the reverse index agree
        assert ({pid for pid, _ in self._entries.values()}
                == set(self._by_pid)), "prefix cache index drift"

    def state_digest(self) -> tuple:
        """Cheap structural fingerprint (tables, refs, free/held order,
        reservations, prefix keys) — rejection paths must leave it
        bit-identical (tested)."""
        return (self.tables.tobytes(), self.refs.tobytes(),
                tuple(self.free), tuple(self.held),
                self._reserved.tobytes(), tuple(self._entries.keys()))
