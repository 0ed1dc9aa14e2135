"""Paged KV cache: fixed-size pages in a shared device pool, with
host-side page tables per sequence.

Counterpart of horovod_tpu/serve/kv_cache.py, whole: vLLM's
PagedAttention memory manager. The device holds one (n_layers,
num_pages, page_size, h_kv, head_dim) pool per cache side (owned by
serve/engine.py, which updates it in place); the free list and the
per-sequence page tables live on the host, and attention reads through
the table (ops/flash_attention.py:paged_attention_decode).

Page 0 is the NULL page: never allocated, every unused page-table slot
points at it, and inactive batch rows carry an all-null table. Padded
prefill tails and padded decode rows write their rows there, so the
engine needs no masking on the write side — the garbage lands somewhere
harmless by construction, and the length mask keeps page 0 out of every
real sequence's attention.
"""

import math


class OutOfPages(RuntimeError):
    """Admission asked for more pages than the free list holds."""


class PagedKVCache:
    """Host-side allocator for the paged pool + the pool arrays.

    ``num_pages`` counts the whole pool including the null page, so
    ``num_pages - 1`` pages are allocatable. Allocation is whole-
    lifetime: :meth:`allocate` reserves every page a sequence can ever
    touch (prompt + max new tokens, rounded up to pages), so a running
    sequence can never hit an out-of-pages mid-stream — admission
    control in serve/scheduler.py is exactly "does the free list cover
    the reservation". ``max_pages_per_seq`` bounds the page-table width
    (the decode program's K extent is pages * page_size)."""

    def __init__(self, n_layers, h_kv, head_dim, num_pages, page_size,
                 max_pages_per_seq, dtype):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is null)")
        self.n_layers = int(n_layers)
        self.h_kv = int(h_kv)
        self.head_dim = int(head_dim)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self.dtype = dtype
        # LIFO free list: recently-freed pages are re-used first (their
        # pool rows are the likeliest to still be in cache somewhere).
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._tables = {}   # seq_id -> [page ids, allocation order]
        self.allocs = 0
        self.frees = 0

    # ---------------------------------------------------------- sizing

    def pages_for(self, n_tokens):
        """Pages covering ``n_tokens`` cache rows (>= 1 so even an empty
        sequence owns a page for its first token)."""
        return max(1, int(math.ceil(n_tokens / self.page_size)))

    @property
    def free_pages(self):
        return len(self._free)

    @property
    def used_pages(self):
        return (self.num_pages - 1) - len(self._free)

    @property
    def active_sequences(self):
        return len(self._tables)

    def can_allocate(self, n_tokens):
        need = self.pages_for(n_tokens)
        return need <= self.max_pages_per_seq and need <= len(self._free)

    # ------------------------------------------------------ alloc/free

    def allocate(self, seq_id, n_tokens):
        """Reserve the pages for a sequence's whole lifetime (prompt +
        max new tokens). Raises :class:`OutOfPages` when the free list
        cannot cover it, ValueError on a duplicate id or a reservation
        wider than ``max_pages_per_seq``."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        need = self.pages_for(n_tokens)
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"{n_tokens} tokens need {need} pages > max_pages_per_seq"
                f"={self.max_pages_per_seq}")
        if need > len(self._free):
            raise OutOfPages(
                f"{need} pages requested, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(need)]
        self._tables[seq_id] = pages
        self.allocs += need
        return list(pages)

    def free(self, seq_id):
        """Return a finished/evicted sequence's pages to the free list."""
        pages = self._tables.pop(seq_id)
        self._free.extend(reversed(pages))
        self.frees += len(pages)
        return len(pages)

    def pages_of(self, seq_id):
        return list(self._tables[seq_id])

    # -------------------------------------------------------- programs

    def page_table_rows(self, seq_ids, width):
        """Dense int32 page-table rows for a batch: (len(seq_ids), width)
        as nested lists, unused slots pointing at the null page. ``None``
        entries produce all-null rows (inactive batch-bin padding)."""
        rows = []
        for sid in seq_ids:
            pages = [] if sid is None else self._tables[sid]
            if len(pages) > width:
                raise ValueError(
                    f"sequence {sid!r} holds {len(pages)} pages > "
                    f"table width {width}")
            rows.append(list(pages) + [0] * (width - len(pages)))
        return rows

    def stats(self):
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "free_pages": self.free_pages,
            "used_pages": self.used_pages,
            "active_sequences": self.active_sequences,
            "utilization": self.used_pages / max(self.num_pages - 1, 1),
            "allocs": self.allocs,
            "frees": self.frees,
        }

    # ---------------------------------------------------------- defrag

    def defrag(self):
        """Renumber live pages onto the low end of the pool.

        Long churn walks allocations up the pool even when utilization
        is low (the LIFO free list fights this but cannot win against
        long-lived sequences). Compaction maps the k-th live page to
        physical page k+1 and rewrites every table; the caller
        (serve/engine.py:ServeEngine.defrag) applies the returned
        ``moves`` — a {src: dst} dict — to the device pools with one
        gather per side. Returns the moves ({} when already compact)."""
        live = sorted(p for pages in self._tables.values() for p in pages)
        mapping = {src: dst + 1 for dst, src in enumerate(live)}
        moves = {s: d for s, d in mapping.items() if s != d}
        if not moves:
            return {}
        for pages in self._tables.values():
            pages[:] = [mapping[p] for p in pages]
        n_live = len(live)
        self._free = list(range(self.num_pages - 1, n_live, -1))
        return moves
