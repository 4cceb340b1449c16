"""Paged KV/SSM cache pool: the thin-stack trick applied to serving state.

Port of ``repro/serve/paged_cache.py``. The dense serve path holds one
``(group_size, cache_len, ...)`` cache block per slot group per stage, so a
request reserves its worst-case window for its whole lifetime. Here:

* **One page slab per stage layer and positional key.** GQA ``k``/``v``
  live in a fixed ``(num_pages, page_len, KV, D)`` slab, allocated once. A
  request's window is a sequence of pages named by an int32 **page table**
  row ``(pages_per_req,)``; entry ``-1`` means unmapped. Per-request state
  that is not positional (SSM ``h``, conv tails) lives in a
  ``(max_requests, ...)`` row pool indexed by slot id.
* **Host plans, device executes.** Page allocation, free and refcounting are
  numpy bookkeeping on the host (:class:`PagePool`); the stage only runs
  four fixed-shape index programs (:func:`_build_paged_ops`) that gather a
  slot group's windows into the dense layout the unchanged stage decode
  expects and scatter back what it wrote.
* **Identity with the dense path.** A gathered window agrees with the dense
  group cache at every position a live request's decode can observe:
  positions ``<= pos`` hold the same prefill and decode writes, positions
  past it are zero (the prefill scatter zeroes the rest of every page it
  maps, as the dense ``write_slot`` zeroes the rest of the slot) or masked.
  Unmapped pages gather as zeros; retired and parked slots carry slot id
  ``-1``, so their gathers read zeros and their scatters drop.
* **Shared-prefix pages are refcounted.** A new request that repeats a live
  request's page-aligned prompt prefix (equal prompt lengths, so both
  prefills are the same program, bit for bit) maps the owner's pages; its
  prefill scatter masks those entries, so the owner is never written.

Torch indexing has no out-of-bounds fill or drop, which the reference's
``jnp.take(mode="fill")`` and ``.at[].set(mode="drop")`` give. So every
stored slab has two sentinel rows past its pages (and every row pool two
past its slots): row ``n`` stays zero and is what an unmapped entry reads,
row ``n + 1`` takes the writes an unmapped entry drops and is never read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

#: cache leaves whose axis after the batch axis is the cache *position*:
#: these are paged. Everything else (``h``, ``tail_x``, ``tail_bc``) is
#: whole-request state and lives in the per-slot row pool.
POSITIONAL_KEYS = frozenset({"k", "v", "c", "kpe", "pos"})


@dataclasses.dataclass(frozen=True)
class PagedCacheSpec:
    """The paged-pool geometry."""

    page_len: int
    num_pages: int
    max_requests: int                 # num_groups * group_size slot ids
    pages_per_req: int                # cache_len // page_len

    def __post_init__(self):
        for name in ("page_len", "num_pages", "max_requests",
                     "pages_per_req"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")

    @property
    def cache_len(self) -> int:
        return self.page_len * self.pages_per_req

    def pages_needed(self, need_len: int) -> int:
        """Pages covering ``need_len`` cache positions."""
        return max(1, math.ceil(need_len / self.page_len))


def _slab_shape(key: str, dense_shape: Sequence[int],
                spec: PagedCacheSpec) -> Tuple[int, ...]:
    """One layer's dense group-cache leaf shape -> its slab or pool shape:
    positional ``(B, L, *f)`` -> ``(num_pages, page_len, *f)``, state
    ``(B, *f)`` -> ``(max_requests, *f)``."""
    if key in POSITIONAL_KEYS:
        return (spec.num_pages, spec.page_len) + tuple(dense_shape[2:])
    return (spec.max_requests,) + tuple(dense_shape[1:])


def _leaf_bytes(shape: Sequence[int], dtype: torch.dtype) -> int:
    return math.prod(int(d) for d in shape) * dtype.itemsize


def slab_bytes(template: List[Dict[str, torch.Tensor]],
               spec: PagedCacheSpec) -> int:
    """Persistent paged-pool bytes for one stage, from its dense group-cache
    template (one dict per layer; meta tensors will do): page slabs for
    positional leaves, row pools for state leaves, plus the page table and
    cursor tensors (the reference's count; the two sentinel rows of each
    slab are not counted)."""
    total = sum(_leaf_bytes(_slab_shape(k, leaf.shape, spec), leaf.dtype)
                for layer in template for k, leaf in layer.items())
    total += spec.max_requests * spec.pages_per_req * 4   # page table int32
    total += spec.max_requests * 2 * 4                    # cursors + lengths
    return total


def dense_bytes(template: List[Dict[str, torch.Tensor]],
                num_groups: int) -> int:
    """Persistent dense-cache bytes for one stage: one group cache block per
    slot group."""
    return num_groups * sum(_leaf_bytes(leaf.shape, leaf.dtype)
                            for layer in template for leaf in layer.values())


class PagePool:
    """Host-side page bookkeeping: the page table, the free stack and the
    per-page refcounts. Pure numpy: the device only ever sees table *rows*
    shipped inside work items."""

    def __init__(self, spec: PagedCacheSpec):
        self.spec = spec
        self.page_table = np.full(
            (spec.max_requests, spec.pages_per_req), -1, np.int32)
        self.ref_counts = np.zeros((spec.num_pages,), np.int32)
        self.req_len = np.zeros((spec.max_requests,), np.int32)
        self._free: List[int] = list(range(spec.num_pages - 1, -1, -1))
        self.peak_pages = 0

    def free_count(self) -> int:
        return len(self._free)

    def used_pages(self) -> int:
        return self.spec.num_pages - len(self._free)

    def alloc(self, sid: int, n_own: int, shared: Sequence[int] = ()):
        """Map slot ``sid``: ``shared`` page ids first (refcounted, owned by
        another live request) then ``n_own`` fresh pages. Returns the int32
        *write row*: the full row with the shared entries masked to ``-1``,
        so the admission prefill scatter never touches the owner's pages."""
        spec = self.spec
        if not (0 <= sid < spec.max_requests):
            raise ValueError(f"slot id {sid} outside [0, {spec.max_requests})")
        if (self.page_table[sid] >= 0).any():
            raise ValueError(f"slot id {sid} is already mapped; free it first")
        n_shared = len(shared)
        if n_shared + n_own > spec.pages_per_req:
            raise ValueError(
                f"request needs {n_shared + n_own} pages but pages_per_req="
                f"{spec.pages_per_req} (cache_len / page_len)")
        if n_own > len(self._free):
            raise ValueError(
                f"page pool exhausted: need {n_own} pages, {len(self._free)} "
                f"free of {spec.num_pages}")
        row = np.full((spec.pages_per_req,), -1, np.int32)
        write_row = row.copy()
        for i, p in enumerate(shared):
            if self.ref_counts[p] < 1:
                raise ValueError(f"cannot share unreferenced page {p}")
            row[i] = p
            self.ref_counts[p] += 1
        for i in range(n_own):
            p = self._free.pop()
            row[n_shared + i] = p
            write_row[n_shared + i] = p
            self.ref_counts[p] = 1
        self.page_table[sid] = row
        self.req_len[sid] = 0
        self.peak_pages = max(self.peak_pages, self.used_pages())
        return write_row

    def free(self, sid: int) -> None:
        """Unmap slot ``sid``; pages return to the free stack when their
        refcount hits zero (shared-prefix pages outlive their allocator)."""
        for p in self.page_table[sid]:
            p = int(p)
            if p < 0:
                continue
            self.ref_counts[p] -= 1
            if self.ref_counts[p] == 0:
                self._free.append(p)
            elif self.ref_counts[p] < 0:
                raise AssertionError(f"page {p} refcount underflow")
        self.page_table[sid] = -1
        self.req_len[sid] = 0

    def row(self, sid: int):
        return np.array(self.page_table[sid], np.int32)

    def rows(self, sids: Sequence[int]):
        """Stack table rows for a slot group; ``sid < 0`` (parked) rows are
        all ``-1`` so their gathers read zeros and their scatters drop."""
        out = np.full((len(sids), self.spec.pages_per_req), -1, np.int32)
        for i, sid in enumerate(sids):
            if sid >= 0:
                out[i] = self.page_table[sid]
        return out


class PagedStageCache:
    """One stage's paged serving state: a page slab or row pool per layer
    and key (each with its two sentinel rows), and the four index programs
    that bridge them to the unchanged dense stage programs. Allocated the
    first time work reaches the stage, on the stage's device."""

    def __init__(self, stage, group_size: int, cache_len: int,
                 spec: PagedCacheSpec):
        if spec.cache_len != cache_len:
            raise ValueError(
                f"page_len={spec.page_len} * pages_per_req="
                f"{spec.pages_per_req} = {spec.cache_len} must equal "
                f"cache_len={cache_len}")
        self.stage = stage
        self.group_size = group_size
        self.cache_len = cache_len
        self.spec = spec
        self.slabs = None
        self._fns = None

    def _ensure(self) -> None:
        if self.slabs is not None:
            return
        template = self.stage.init_caches(self.group_size, device="meta")
        self.slabs = [
            {k: torch.zeros(_stored_shape(k, leaf.shape, self.spec),
                            dtype=leaf.dtype, device=self.stage.device)
             for k, leaf in layer.items()} for layer in template]
        self._fns = _build_paged_ops(self.spec, self.group_size,
                                     self.cache_len, self.stage.device)

    def pages(self) -> List[Dict[str, torch.Tensor]]:
        """Views of the slabs and row pools in their slab shape (no sentinel
        rows): ``(num_pages, page_len, ...)`` or ``(max_requests, ...)``."""
        self._ensure()
        return [{k: _pages_view(k, t, self.spec) for k, t in layer.items()}
                for layer in self.slabs]

    # -- the three work kinds ---------------------------------------------

    def run_decode(self, work, xin):
        """Gather the group's windows, run the unchanged dense decode
        program on them, scatter back the one position each live slot
        wrote (plus the whole per-request state rows)."""
        self._ensure()
        window = self._fns["gather"](self.slabs, work.rows, work.sids)
        xout, window = self.stage.decode(self.stage.params, window, xin,
                                         work.pos)
        self._fns["scatter_decode"](self.slabs, work.rows, work.sids,
                                    work.pos, window)
        return xout

    def write_prefill(self, work, slot_caches) -> None:
        """Scatter a freshly prefilled request into its mapped pages.
        ``work.row`` is the *write* row: shared-prefix entries are ``-1``,
        so the prefix owner's pages are read-only."""
        self._ensure()
        self._fns["scatter_prefill"](self.slabs, work.row, work.sid,
                                     slot_caches)

    def run_chunk(self, work, xin):
        """One chunked-prefill step: gather (state rows read via
        ``sids_in``, ``-1`` on the first chunk so recurrent state starts
        from exact zeros), run the stage's loop-of-decode chunk program,
        scatter the chunk's positions and the final state row back."""
        self._ensure()
        window = self._fns["gather"](self.slabs, work.rows, work.sids_in)
        xout, window = self.stage.chunk(self.stage.params, window, xin,
                                        work.pos0, work.adv)
        self._fns["scatter_chunk"](int(work.toks.shape[0]), self.slabs,
                                   work.rows, work.sids_out, work.pos0,
                                   work.adv, window)
        return xout


def _stored_shape(key: str, dense_shape, spec: PagedCacheSpec):
    """The stored tensor: pages flattened to rows, then the two sentinel
    rows (zero, trash)."""
    shape = _slab_shape(key, dense_shape, spec)
    if key in POSITIONAL_KEYS:
        return (shape[0] * shape[1] + 2,) + shape[2:]
    return (shape[0] + 2,) + shape[1:]


def _pages_view(key: str, stored: torch.Tensor, spec: PagedCacheSpec):
    if key in POSITIONAL_KEYS:
        total = spec.num_pages * spec.page_len
        return stored[:total].view((spec.num_pages, spec.page_len)
                                   + tuple(stored.shape[1:]))
    return stored[:spec.max_requests]


def _build_paged_ops(spec: PagedCacheSpec, group_size: int, cache_len: int,
                     device) -> Dict[str, object]:
    """The four fixed-shape index programs of one stage (reference
    ``_build_paged_ops``), as torch index ops on ``device``.

    Cache position ``pos`` of the slot with table row ``row`` lives at flat
    slab row ``row[pos // page_len] * page_len + pos % page_len``. An
    unmapped entry (``-1``) or parked slot (``sid < 0``) reads the zero
    sentinel row and writes the trash row. The scatters update the slabs in
    place; ``rows``, ``sids``, ``pos``, ``pos0`` and ``adv`` are int32
    tensors on ``device``."""
    B, L, pl = group_size, cache_len, spec.page_len
    total = spec.num_pages * pl
    mr = spec.max_requests
    zero_row, trash_row = total, total + 1
    zero_sid, trash_sid = mr, mr + 1
    pos = torch.arange(L, device=device)
    pos_page, pos_off = pos // pl, pos % pl
    b_idx = torch.arange(B, device=device)

    def gather(slabs, rows, sids):
        page = rows.long()[:, pos_page]                    # (B, L)
        phys = torch.where(page >= 0, page * pl + pos_off, zero_row)
        phys = phys.reshape(-1)
        sid_idx = torch.where(sids >= 0, sids, zero_sid).long()
        window = []
        for layer in slabs:
            win = {}
            for k, slab in layer.items():
                if k in POSITIONAL_KEYS:
                    win[k] = slab.index_select(0, phys).view(
                        (B, L) + tuple(slab.shape[1:]))
                else:
                    win[k] = slab.index_select(0, sid_idx)
            window.append(win)
        return window

    def _scatter_state(slab, sids, value) -> None:
        sid_idx = torch.where(sids >= 0, sids, trash_sid).long()
        slab.index_copy_(0, sid_idx, value.to(slab.dtype))

    def scatter_decode(slabs, rows, sids, pos_b, window) -> None:
        pos_b = pos_b.long()
        page = rows.long()[b_idx, pos_b // pl]             # (B,)
        ok = (page >= 0) & (sids >= 0)
        phys = torch.where(ok, page * pl + pos_b % pl, trash_row)
        for layer, win in zip(slabs, window):
            for k, slab in layer.items():
                if k in POSITIONAL_KEYS:
                    slab.index_copy_(0, phys,
                                     win[k][b_idx, pos_b].to(slab.dtype))
                else:
                    _scatter_state(slab, sids, win[k])

    def scatter_prefill(slabs, write_row, sid: int, slot_caches) -> None:
        # the port's prefill caches hold the prompt's S positions: every
        # mapped position past them is written with zeros, so a recycled
        # page never shows an older request's values
        page = write_row.long()[pos_page]                  # (L,)
        phys = torch.where(page >= 0, page * pl + pos_off, trash_row)
        sids = torch.full((1,), sid, dtype=torch.int32, device=device)
        for layer, sc in zip(slabs, slot_caches):
            for k, slab in layer.items():
                src = sc[k]
                if k in POSITIONAL_KEYS:
                    val = torch.zeros((L,) + tuple(slab.shape[1:]),
                                      dtype=slab.dtype, device=device)
                    val[:src.shape[1]] = src[0]
                    slab.index_copy_(0, phys, val)
                    continue
                if tuple(src.shape[1:]) != tuple(slab.shape[1:]):
                    raise ValueError(
                        f"scatter_prefill: the prefilled {k!r} has shape "
                        f"{tuple(src.shape[1:])}, a slot holds "
                        f"{tuple(slab.shape[1:])}: an SSM layer needs a "
                        "prompt of at least ssm_d_conv - 1 tokens for its "
                        "conv tails")
                _scatter_state(slab, sids, src)

    def scatter_chunk(T: int, slabs, rows, sids, pos0, adv, window) -> None:
        steps = torch.arange(T, device=device)
        pos_m = pos0.long()[:, None] + steps[None, :] * adv.long()[:, None]
        page = torch.gather(rows.long(), 1, pos_m // pl)   # (B, T)
        ok = (page >= 0) & (sids >= 0)[:, None]
        phys = torch.where(ok, page * pl + pos_m % pl, trash_row).reshape(-1)
        for layer, win in zip(slabs, window):
            for k, slab in layer.items():
                if k in POSITIONAL_KEYS:
                    val = win[k][b_idx[:, None], pos_m]    # (B, T, *f)
                    slab.index_copy_(0, phys, val.reshape(
                        (B * T,) + tuple(slab.shape[1:])).to(slab.dtype))
                else:
                    _scatter_state(slab, sids, win[k])

    return {"gather": gather, "scatter_decode": scatter_decode,
            "scatter_prefill": scatter_prefill,
            "scatter_chunk": scatter_chunk}
