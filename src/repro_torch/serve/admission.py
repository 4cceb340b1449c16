"""Continuous-batching admission scheduling, including chunked prefill.

Port of ``repro/serve/admission.py:31-273``: :class:`AdmissionScheduler`
owns the slot table, the FIFO admission queue and the per-request cursors,
and each round emits the work-item list that the engines (inline or actor
pipeline) execute -- same items, same order as the reference.

Under ``cache="paged"`` it also owns the :class:`PagePool` handshake:
admission allocates a request's worst-case page budget (``prompt_len +
max_new_tokens - 1`` positions) up front, shares page-aligned common
prefixes with live equal-length requests, applies backpressure (the queue
head waits, in order) when the pool is short, and frees pages at
retirement.

**Chunked prefill** (paged only, ``prefill_chunk=``): a prompt longer than
the chunk budget is admitted as a sequence of bounded
:class:`~repro_torch.runtime.pipeline.PrefillChunkWork` items, one per
round, interleaved with every group's decode work, so a long prompt never
blocks decoding. Each chunk drives the stage's loop-of-decode program over
at most ``prefill_chunk`` positions; recurrent state persists between
chunks in the request's pool row (read via ``sids_in``, ``-1`` on the first
chunk so SSM/conv state starts from exact zeros), and the final chunk's
last-position logits produce the request's first token.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime.pipeline import (DecodeWork, PrefillChunkWork,
                                          PrefillWork)


class AdmissionScheduler:
    """Plan rounds of serve work items and absorb their tokens.

    Drive it as::

        while not sched.done():
            work, meta = sched.plan_round()
            results = engine.run_round(work)
            for m, toks in zip(meta, tokens_of(results)):
                sched.absorb(m, toks)

    ``prompts`` are validated int32 numpy arrays, ``gens`` the per-request
    new-token budgets. Work tensors (token ids, positions, page-table rows,
    slot ids) are made on ``device``, once per item. Retired and empty
    slots are *parked*: they decode token 0 at the reserved position
    ``cache_len - 1``, which no live request's window reaches, so a group
    keeps one fixed shape. ``pool`` (a
    :class:`repro_torch.serve.paged_cache.PagePool`) switches the paged
    admission path on; ``prefill_chunk`` and ``share_prefix`` require it.
    """

    def __init__(self, prompts, gens, *, num_groups: int, group_size: int,
                 cache_len: int, device=None, pool=None,
                 prefill_chunk: Optional[int] = None,
                 share_prefix: bool = False):
        if (prefill_chunk is not None or share_prefix) and pool is None:
            raise ValueError("prefill_chunk/share_prefix require a PagePool "
                             "(cache='paged')")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk={prefill_chunk} must be >= 1")
        self.prompts = list(prompts)
        self.gens = [int(g) for g in gens]
        self.num_groups = num_groups
        self.group_size = group_size
        self.cache_len = cache_len
        self.device = device
        self.park = cache_len - 1          # never inside a live window
        self.pool = pool
        self.prefill_chunk = prefill_chunk
        self.share_prefix = share_prefix
        self.queue: List[int] = list(range(len(self.prompts)))
        self.slots: List[List[Optional[Dict[str, Any]]]] = [
            [None] * group_size for _ in range(num_groups)]
        self.outputs: List[List[int]] = [[] for _ in self.prompts]
        self.admitted_mid_flight = 0
        self.shared_pages = 0
        self.prefill_items = 0
        self.decode_items = 0
        self.chunk_items = 0
        self.chunk_tokens = 0
        self._first_round = True
        # live, fully-prefilled requests eligible as prefix donors: req -> sid
        self._registry: Dict[int, int] = {}

    def done(self) -> bool:
        return not self.queue and all(
            st is None for grp in self.slots for st in grp)

    def _tensor(self, values) -> torch.Tensor:
        return torch.as_tensor(values, dtype=torch.int32, device=self.device)

    # -- round planning ----------------------------------------------------

    def plan_round(self) -> Tuple[List[Any], List[Tuple]]:
        """One round: admissions for empty slots (FIFO, with page
        backpressure), one chunk item per mid-chunk slot, then one decode
        item per group with live slots. Returns ``(work, meta)``; meta
        tuples are ``("prefill", g, b)``, ``("chunk", g, b, final)`` and
        ``("decode", g, live_slots)``."""
        work: List[Any] = []
        meta: List[Tuple] = []
        blocked = False                   # pool backpressure: head waits
        for g in range(self.num_groups):
            for b in range(self.group_size):
                if self.slots[g][b] is None and self.queue and not blocked:
                    blocked = not self._admit(g, b, work, meta)
                st = self.slots[g][b]
                if st is not None and st.get("chunk_off") is not None:
                    item = self._chunk_work(g, b)
                    work.append(item)
                    meta.append(("chunk", g, b, item.final))
            live = [b for b in range(self.group_size)
                    if self.slots[g][b] is not None
                    and self.slots[g][b]["pos"] is not None]
            if live:
                tok = [self.slots[g][b]["tok"] if b in live else 0
                       for b in range(self.group_size)]
                pos = [self.slots[g][b]["pos"] if b in live else self.park
                       for b in range(self.group_size)]
                kw = {}
                if self.pool is not None:
                    sids = [self.slots[g][b]["sid"] if b in live else -1
                            for b in range(self.group_size)]
                    kw = {"sids": self._tensor(sids),
                          "rows": self._tensor(self.pool.rows(sids))}
                parked = tuple(b for b in range(self.group_size)
                               if b not in live)
                work.append(DecodeWork(group=g, tok=self._tensor(tok),
                                       pos=self._tensor(pos), parked=parked,
                                       **kw))
                meta.append(("decode", g, live))
                self.decode_items += 1
        self._first_round = False
        if not work and not self.done():
            raise RuntimeError(
                "admission stalled: queued requests but no admissible work "
                "(page pool too small for the queue head?)")
        return work, meta

    def _admit(self, g: int, b: int, work, meta) -> bool:
        """Admit the queue head into slot ``(g, b)``; returns False when the
        page pool cannot cover it yet (FIFO backpressure). An unchunked
        prompt is prefilled at its natural length: no padding, which would
        flow through an SSM layer's recurrence and conv state (attention
        caches are positional, SSM state is not)."""
        r = self.queue[0]
        toks = self.prompts[r]
        st: Dict[str, Any] = {"req": r, "pos": None, "tok": 0,
                              "remaining": self.gens[r]}
        sid, row = -1, None
        chunked = (self.prefill_chunk is not None
                   and toks.size > self.prefill_chunk)
        if self.pool is not None:
            spec = self.pool.spec
            sid = g * self.group_size + b
            n_pages = spec.pages_needed(toks.size + max(0, self.gens[r] - 1))
            shared = []
            if self.share_prefix and not chunked:
                shared = self._prefix_pages(toks, spec.page_len)
            if self.pool.free_count() < n_pages - len(shared):
                return False
            row = self._tensor(
                self.pool.alloc(sid, n_pages - len(shared), shared))
            self.shared_pages += len(shared)
            st["sid"] = sid
        self.queue.pop(0)
        if not self._first_round:
            self.admitted_mid_flight += 1
        if chunked:
            st["chunk_off"] = 0            # emitted by the caller's loop
        else:
            work.append(PrefillWork(group=g, slot=b,
                                    tokens=self._tensor(toks[None]),
                                    last_index=toks.size - 1,
                                    sid=sid, row=row))
            meta.append(("prefill", g, b))
            self.prefill_items += 1
        self.slots[g][b] = st
        return True

    def _prefix_pages(self, toks, page_len: int) -> List[int]:
        """Whole pages of ``toks`` already held by a live, fully-prefilled
        request with the *same prompt length* (equal lengths run the same
        prefill program, so the shared positions are bitwise identical).
        Returns the donor's page ids for the common page-aligned prefix."""
        best: List[int] = []
        for r, sid in self._registry.items():
            other = self.prompts[r]
            if other.size != toks.size:
                continue
            ne = np.nonzero(other != toks)[0]
            common = int(ne[0]) if ne.size else toks.size
            n_sh = common // page_len
            if n_sh > len(best):
                best = [int(p) for p in self.pool.page_table[sid][:n_sh]]
        return best

    def _chunk_work(self, g: int, b: int) -> PrefillChunkWork:
        """One bounded prefill chunk for slot ``(g, b)``: the group-shaped
        item whose non-owner columns are parked no-ops (``adv == 0``, table
        row ``-1``) so the chunk program keeps the group's fixed shape."""
        st = self.slots[g][b]
        toks = self.prompts[st["req"]]
        off = st["chunk_off"]
        T = min(self.prefill_chunk, toks.size - off)
        B = self.group_size
        mat = np.zeros((T, B), np.int32)
        mat[:, b] = toks[off:off + T]
        pos0 = np.full((B,), self.park, np.int32)
        pos0[b] = off
        adv = np.zeros((B,), np.int32)
        adv[b] = 1
        sids_in = np.full((B,), -1, np.int32)
        if off > 0:                        # first chunk starts from zeros
            sids_in[b] = st["sid"]
        sids_out = np.full((B,), -1, np.int32)
        sids_out[b] = st["sid"]
        rows = np.full((B, self.pool.spec.pages_per_req), -1, np.int32)
        rows[b] = self.pool.row(st["sid"])
        self.chunk_items += 1
        self.chunk_tokens += T
        return PrefillChunkWork(
            group=g, slot=b, toks=self._tensor(mat), pos0=self._tensor(pos0),
            adv=self._tensor(adv), rows=self._tensor(rows),
            sids_in=self._tensor(sids_in), sids_out=self._tensor(sids_out),
            final=off + T == toks.size)

    # -- result absorption ---------------------------------------------------

    def absorb(self, m: Tuple, toks) -> None:
        """Fold one work item's token vector back into the slot table
        (``None`` for a non-final chunk, which produces no token)."""
        if m[0] == "prefill":
            _, g, b = m
            self._emit(g, b, int(toks[0]),
                       self.prompts[self.slots[g][b]["req"]].size)
        elif m[0] == "chunk":
            _, g, b, final = m
            st = self.slots[g][b]
            L = self.prompts[st["req"]].size
            if not final:
                st["chunk_off"] += min(self.prefill_chunk,
                                       L - st["chunk_off"])
                return
            st["chunk_off"] = None
            self._emit(g, b, int(toks[b]), L)
        else:
            _, g, live = m
            for b in live:
                st = self.slots[g][b]
                self._emit(g, b, int(toks[b]), st["pos"] + 1)

    def _emit(self, g: int, b: int, tok: int, next_pos: int) -> None:
        """Record one generated token for slot ``(g, b)``; retire the slot
        (freeing its pages) when its budget is spent, otherwise advance its
        cursor to ``next_pos``."""
        st = self.slots[g][b]
        self.outputs[st["req"]].append(tok)
        st["remaining"] -= 1
        if st["remaining"] == 0:
            if self.pool is not None:
                self.pool.free(st["sid"])
                self._registry.pop(st["req"], None)
            self.slots[g][b] = None
            return
        if st["pos"] is None and self.share_prefix and "chunk_off" not in st:
            # fully prefilled by the one-shot prefill program: eligible as a
            # prefix donor (chunk-built caches use different math, so
            # chunked requests never donate)
            self._registry[st["req"]] = st["sid"]
        st["pos"] = next_pos
        st["tok"] = tok
