"""Continuous-batching admission scheduling (dense cache).

Port of the dense path of ``repro/serve/admission.py:31-273``:
:class:`AdmissionScheduler` owns the slot table, the FIFO admission queue
and the per-request cursors, and each round emits the work-item list that
the engines (inline or actor pipeline) execute — same items, same order as
the reference. The page pool, shared prefixes and chunked prefill wait
(ROADMAP Queue 1 item 1).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.runtime.pipeline import DecodeWork, PrefillWork


class AdmissionScheduler:
    """Plan rounds of serve work items and absorb their tokens.

    Drive it as::

        while not sched.done():
            work, meta = sched.plan_round()
            results = engine.run_round(work)
            for m, toks in zip(meta, tokens_of(results)):
                sched.absorb(m, toks)

    ``prompts`` are validated int32 numpy arrays, ``gens`` the per-request
    new-token budgets. Work tensors are made on ``device``. Retired and
    empty slots are *parked*: they decode token 0 at the reserved position
    ``cache_len - 1``, which no live request's window reaches, so a group
    keeps one fixed shape.
    """

    def __init__(self, prompts, gens, *, num_groups: int, group_size: int,
                 cache_len: int, device=None):
        self.prompts = list(prompts)
        self.gens = [int(g) for g in gens]
        self.num_groups = num_groups
        self.group_size = group_size
        self.cache_len = cache_len
        self.device = device
        self.park = cache_len - 1          # never inside a live window
        self.queue: List[int] = list(range(len(self.prompts)))
        self.slots: List[List[Optional[Dict[str, Any]]]] = [
            [None] * group_size for _ in range(num_groups)]
        self.outputs: List[List[int]] = [[] for _ in self.prompts]
        self.admitted_mid_flight = 0
        self.prefill_items = 0
        self.decode_items = 0
        self._first_round = True

    def done(self) -> bool:
        return not self.queue and all(
            st is None for grp in self.slots for st in grp)

    def _tensor(self, values) -> torch.Tensor:
        return torch.as_tensor(values, dtype=torch.int32, device=self.device)

    # -- round planning ----------------------------------------------------

    def plan_round(self) -> Tuple[List[Any], List[Tuple]]:
        """One round: admissions for empty slots (FIFO), then one decode
        item per group with live slots. Returns ``(work, meta)``; meta
        tuples are ``("prefill", g, b)`` and ``("decode", g, live_slots)``."""
        work: List[Any] = []
        meta: List[Tuple] = []
        for g in range(self.num_groups):
            for b in range(self.group_size):
                if self.slots[g][b] is None and self.queue:
                    self._admit(g, b, work, meta)
            live = [b for b in range(self.group_size)
                    if self.slots[g][b] is not None
                    and self.slots[g][b]["pos"] is not None]
            if live:
                tok = [self.slots[g][b]["tok"] if b in live else 0
                       for b in range(self.group_size)]
                pos = [self.slots[g][b]["pos"] if b in live else self.park
                       for b in range(self.group_size)]
                work.append(DecodeWork(group=g, tok=self._tensor(tok),
                                       pos=self._tensor(pos)))
                meta.append(("decode", g, live))
                self.decode_items += 1
        self._first_round = False
        return work, meta

    def _admit(self, g: int, b: int, work, meta) -> None:
        """Admit the queue head into slot ``(g, b)`` with a prefill of its
        prompt at its natural length: no padding, which would flow through
        an SSM layer's recurrence and conv state (attention caches are
        positional, SSM state is not)."""
        r = self.queue.pop(0)
        toks = self.prompts[r]
        if not self._first_round:
            self.admitted_mid_flight += 1
        work.append(PrefillWork(group=g, slot=b,
                                tokens=self._tensor(toks[None]),
                                last_index=toks.size - 1))
        meta.append(("prefill", g, b))
        self.prefill_items += 1
        self.slots[g][b] = {"req": r, "pos": None, "tok": 0,
                            "remaining": self.gens[r]}

    # -- result absorption ---------------------------------------------------

    def absorb(self, m: Tuple, toks) -> None:
        """Fold one work item's token vector back into the slot table."""
        if m[0] == "prefill":
            _, g, b = m
            self._emit(g, b, int(toks[0]),
                       self.prompts[self.slots[g][b]["req"]].size)
        else:
            _, g, live = m
            for b in live:
                st = self.slots[g][b]
                self._emit(g, b, int(toks[b]), st["pos"] + 1)

    def _emit(self, g: int, b: int, tok: int, next_pos: int) -> None:
        """Record one generated token for slot ``(g, b)``; retire the slot
        when its budget is spent, otherwise advance its cursor."""
        st = self.slots[g][b]
        self.outputs[st["req"]].append(tok)
        st["remaining"] -= 1
        if st["remaining"] == 0:
            self.slots[g][b] = None
            return
        st["pos"] = next_pos
        st["tok"] = tok
