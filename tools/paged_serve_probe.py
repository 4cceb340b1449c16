"""Dense against paged qwen3-1.7b serving on one card, in one process.

    python3 tools/paged_serve_probe.py        # from the root of a checkout

``chip_smoke.py``'s paged phase runs dense and then paged sessions in a
fixed order, each freshly built, so its tok/s mixes the paged path's cost
with the order of the runs and the host's spread. This probe separates
them, with the phase's model (qwen3-1.7b at full width, bf16, seeded
init), requests (15, three repeating a prompt) and geometry (8 slots,
cache_len 576, 144 pages of 16):

1. one dense and one paged monolithic session, generating the requests
   alternately, D P P D D P P D: tok/s, and ms a decode item and a prefill
   (each item ends in a device sync, so these are wall times);
2. one decode item's pieces on 4 live slots, 20 calls each after a warm
   call, timed with a sync after the last: the dense decode, the paged
   gather, the decode on the gathered window and the paged scatter, then
   the gather and the scatter without the sync (their host time).

Prints the card's name and power limit first. Needs a card; imports
nothing of jax.
"""
from __future__ import annotations

import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def ms_per_call(fn, n: int = 20, sync: bool = True) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if sync:
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return dt


def alternate(dense, paged, requests) -> None:
    for i, sess in enumerate((dense, paged, paged, dense,
                              dense, paged, paged, dense)):
        before = dict(sess.executor.item_seconds)
        sess.generate(requests)
        st = sess.last_stats
        sec = sess.executor.item_seconds
        per = {k: (sec[k] - before[k]) * 1e3 / st[f"{k}_items"]
               for k in ("decode", "prefill")}
        print(f"{i} {sess.cache}: {st['wall_s']:.3f} s, "
              f"{st['tok_per_s']:.2f} tok/s, ms a decode item "
              f"{per['decode']:.2f}, a prefill {per['prefill']:.2f}",
              flush=True)


def decode_item_pieces(dense, paged) -> None:
    dc = dense.executor.stage_caches[0]
    pc = paged.executor.stage_caches[0]
    st = dc.stage
    dev = st.device
    tok = torch.zeros(4, dtype=torch.int32, device=dev)
    pos = torch.tensor([100, 200, 300, 400], dtype=torch.int32, device=dev)
    rows = torch.arange(4 * pc.spec.pages_per_req, dtype=torch.int32,
                        device=dev).view(4, -1)
    sids = torch.arange(4, dtype=torch.int32, device=dev)
    ops = pc._fns
    with torch.inference_mode():
        win = ops["gather"](pc.slabs, rows, sids)
        res = {
            "dense decode": ms_per_call(
                lambda: st.decode(st.params, dc.caches[0], tok, pos)),
            "paged gather": ms_per_call(
                lambda: ops["gather"](pc.slabs, rows, sids)),
            "decode on the gathered window": ms_per_call(
                lambda: st.decode(st.params, win, tok, pos)),
            "paged scatter_decode": ms_per_call(
                lambda: ops["scatter_decode"](pc.slabs, rows, sids, pos,
                                              win)),
            "gather, host only": ms_per_call(
                lambda: ops["gather"](pc.slabs, rows, sids), sync=False),
            "scatter_decode, host only": ms_per_call(
                lambda: ops["scatter_decode"](pc.slabs, rows, sids, pos,
                                              win), sync=False),
        }
    for k, v in res.items():
        print(f"{k}: {v:.3f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_serve_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.device_and_build()
    cfg, model = cs.seeded_model("qwen3-1.7b", "cuda")
    requests = cs.serve_requests(cfg)
    donor = max(range(len(requests)), key=lambda i: requests[i][1])
    requests += [(requests[donor][0], g) for g in (8, 12, 16)]
    dense = cs.compile_serve(cfg, model, "monolithic", **cs.PAGED_GEO)
    paged = cs.compile_serve(cfg, model, "monolithic", **cs.PAGED_GEO,
                             **cs.PAGED)
    alternate(dense, paged, requests)
    decode_item_pieces(dense, paged)
    return 0


if __name__ == "__main__":
    sys.exit(main())
