"""Serving with a decode's parked rows inert, and without, on one card.

    python3 tools/parked_rows_ab.py        # from the root of a checkout

A stack with SSM or MoE layers keeps the parked rows of its dense serving
cache inert (``repro_torch.core.lowering.parked_rows_matter``): before a
decode they are zeroed by one foreach launch per dtype, and a slot
admitted in the round takes its prefilled caches after its group's
decode. This probe measures what that costs end to end, at full width and
depth, in ``chip_smoke.py``'s serve geometry and 12 requests (2 groups of
4 slots, prompts of 64-512 tokens, 8-48 new tokens), bf16:

* mamba2-370m, all 48 SSM layers;
* deepseek-v2-lite-16b, all 27 layers (MLA, MoE of 64 routed experts).

For each, two monolithic sessions on the same weights: ``inert`` as the
port serves, and ``live``, the same with every stage's ``slot_rows``
taken away before its first run, so its dense cache writes a prefill at
once and runs the parked rows' decode over whatever they hold. They
generate the requests alternately, I L L I I L L I: tok/s, and ms a
decode item and a prefill (each item ends in a device sync, so these are
wall times). Whether the two sessions' tokens agree is printed too: for
an SSM stack they need not (that is the fault the inert rows repair).

Prints the card's name and power limit first. Needs a card; imports
nothing of jax.
"""
from __future__ import annotations

import gc
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

ARCHS = ("mamba2-370m", cs.DEEPSEEK)
GEO = dict(num_groups=2, group_size=4, max_prompt_len=512, max_new_tokens=48,
           seed=cs.SEED)


def run(name: str, sess, requests):
    before = dict(sess.executor.item_seconds)
    out = sess.generate(requests)
    st = sess.last_stats
    sec = sess.executor.item_seconds
    per = {k: (sec[k] - before[k]) * 1e3 / st[f"{k}_items"]
           for k in ("decode", "prefill")}
    print(f"{name}: {st['tokens']} tokens, {st['wall_s']:.3f} s, "
          f"{st['tok_per_s']:.2f} tok/s, ms a decode item "
          f"{per['decode']:.2f}, a prefill {per['prefill']:.2f} "
          f"({st['decode_items']} decode items)", flush=True)
    return out, st["tok_per_s"], per["decode"]


def ab(arch: str, dev: str) -> None:
    cfg, model = cs.seeded_model(arch, dev)
    print(f"== {arch}: {cfg.num_layers} layers, full width, bf16, "
          "monolithic", flush=True)
    requests = cs.serve_requests(cfg)
    inert = cs.compile_serve(cfg, model, "monolithic", **GEO)
    live = cs.compile_serve(cfg, model, "monolithic", **GEO)
    for cache in live.executor.stage_caches:
        if cache.stage.slot_rows is None:
            raise AssertionError(f"{arch}: its stages keep no parked rows "
                                 "inert")
        cache.stage.slot_rows = None
    got = {"inert": [], "live": []}
    outs = {}
    for i, key in enumerate("ILLIILLI"):
        name = "inert" if key == "I" else "live"
        outs[name], tps, dec = run(f"{i} {name}", inert if key == "I"
                                   else live, requests)
        got[name].append((tps, dec))
    for name, vals in got.items():
        tps = [v[0] for v in vals]
        dec = [v[1] for v in vals]
        print(f"{arch} {name}: tok/s {tps} (median {np.median(tps):.2f}), "
              f"ms a decode item {[round(d, 2) for d in dec]} (median "
              f"{np.median(dec):.2f})")
    same = all(np.array_equal(a, b)
               for a, b in zip(outs["inert"], outs["live"]))
    print(f"{arch}: inert and live tokens identical: {same}")
    cs.closed(inert)
    cs.closed(live)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("parked_rows_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.device_and_build()
    for arch in ARCHS:
        ab(arch, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
