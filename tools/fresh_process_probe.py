"""The first steps of the qwen3-width graph in a fresh process, on one card.

    python3 tools/fresh_process_probe.py threads      # from a checkout's root
    python3 tools/fresh_process_probe.py processes

``chip_smoke.py``'s graph phases run in a driver that has already run
every kernel of the path, so their first steps are as fast as the later
ones. A worker process of ``runtime="processes"`` starts cold: it pays the
first use of every kernel it launches in its first epoch. Run in a fresh
interpreter, this probe compiles phase 9c's configuration (the
qwen3-width graph, 722,993,152 float32 params, 4 stages, 8 microbatches
of 512 rows, ZeRO, bf16, dynamic loss scale, 1F1B) on the given runtime
and prints each of 3 steps' wall (ending in a read of the loss) with its
4 longest actor fires, so the first step's cost and where it sits show.
Prints the card's name and power limit first. Needs a card; imports
nothing of jax.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(runtime: str) -> None:
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.core.lowering import OptimizerSpec

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = "cuda"
    g = cs.qwen3_width_graph()
    params, data = cs.seeded_graph_inputs(g, cs.SEED + 9)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
    t = time.perf_counter()
    sess = api.compile(g, mode="train", params=params,
                       num_microbatches=cs.GRAPH_M,
                       optimizer=OptimizerSpec.adamw(lr=3e-4, grad_clip=1.0),
                       device=dev, zero=True, precision="bf16",
                       loss_scale="dynamic", stages=cs.GRAPH_STAGES,
                       regs="1f1b", runtime=runtime)
    if runtime == "processes":
        sess.executor.runtime           # start the workers
    print(f"{runtime}: compiled (workers started) in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    try:
        for k in range(3):
            t = time.perf_counter()
            loss = float(sess.step(**batch).loss)
            wall = time.perf_counter() - t
            longest = sorted(((e - b, a) for a, spans in
                              sess.executor.last_history.items()
                              for b, e in spans), reverse=True)[:4]
            print(f"{runtime} step {k + 1}: {wall:.3f} s, loss {loss:.6f}; "
                  "longest fires " + ", ".join(
                      f"{a} {d:.2f} s" for d, a in longest), flush=True)
    finally:
        sess.close()


if __name__ == "__main__":
    if len(sys.argv) != 2 or sys.argv[1] not in ("threads", "processes"):
        sys.exit("usage: fresh_process_probe.py threads|processes")
    main(sys.argv[1])
