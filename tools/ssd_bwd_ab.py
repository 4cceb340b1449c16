"""The SSD scan's backward and the mamba2 train step, two checkouts on one card.

    python3 tools/ssd_bwd_ab.py OTHER_ROOT [--label NAME] [--logs DIR]

From OTHER_ROOT (for example a ``git archive`` of the parent commit) and
from this checkout, each in a process of its own that builds its own
kernels, in the order OTHER, this, this, OTHER (clocks that drift over the
run fall on both alike), it runs:

* ``chip_smoke.py``'s ``check_ssd_scan_bwd`` (the backward at mamba2-370m's
  training layer, x (2, 2048, 32, 64) bf16, held to its plain version and
  timed), and keeps the row it returns;
* mamba2-370m at full depth through ``make_train_step`` with ZeRO (as
  ``chip_smoke.py``'s ``train_mamba``): ``TRAIN_STEPS`` steps of
  ``TRAIN_B`` x ``TRAIN_S`` tokens, each timed, then one step under
  ``torch.profiler`` for the device's busy time.

Each run writes its numbers to ``DIR/ssd_bwd_ab_<n>.json`` and its output
to ``DIR/ssd_bwd_ab_<n>.log`` (default ``build/ssd_bwd_ab``); one JSON line
a run gives the backward's time and its kernels', the step walls after the
first, and the profiled step's device busy time and idle share. Needs one
card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.common import MeshPlan
from repro_torch.train.steps import make_train_step

cs.device_and_build()
row = cs.check_ssd_scan_bwd("cuda")
cfg = get_config(cs.MAMBA)
ts = make_train_step(cfg, MeshPlan(("data", "model"), (1, 1)), zero=True,
                     device="cuda")
params = ts.init_params(cs.SEED)
opt = ts.init_opt(params)
src = SyntheticLM(cfg.vocab_size, cs.TRAIN_B, cs.TRAIN_S, seed=cs.SEED)
walls = []
for step in range(cs.TRAIN_STEPS):
    t = time.perf_counter()
    params, opt, m = ts.step_fn(params, opt, {{"tokens": src(step)}})
    float(m["loss"])
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t)
batch = {{"tokens": src(cs.TRAIN_STEPS)}}
with profile(activities=[ProfilerActivity.CUDA, ProfilerActivity.CPU]) as p:
    t = time.perf_counter()
    float(ts.step_fn(params, opt, batch)[2]["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
busy = sum(e.self_device_time_total for e in p.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
with open({out!r}, "w") as f:
    json.dump({{**{{k: row[k] for k in ("ms", "wrapper_ms", "plain_ms",
                                       "bound_ms", "ms_by_kernel")}},
               "step_walls_s": walls[1:], "busy_s": busy,
               "idle_share": 1 - busy / wall}}, f)
"""


def run(root: str, log: str, out: str) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", RUN.format(root=root, out=out)], cwd=root,
        capture_output=True, text=True, timeout=900)
    with open(log, "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: exit {proc.returncode}; see {log}")
    with open(out) as f:
        return json.load(f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other_root")
    ap.add_argument("--label", default="other")
    ap.add_argument("--logs", default=os.path.join(HERE, "build",
                                                   "ssd_bwd_ab"))
    args = ap.parse_args()
    other = os.path.abspath(args.other_root)
    logs = os.path.abspath(args.logs)
    os.makedirs(logs, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    for n, (label, root) in enumerate(((args.label, other), ("this", HERE),
                                       ("this", HERE), (args.label, other))):
        got = run(root, os.path.join(logs, f"ssd_bwd_ab_{n}.log"),
                  os.path.join(logs, f"ssd_bwd_ab_{n}.json"))
        print(json.dumps({"run": n, "tree": label, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
