"""Hold the port's training step to the JAX package's at qwen3-1.7b's full
width, over the first steps of training, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/loss_jump_parity.py

Both packages train the same model from the same init: the port's seeded
init (``make_train_step(...).init_params(0)``), carried into the JAX
package through ``models/convert.py:params_to_jax``, on the same
``SyntheticLM`` batches (one row of 256 tokens a step, 4 steps), AdamW at
lr 3e-4 with no warmup and clip 1.0 (the optimizer of ``chip_smoke.py``'s
full-width training). Compute is float32, so the two packages are held to
``tests/test_torch_train.py``'s tolerances. Depth is cut to ``--layers``
(default 1); every width stays the published one (d_model 2048, d_ff
6144, vocab 151,936). The port runs first and is freed before the JAX
step is built, so the peak host memory is one package's (about 11 GiB at
one layer).

Prints each step's loss and pre-clip grad norm for both packages, their
relative differences, the largest param difference after the last step
and how many elements lie outside the params' tolerance. Then it trains
the port again on one CPU thread (another float32 summation order inside
every matmul) and prints the same param differences between the two port
runs: the noise floor that AdamW amplifies. The last line is JSON with
all of these. Exits 1 when the losses or grad norms leave the reference
beyond 1e-5 relative, or when params lie outside their tolerance and the
largest param difference is more than twice the control's.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time

import numpy as np

# tests/test_torch_train.py's tolerances
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
# the run: chip_smoke.py's optimizer (AdamW lr 3e-4, no warmup, clip 1.0)
# in float32 on a batch small enough for the CPU
BATCH, SEQ, STEPS, LR, DTYPE = 1, 256, 4, 3e-4, "float32"


def jax_tree_copy(tree):
    """The same nested dicts and lists with every leaf an owned numpy copy."""
    if isinstance(tree, dict):
        return {k: jax_tree_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_tree_copy(v) for v in tree)
    return np.array(tree, copy=True)


def _port(cfg, batches, threads=None):
    import torch

    from repro_torch.models.convert import params_to_jax
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import make_train_step

    if threads:
        torch.set_num_threads(threads)
    ts = make_train_step(cfg, optimizer=AdamWConfig(lr=LR), device="cpu")
    params = ts.init_params(0)
    # copies: the arrays params_to_jax returns share the tensors' memory,
    # and the port's steps update the tensors in place
    init = jax_tree_copy(params_to_jax(params.state_dict(), cfg))
    opt = ts.init_opt(params)
    curve = []
    for i, b in enumerate(batches):
        t = time.perf_counter()
        params, opt, m = ts.step_fn(params, opt, {"tokens": b})
        curve.append((float(m["loss"]), float(m["grad_norm"])))
        print(f"port step {i}: loss {curve[-1][0]:.6f}, grad_norm "
              f"{curve[-1][1]:.6f} ({time.perf_counter() - t:.1f} s)",
              flush=True)
    final = jax_tree_copy(params_to_jax(params.state_dict(), cfg))
    return init, curve, final


def param_diff(a_tree, b_tree):
    """(max abs diff, elements outside the params' tolerance, elements)."""
    import jax

    worst, bad, total = 0.0, 0, 0
    for a, b in zip(jax.tree_util.tree_leaves(a_tree),
                    jax.tree_util.tree_leaves(b_tree)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        worst = max(worst, float(np.abs(a - b).max()))
        bad += int((~np.isclose(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL)).sum())
        total += a.size
    return worst, bad, total


def _jax(cfg, init, batches):
    import jax

    from repro.optim.adamw import AdamWConfig
    from repro.train.steps import make_train_step

    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
    mesh = jax.make_mesh((1, 1), ("data", "model"), **kw)
    ts = make_train_step(cfg, mesh, optimizer=AdamWConfig(lr=LR), zero=False)
    params = jax.tree.map(jax.numpy.asarray, init)
    opt = ts.init_opt(params)
    curve = []
    for i, b in enumerate(batches):
        t = time.perf_counter()
        params, opt, m = ts.step_fn(params, opt, {"tokens": b})
        curve.append((float(m["loss"]), float(m["grad_norm"])))
        print(f"jax  step {i}: loss {curve[-1][0]:.6f}, grad_norm "
              f"{curve[-1][1]:.6f} ({time.perf_counter() - t:.1f} s)",
              flush=True)
    return curve, jax.device_get(params)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=1)
    args = ap.parse_args()

    from repro.configs.registry import get_config as jax_config
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM

    def cut(c):
        return dataclasses.replace(c, num_layers=args.layers, dtype=DTYPE)
    cfg_t, cfg_j = cut(get_config("qwen3-1.7b")), cut(jax_config("qwen3-1.7b"))
    src = SyntheticLM(cfg_t.vocab_size, BATCH, SEQ, seed=0)
    batches = [src(i) for i in range(STEPS)]
    print(f"qwen3-1.7b widths, {args.layers} layer(s), {DTYPE} compute, "
          f"batch {BATCH} x seq {SEQ}, AdamW lr {LR}, {STEPS} steps",
          flush=True)
    init, port_curve, port_final = _port(cfg_t, batches)
    gc.collect()
    jax_curve, jax_final = _jax(cfg_j, init, batches)

    worst, bad, total = param_diff(port_final, jax_final)
    rel = [(abs(p[0] - j[0]) / abs(j[0]), abs(p[1] - j[1]) / abs(j[1]))
           for p, j in zip(port_curve, jax_curve)]
    for i, (p, j, r) in enumerate(zip(port_curve, jax_curve, rel)):
        print(f"step {i}: loss port {p[0]:.6f} jax {j[0]:.6f} (rel {r[0]:.2e});"
              f" grad_norm port {p[1]:.6f} jax {j[1]:.6f} (rel {r[1]:.2e})")
    print(f"params after {STEPS} steps, port vs jax: max abs diff "
          f"{worst:.3e}, {bad} of {total:,} elements outside rtol="
          f"{PARAM_RTOL}, atol={PARAM_ATOL}")
    result = {"port": port_curve, "jax": jax_curve, "rel": rel,
              "param_max_abs": worst, "params_outside": bad,
              "params": total}
    del jax_final
    gc.collect()
    _, ctl_curve, ctl_final = _port(cfg_t, batches, threads=1)
    floor, cbad, _ = param_diff(port_final, ctl_final)
    print(f"control, the port on 1 thread vs the port: max abs diff "
          f"{floor:.3e}, {cbad} elements outside the tolerance")
    result.update(control_curve=ctl_curve, control_max_abs=floor,
                  control_outside=cbad)
    ok = (all(r[0] <= LOSS_RTOL and r[1] <= LOSS_RTOL for r in rel)
          and (bad == 0 or worst <= 2 * floor))
    result["ok"] = ok
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
