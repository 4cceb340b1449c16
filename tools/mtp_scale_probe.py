"""Why deepseek-v3's one-layer MTP cut trains up, not down, over its first
steps on the card: the scale of each loss head's input and logits, step by
step, at the smoke run's lr and at a tenth of it.

    python3 tools/mtp_scale_probe.py     # from the root of a checkout

The run is ``chip_smoke.py``'s ``train_deepseek_v3_mtp``: deepseek-v3-671b
at full width cut to one MLA + dense layer and the MTP module (3.12 B
params), the port's seeded init, ZeRO at 1 x 1 (bf16 compute over float32
masters and moments), AdamW with no warmup and clip 1.0, the same
``SyntheticLM`` batches of 2 x 2048 tokens (seed 0). It trains 3 steps at
lr 3e-4 (the smoke's) and again from the same init at 3e-5. Before each
step and after the last it gathers the params, casts them to bf16 and
runs the loss's forward on that step's batch (the last: batch 0 again),
printing per row of the first 256 positions the rms of the final-normed
hidden (the LM head's input, held near 1 by ``final_norm``), of the MTP
projection's output and of the MTP block's output ``hm`` (the MTP head's
input, which the reference does not norm), the standard deviation of the
LM and MTP logits, and the step's losses. The last line is JSON with
every row. Prints the card's name and power limit first. Needs a card;
imports nothing of jax.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

LRS, STEPS, ROWS = (3e-4, 3e-5), 3, 256


def rms(t) -> float:
    return float(t.float().square().mean().sqrt())


@torch.no_grad()
def scales(state, cfg, tokens, dev):
    """The loss heads' input and logit scales of the params ``state`` (a
    float32 ``state_dict``, emptied as it is cast) on ``tokens``."""
    from repro_torch.models import transformer as T
    from repro_torch.models.common import MeshPlan, rms_norm
    plan, bf = MeshPlan.single_device(), torch.bfloat16
    with torch.device("meta"):
        model = T.Transformer(cfg, plan)
    model.load_state_dict({n: state.pop(n).to(bf) for n in list(state)},
                          assign=True)
    t = torch.as_tensor(tokens, device=dev)
    inputs, labels = t[:, :-1], t[:, 1:]
    positions = torch.arange(inputs.shape[1], device=dev)
    x = T.embed_tokens(model.embed, inputs, plan).to(bf)
    x, _ = T._run_body(model, x, cfg, plan, positions, remat=False)
    xf = rms_norm(x, model.final_norm, cfg.norm_eps)
    e = T.embed_tokens(model.embed, labels, plan)
    hm0 = T.mtp_concat(xf, e, model.mtp_norm_h, model.mtp_norm_e,
                       cfg.norm_eps) @ model.mtp_proj
    hm, _, _ = T.apply_block(model.mtp_block, hm0, cfg, plan, "attn",
                             "dense", positions)
    U = model.unembed
    return {"rms_body_out": rms(x[:, :ROWS]), "rms_lm_in": rms(xf[:, :ROWS]),
            "rms_mtp_proj_out": rms(hm0[:, :ROWS]),
            "rms_mtp_in": rms(hm[:, :ROWS]),
            "std_lm_logits": float((xf[:, :ROWS] @ U).float().std()),
            "std_mtp_logits": float((hm[:, :ROWS] @ U).float().std())}


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    smi = cs.device_and_build()
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.common import MeshPlan
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import make_train_step
    cfg = dataclasses.replace(get_config(cs.DSV3), **cs.DSV3_TRAIN_CUT)
    src = SyntheticLM(cfg.vocab_size, cs.TRAIN_B, cs.DSV3_TRAIN_S,
                      seed=cs.SEED)
    batches = [src(i) for i in range(STEPS)]
    rows = []
    for lr in LRS:
        ts = make_train_step(cfg, MeshPlan(("data", "model"), (1, 1)),
                             optimizer=AdamWConfig(lr=lr), zero=True,
                             device=dev)
        params = ts.init_params(cs.SEED)
        opt = ts.init_opt(params)
        for step in range(STEPS + 1):
            batch = batches[step % STEPS]
            row = {"lr": lr, "before_step": step,
                   **scales(ts.gather_params_fn(params), cfg, batch, dev)}
            if step < STEPS:
                params, opt, m = ts.step_fn(params, opt, {"tokens": batch})
                row.update({k: float(v) for k, v in m.items()})
            torch.cuda.empty_cache()
            rows.append(row)
            print(", ".join(f"{k} {v:.6g}" if isinstance(v, float)
                            else f"{k} {v}" for k, v in row.items()),
                  flush=True)
        del ts, params, opt
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"rows": rows, "device": smi,
                      "finite": bool(np.isfinite(
                          [v for r in rows for v in r.values()]).all())}))


if __name__ == "__main__":
    main()
