"""Where deepseek-v2-lite's first-token logits on a (1, 2) mesh leave one
device's: bf16 against float32 copies of the same weights, at the
config's capacity factor 1.25 and at 64 (where no expert drops a token).

    python3 tools/mesh_moe_logits_probe.py     # from the root of a checkout

The model is ``chip_smoke.py``'s mesh serve phase's: full width cut to 4
layers, the port's seeded init in bf16, the serve phase's first 4
requests. For each dtype and capacity factor, a monolithic session on
the mesh and one on one device run each request's prefill through the
stages (``chip_smoke.first_token_logits``); per request it prints the
largest logit difference, the logits' scale, the relative error in norm,
whether the greedy tokens agree and whether the difference is within
the qwen3 mesh phase's limits (atol 0.25 + rtol 0.05). A request off in
bf16 at both capacity factors and agreeing in float32 points at a top-k
expert pick that the mesh's one more bf16 rounding of a P(sum) partial
flips, not at dropped tokens or the mesh path. Prints the card's name
and power limit first. Needs a card; imports nothing of jax.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    cs.device_and_build()
    from repro_torch.configs.registry import get_config
    from repro_torch.core.placement import Placement
    from repro_torch.models.common import MeshPlan
    from repro_torch.models.model_zoo import build_model
    base = dataclasses.replace(get_config(cs.DEEPSEEK),
                               num_layers=cs.DEEPSEEK_MESH_LAYERS)
    model = build_model(base, MeshPlan.single_device(), seed=cs.SEED,
                        device=dev, dtype=torch.bfloat16)
    requests = cs.serve_requests(base)[:cs.DEEPSEEK_MESH_REQUESTS]
    geo = dict(num_groups=2, group_size=4, max_prompt_len=512,
               max_new_tokens=48)
    placement = Placement(("data", "model"), cs.DEEPSEEK_MESH)
    for dtype in ("bfloat16", "float32"):
        if dtype == "float32":
            model = model.float()           # the bf16 values, cast up
        for factor in (base.capacity_factor, 64.0):
            cfg = dataclasses.replace(base, dtype=dtype,
                                      capacity_factor=factor)
            out = {}
            for name, mesh in (("mesh", placement), ("one", None)):
                sess = cs.compile_serve(cfg, model, "monolithic", mesh=mesh,
                                        device=dev, **geo)
                out[name] = cs.first_token_logits(sess, requests, dev)
                cs.closed(sess)
            for i, (a, b) in enumerate(zip(out["mesh"], out["one"])):
                rel = (torch.linalg.vector_norm(a - b)
                       / torch.linalg.vector_norm(b)).item()
                ok = torch.allclose(a, b, atol=cs.MESH_LOGITS_ATOL,
                                    rtol=cs.MESH_LOGITS_RTOL)
                print(f"{dtype} capacity factor {factor} request {i} "
                      f"(prompt {requests[i][0].size}): max abs err "
                      f"{(a - b).abs().max().item():.3e}, scale "
                      f"{b.abs().max().item():.3f}, relative norm error "
                      f"{rel:.3e}, greedy token equal "
                      f"{bool(a.argmax() == b.argmax())}, within the qwen3 "
                      f"mesh limits {ok}", flush=True)


if __name__ == "__main__":
    main()
