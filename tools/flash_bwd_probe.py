"""The attention backward kernels on one card, alone: build, registers,
agreement, one time.

    python3 tools/flash_bwd_probe.py        # from the root of a checkout

A short first call for a change to ``csrc/flash_attention_bwd.cu``, before
``chip_smoke.py``'s whole run: builds ``flash_attention.cu`` and
``flash_attention_bwd.cu`` and prints each kernel's ``ptxas -v`` lines
(registers, spills); runs the forward and backward through autograd
(``flash_attention``) at MLA's head dims (bf16 (192, 128) on the tensor
cores, float32 (192, 128) and (96, 64) on CUDA cores), at deepseek-v2-lite's
training layer (q/k (2, 2048, 16, 192), v (2, 2048, 16, 128) bf16) and at a
GQA (128, 128) case, printing each gradient's max abs error against the
plain version's autograd on float32 copies and its worst element's share
of ``chip_smoke.py``'s bf16 limit (5e-3 + 1e-2 |ref|); and times the bf16
backward at the training layer with CUDA events over 20 calls. Needs a
card; imports nothing of jax.
"""
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402

CASES = [
    # B, S, H, KV, D, Dv, dtype
    (1, 256, 4, 4, 192, 128, torch.bfloat16),
    (1, 130, 4, 2, 192, 128, torch.float32),
    (1, 130, 4, 2, 96, 64, torch.float32),
    (2, 2048, 16, 16, 192, 128, torch.bfloat16),    # deepseek training layer
    (1, 256, 8, 4, 128, 128, torch.bfloat16),
]


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    _build.build([fa.SOURCE, fa.BWD_SOURCE])
    print("built in", time.time() - t0, _build.build_seconds, flush=True)
    for src in (fa.SOURCE, fa.BWD_SOURCE):
        log = _build.library_path(src).with_suffix(".log").read_text()
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                print(ln.strip())
    rng = np.random.default_rng(0)
    for (B, S, H, KV, D, Dv, dt) in CASES:
        def mk(*shape):
            return torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).cuda().to(dt)
        q, k, v, do = mk(B, S, H, D), mk(B, S, KV, D), mk(B, S, KV, Dv), \
            mk(B, S, H, Dv)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fa.flash_attention(*leaves, causal=True)
        got = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        l32 = [t.float().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(fa.plain_flash_attention(
            *l32, causal=True), l32, do.float())
        for n, a, b in zip("qkv", got, want):
            d = (a.float() - b).abs()
            share = (d / (5e-3 + 1e-2 * b.abs())).max().item()
            print(f"{tuple(q.shape)} {tuple(v.shape)} {dt} d{n}: max abs "
                  f"{d.max().item():.3e}, worst share of 5e-3+1e-2|ref| "
                  f"{share:.2f}", flush=True)
        if dt == torch.bfloat16 and S == 2048:
            _, lse = fa.flash_attention_cuda(q, k, v, causal=True,
                                             return_lse=True)

            def f():
                return fa.flash_attention_bwd_cuda(q, k, v, lse, do)
            for _ in range(3):
                f()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(20):
                f()
            e1.record()
            e1.synchronize()
            print(f"backward at the training shape: "
                  f"{e0.elapsed_time(e1) / 20:.4f} ms", flush=True)
    print("counters", fa.bwd_dq_launches, fa.bwd_dkdv_launches,
          fa.bwd_dq_wgmma_launches, fa.bwd_dkdv_wgmma_launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
