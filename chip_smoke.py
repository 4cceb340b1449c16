"""Smoke run of the PyTorch port on one NVIDIA card: kernels, serving, training.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own lines; any failure exits non-zero before the
result line is printed:

1. device and build: the card's name and power limit (``nvidia-smi``), then
   every CUDA source of the serving and training paths built from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, started together),
   each with its ``ptxas -v`` register/spill report;
2. kernels: each kernel against its plain PyTorch version at the shapes its
   path gives it -- attention forward and decode at the serving shapes,
   the attention forward also at a training layer, the xent forward and
   backward at the training logits (4,096 x 151,936,
   bf16), the attention backward at a training layer (q (2, 2048, 16, 128),
   kv (2, 2048, 8, 128), causal, bf16) against autograd through the plain
   version, the SSD scan at the mamba2-370m prefill of 512 tokens (x (1,
   512, 32, 64), B and C (1, 512, 1, 128), bf16) -- and again on float32
   copies of the same inputs, held tighter. bf16 attention runs on the
   tensor-core kernels and float32 attention on the CUDA-core ones; the
   bf16 attention forward and backward are also held to the plain version
   on float32 copies at the bf16 limits, and the launch counters show which
   kernels each dtype reached.
   Each reports the kernel's device time (torch.profiler; the names of the
   kernels the trace matched are printed), the wrapper
   call's, the plain version's, the least time the card could take (bytes
   over 3.35 TB/s or operations over the peak rate of their type, whichever
   is larger) and one PyTorch library call as a yardstick (SDPA, or
   ``F.cross_entropy``; timed here only, the port never calls them; none
   computes the SSD scan, so its row says "none"), the kernel's time over
   the library call's (``vs_library``) and the bound's share of the
   kernel's time (``bound_share``);
3. reference: the reduced qwen3 config served through the kernels agrees
   with the same weights on the CPU's plain path (prefill and decode
   logits); then two training steps of it through the kernels agree with
   the same two steps on the CPU (loss, grad_norm), every float32
   attention launch on the CUDA-core kernels; then the reduced
   mamba2 config (float32) served through the SSD kernel gives the CPU's
   plain path's tokens, with prefill logits within 1e-3;
4. serve: qwen3-1.7b at full width, bf16, seeded init, through
   ``repro_torch.api.compile(backend="actors", stages=2)`` -- 12 requests of
   64-512 prompt tokens and 8-48 new tokens in 2 groups of 4 slots; then
   the same requests on ``backend="monolithic"``, which must give the same
   tokens. Around each of the two runs the kernels' launch counters are
   zeroed just before and read just after, and must equal the launches the
   scheduler's work implies, every attention forward on the tensor-core
   kernel. One more monolithic run under torch.profiler
   gives the device's busy share and its kernels by time. Then the same for
   mamba2-370m at full width and depth (48 SSM layers, bf16): one SSD scan
   launch per layer per prefill, no attention kernel;
5. train: qwen3-1.7b at full width and depth (bf16 compute, float32 params
   and AdamW state, seeded init) through ``repro_torch.train.steps
   .make_train_step``, fed by ``ActorDataPipeline(SyntheticLM(151936, 2,
   2048))``, 4 steps: loss, grad_norm, wall time and tokens/s per step, the
   peak memory, finite and falling loss, and the exact kernel launches of
   every step, each backward kernel counted on its own and every attention
   launch on the tensor-core kernels (counters zeroed just before the run);
   then one more step under torch.profiler;
6. train, plain versions: the same 4 steps from the same init and batches
   with the model's attention and loss call sites on the plain PyTorch
   versions (autograd through them) on the card, no kernel launched; the
   kernel path's loss and grad_norm are held to these step by step.

The last two lines are the kernel table as one JSON object and the result
``{"ok": true, "device": {...}}``. It imports nothing of jax.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
# Kernel vs plain version at the path shapes, bf16 inputs: set from the
# measured max abs errors 9.8e-4 (attention: bf16 rounding of the output)
# and 4.1e-3 (decode: the plain version rounds its scores to bf16, as JAX's
# einsum does; the kernel keeps them in float32).
ATOL, RTOL = 5e-3, 1e-2
# a kernel vs the plain version on float32 copies of the same inputs: the
# same arithmetic, so only the order of float32 sums differs
F32_TOL = 1e-4
SEED = 0
# the names of the port's kernels, as the profiler's device trace shows them
PORT_KERNELS = ("flash_fwd_", "flash_bwd_", "flash_decode_kernel",
                "xent_fwd_kernel", "xent_bwd_kernel", "ssd_scan_kernel")


_START = time.perf_counter()


def phase(name: str) -> None:
    """Start a phase, with the seconds since the script started."""
    print(f"== {name} (at {time.perf_counter() - _START:.1f} s)", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card, from CUDA events around ``iters``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, kernels, iters: int = 20, warmup: int = 3):
    """Device time per call of ``fn`` spent in the kernels whose names
    contain one of ``kernels`` (the backward's two kernels together), from
    torch.profiler's device trace over ``iters`` calls after ``warmup``
    calls, and each matching kernel's own time per call by its name as the
    trace gives it; (None, {}) if the trace holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and any(k in e.key for k in kernels)]
    if not ev:
        return None, {}
    by_name = {e.key: e.self_device_time_total / iters / 1e3 for e in ev}
    return sum(by_name.values()), by_name


def timed(entry: dict, kernels, launch, wrapper, iters: int = 20) -> dict:
    """Fill ``ms`` (the kernels' own device time; CUDA events around
    ``launch`` if the profiler saw no device events), ``wrapper_ms`` (CUDA
    events around the wrapper call the model makes), and the kernel's ratio
    to the library call (``vs_library``) and its bound's share of its time
    (``bound_share``). ``kernels`` names the kernels to time (substrings of
    their names); the names the trace matched are printed with their
    times, so a kernel that misses the filter shows."""
    kernels = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    label = entry.get("name") or "/".join(kernels)
    ms, by_name = kernel_ms(launch, kernels, iters=iters)
    if ms is None:
        print(f"{label}: the profiler saw no device events of {kernels}; "
              "ms is from CUDA events around the launch call")
        ms = cuda_ms(launch, iters=iters)
    else:
        print(f"{label}: timed kernels " + "; ".join(
            f"{k[:80]} {v:.4f} ms" for k, v in by_name.items()))
        if len(kernels) > 1:
            entry["ms_by_kernel"] = {
                name: sum(v for k, v in by_name.items() if name in k)
                for name in kernels}
    entry["ms"] = ms
    entry["wrapper_ms"] = cuda_ms(wrapper, iters=iters)
    lib = entry.get("library_ms")
    entry["vs_library"] = None if lib is None else ms / lib
    entry["bound_share"] = entry["bound_ms"] / ms
    return entry


def agree(name: str, got, want, atol: float, rtol: float) -> float:
    """Max abs error of ``got`` against ``want``; raise past the limit. The
    worst element's share of its limit is printed beside it."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    share = (diff / (atol + rtol * want.float().abs())).max().item()
    ok = torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
    print(f"{name}: max_abs_err {err:.3e} (limit {atol} + {rtol}*|ref|; "
          f"worst at {share:.2f} of its limit) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             "version")
    return err


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def device_and_build():
    phase("device and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.softmax_xent import kernel as xk
    from repro_torch.kernels.ssd_scan import kernel as ssd
    sources = [fa.SOURCE, fd.SOURCE, xk.SOURCE, fa.BWD_SOURCE, ssd.SOURCE]
    t0 = time.perf_counter()
    _build.build(sources)
    print(f"built {', '.join(sources)} in "
          f"{time.perf_counter() - t0:.1f} s "
          f"(per source: {_build.build_seconds})")
    for src in sources:
        log = _build.library_path(src).with_suffix(".log").read_text()
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"ptxas {src}: " + " | ".join(usage))
    return smi


def check_flash_attention(dev):
    """The attention forward at the serving prefill shape (the row's main
    numbers, as in slice 1) and at one training layer (``train_shape``)."""
    from repro_torch.kernels.flash_attention import kernel as fa

    def at(B, S, H, KV, D, seed):
        rng = np.random.default_rng(seed)
        mk = lambda *shape: torch.from_numpy(  # noqa: E731
            rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)
        q, k, v = mk(B, S, H, D), mk(B, S, KV, D), mk(B, S, KV, D)
        what = f"flash_attention q{tuple(q.shape)} kv{tuple(k.shape)} causal"
        # bf16 goes to the tensor-core kernel, float32 to the CUDA-core one
        n0, w0 = fa.launches, fa.wgmma_launches
        got = fa.flash_attention(q, k, v, causal=True)
        want = fa.plain_flash_attention(q, k, v, causal=True)
        err = agree(f"{what} bf16", got, want, ATOL, RTOL)
        f32 = [t.float() for t in (q, k, v)]
        want32 = fa.plain_flash_attention(*f32, causal=True)
        err_c = agree(f"{what} bf16 vs the plain version on float32 copies",
                      got, want32, ATOL, RTOL)
        err32 = agree(f"{what} float32", fa.flash_attention(
            *f32, causal=True), want32, F32_TOL, F32_TOL)
        torch.cuda.synchronize()
        if (fa.launches - n0, fa.wgmma_launches - w0) != (2, 1):
            raise AssertionError("flash_attention: bf16 did not reach the "
                                 "tensor-core kernel, or float32 did")
        del f32, want32
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = S * (S + 1) // 2                 # causal: unmasked (q, k)
        b_ms, b_by = bound_ms(nbytes(q, k, v, got), 4 * D * H * B * pairs)
        launch = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
        return timed({
            "max_abs_err": err, "max_abs_err_vs_f32_copies": err_c,
            "f32_max_abs_err": err32,
            "plain_ms": cuda_ms(
                lambda: fa.plain_flash_attention(q, k, v, causal=True),
                iters=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(lambda: torch.nn.functional
                                  .scaled_dot_product_attention(
                                      qt, kt, vt, is_causal=True,
                                      enable_gqa=True)),
        }, "flash_fwd_wgmma_kernel", launch, launch)

    entry = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:75"}
    entry.update(at(1, 512, 16, 8, 128, SEED))
    entry["train_shape"] = at(2, 2048, 16, 8, 128, SEED + 7)
    return entry


def check_flash_decode(dev):
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode.ref import (combine_partials,
                                                      flash_decode_partial_ref)
    B, H, KV, D, L = 4, 16, 8, 128, 569
    rng = np.random.default_rng(SEED + 1)
    mk = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)
    q, k, v = mk(B, H, D), mk(B, L, KV, D), mk(B, L, KV, D)
    cur = torch.tensor([70, 300, 511, L - 1], dtype=torch.int32, device=dev)
    got = combine_partials(*(t[None] for t in fd.flash_decode(
        q, k, v, cur_pos=cur)))
    want = combine_partials(*(t[None] for t in flash_decode_partial_ref(
        q, k, v, cur_pos=cur)))
    what = (f"flash_decode q{tuple(q.shape)} cache{tuple(k.shape)} "
            f"cur_pos {cur.tolist()} (parked row at {L - 1})")
    err = agree(f"{what} bf16", got, want, ATOL, RTOL)
    want32 = combine_partials(*(t[None] for t in flash_decode_partial_ref(
        q.float(), k.float(), v.float(), cur_pos=cur)))
    agree(f"{what} vs the plain version on float32 copies", got, want32,
          F32_TOL, F32_TOL)
    keys = int((cur.long() + 1).sum().item())    # keys this run must read
    m, l, acc = fd.flash_decode(q, k, v, cur_pos=cur)
    moved = (nbytes(q, cur, m, l, acc)
             + 2 * keys * KV * D * k.element_size())
    b_ms, b_by = bound_ms(moved, 4 * D * H * keys)
    mask = (torch.arange(L, device=dev)[None, :] <= cur[:, None].long())
    qs, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    return timed({
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode/kernel.py:60",
        "max_abs_err": err,
        "plain_ms": cuda_ms(
            lambda: flash_decode_partial_ref(q, k, v, cur_pos=cur)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.nn.functional
                              .scaled_dot_product_attention(
                                  qs, kt, vt, attn_mask=mask[:, None, None],
                                  enable_gqa=True)),
    }, "flash_decode_kernel",
        lambda: fd.flash_decode_cuda_partials(q, k, v, cur),
        lambda: fd.flash_decode(q, k, v, cur_pos=cur))


def check_xent(dev):
    """The xent forward and backward kernels at the training logits (the
    lm_loss of batch 2 x seq 2048 over the padded qwen3 vocab), bf16, then
    on float32 copies of the same inputs."""
    from repro_torch.kernels.softmax_xent import kernel as xk
    from repro_torch.kernels.softmax_xent.ref import local_stats_ref
    N, Vl = 4096, 151936
    rng = np.random.default_rng(SEED + 4)
    logits = (torch.from_numpy(rng.normal(size=(N, Vl)).astype(np.float32))
              .to(dev) * 3).to(torch.bfloat16)
    labels = torch.as_tensor(rng.integers(0, Vl, N), dtype=torch.int32,
                             device=dev)
    ds = torch.as_tensor(rng.normal(size=N), dtype=torch.float32, device=dev)
    dz = torch.as_tensor(rng.normal(size=N), dtype=torch.float32, device=dev)
    what = f"logits ({N}, {Vl})"

    def through_autograd(x, stats):
        leaf = x.detach().requires_grad_(True)
        m, s_, z = stats(leaf, labels, 0)
        (g,) = torch.autograd.grad((s_, z), leaf, (ds, dz))
        return (m, s_.detach(), z.detach()), g

    errs = []
    for dt, atol, rtol in ((torch.bfloat16, ATOL, RTOL),
                           (torch.float32, F32_TOL, F32_TOL)):
        x = logits.to(dt)
        got, g = through_autograd(x, xk.xent_local_stats)
        want, wg = through_autograd(x, local_stats_ref)
        err = max(agree(f"xent_local_stats {name} {what} {dt}", a, b, atol,
                        rtol) for name, a, b in zip("msz", got, want))
        gerr = agree(f"xent_local_stats backward {what} {dt}", g, wg, atol,
                     rtol)
        errs.append((err, gerr))
        del got, g, want, wg, x
    torch.cuda.empty_cache()

    m, s_, z = xk.xent_local_stats_cuda(logits, labels, 0)
    fwd_bytes = nbytes(logits, labels, m, s_, z)
    fb_ms, fb_by = bound_ms(fwd_bytes, 4 * N * Vl, PEAK_F32_FLOPS)
    bb_ms, bb_by = bound_ms(fwd_bytes - nbytes(s_, z) + nbytes(ds, dz)
                            + nbytes(logits), 4 * N * Vl, PEAK_F32_FLOPS)
    lab = labels.long()

    def plain_bwd():
        leaf = logits.detach().requires_grad_(True)
        _, s2, z2 = local_stats_ref(leaf, labels, 0)
        return lambda: torch.autograd.grad((s2, z2), leaf, (ds, dz),
                                           retain_graph=True)

    def library_bwd():
        leaf = logits.detach().requires_grad_(True)
        loss = torch.nn.functional.cross_entropy(leaf.float(), lab,
                                                 reduction="none")
        return lambda: torch.autograd.grad(loss, leaf, ds, retain_graph=True)

    fwd = timed({
        "name": "xent_local_stats", "route": "cuda",
        "source": "src/repro_torch/csrc/softmax_xent.cu",
        "replaces": "src/repro/kernels/softmax_xent/kernel.py:67",
        "max_abs_err": errs[0][0], "f32_max_abs_err": errs[1][0],
        "plain_ms": cuda_ms(lambda: local_stats_ref(logits, labels, 0),
                            iters=5),
        "bound_ms": fb_ms, "bound_by": fb_by,
        "library_ms": cuda_ms(lambda: torch.nn.functional.cross_entropy(
            logits.float(), lab, reduction="none"), iters=5),
    }, "xent_fwd_kernel", lambda: xk.xent_local_stats_cuda(logits, labels, 0),
        lambda: xk.xent_local_stats(logits, labels, 0))
    bwd_launch = lambda: xk.xent_local_stats_bwd_cuda(  # noqa: E731
        logits, labels, 0, m, ds, dz)
    bwd = timed({
        "name": "xent_local_stats_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/softmax_xent.cu",
        "replaces": "src/repro/kernels/softmax_xent/kernel.py:67 (its "
                    "backward; no Pallas counterpart)",
        "max_abs_err": errs[0][1], "f32_max_abs_err": errs[1][1],
        "plain_ms": cuda_ms(plain_bwd(), iters=5),
        "bound_ms": bb_ms, "bound_by": bb_by,
        "library_ms": cuda_ms(library_bwd(), iters=5),
    }, "xent_bwd_kernel", bwd_launch, bwd_launch)
    torch.cuda.empty_cache()
    return fwd, bwd


def check_flash_attention_bwd(dev):
    """The attention backward at one training layer of qwen3-1.7b against
    autograd through the plain version, bf16 and on float32 copies."""
    from repro_torch.kernels.flash_attention import kernel as fa
    B, S, H, KV, D = 2, 2048, 16, 8, 128
    rng = np.random.default_rng(SEED + 5)
    mk = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)
    q, k, v, do = mk(B, S, H, D), mk(B, S, KV, D), mk(B, S, KV, D), \
        mk(B, S, H, D)
    what = f"q{tuple(q.shape)} kv{tuple(k.shape)} causal"

    def grads(attn, dt):
        leaves = [t.detach().to(dt).requires_grad_(True) for t in (q, k, v)]
        out = attn(*leaves, causal=True)
        return torch.autograd.grad(out, leaves, do.to(dt))

    # The plain version's bf16 autograd sums dk and dv in bf16 (over its
    # 512-row blocks and the G q heads of a kv head), so the bf16 kernel,
    # which sums in float32 and rounds once, is held to the plain version's
    # autograd on float32 copies of the same bf16 inputs; its distance from
    # the plain bf16 autograd is printed beside it.
    def tc_counts():
        return (fa.bwd_dq_launches, fa.bwd_dkdv_launches,
                fa.bwd_dq_wgmma_launches, fa.bwd_dkdv_wgmma_launches)

    def routed(before, tc):
        got = [a - b for a, b in zip(tc_counts(), before)]
        if got != [1, 1, tc, tc]:
            raise AssertionError(f"flash_attention backward: launches {got}"
                                 f", expected [1, 1, {tc}, {tc}]")

    want32 = grads(fa.plain_flash_attention, torch.float32)
    before = tc_counts()
    got = grads(fa.flash_attention, torch.bfloat16)
    routed(before, 1)           # bf16: the tensor-core kernels
    err = max(agree(f"flash_attention backward d{n} {what} bf16 vs the plain "
                    "version on float32 copies", a, b, ATOL, RTOL)
              for n, a, b in zip("qkv", got, want32))
    want = grads(fa.plain_flash_attention, torch.bfloat16)
    print("flash_attention backward bf16 vs the plain bf16 autograd: max "
          "abs err " + ", ".join(
              f"d{n} {(a.float() - b.float()).abs().max().item():.3e}"
              for n, a, b in zip("qkv", got, want)) + " (not held)")
    del got, want
    before = tc_counts()
    got32 = grads(fa.flash_attention, torch.float32)
    routed(before, 0)           # float32: the CUDA-core kernels
    err32 = max(agree(f"flash_attention backward d{n} {what} float32", a, b,
                      F32_TOL, F32_TOL)
                for n, a, b in zip("qkv", got32, want32))
    errs = [err, err32]
    del got32, want32
    torch.cuda.empty_cache()

    _, lse = fa.flash_attention_cuda(q, k, v, causal=True, return_lse=True)
    pairs = S * (S + 1) // 2
    dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, lse, do)
    b_ms, b_by = bound_ms(nbytes(q, k, v, lse, do, dq, dk, dv),
                          10 * D * H * B * pairs)

    def plain_bwd():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = fa.plain_flash_attention(*leaves, causal=True)
        return lambda: torch.autograd.grad(out, leaves, do,
                                           retain_graph=True)

    def library_bwd():
        leaves = [t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)
        return lambda: torch.autograd.grad(out, leaves, dot,
                                           retain_graph=True)

    launch = lambda: fa.flash_attention_bwd_cuda(q, k, v, lse, do)  # noqa: E731
    return timed({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:75 (its "
                    "backward; no Pallas counterpart)",
        "max_abs_err": errs[0], "f32_max_abs_err": errs[1],
        "plain_ms": cuda_ms(plain_bwd(), iters=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(library_bwd(), iters=5),
    }, ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkdv_wgmma_kernel"), launch,
        launch)


def check_ssd_scan(dev):
    """The SSD scan at the mamba2-370m prefill of the longest serve prompt
    (x (1, 512, 32, 64), B and C (1, 512, 1, 128) as views into one
    projection, as the model passes them), bf16, then on float32 copies of
    the same inputs. No single PyTorch call computes the scan: library
    "none"."""
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
    B, L, H, P, N, G, Q = 1, 512, 32, 64, 128, 1, 128
    rng = np.random.default_rng(SEED + 9)
    mk = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)
    x, bc = mk(B, L, H, P), mk(B, L, 2 * G * N)
    Bm = bc[..., :G * N].reshape(B, L, G, N)
    Cm = bc[..., G * N:].reshape(B, L, G, N)
    # decays of the model's range: A = -linspace(1, 16), as its init
    dt = torch.as_tensor(rng.uniform(0.01, 0.2, (B, L, H)),
                         dtype=torch.float32, device=dev)
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    D = torch.as_tensor(rng.normal(size=H), dtype=torch.float32, device=dev)
    args = (x, dt, A, Bm, Cm, D)
    what = f"ssd_scan x{tuple(x.shape)} B/C{tuple(Bm.shape)} chunk {Q}"
    errs = []
    for dtype, atol, rtol in ((torch.bfloat16, ATOL, RTOL),
                              (torch.float32, F32_TOL, F32_TOL)):
        a = [t.to(dtype) if t.dtype == torch.bfloat16 else t for t in args]
        y, hT = ssd.ssd_scan(*a, chunk=Q)
        yr, hr = ssd_chunked_ref(*a, chunk=Q)
        errs.append(max(agree(f"{what} y {dtype}", y, yr, atol, rtol),
                        agree(f"{what} hT {dtype}", hT, hr, F32_TOL,
                              F32_TOL)))
    y, hT = ssd.ssd_scan_cuda(*args, chunk=Q)
    flops = 0
    for t0 in range(0, L, Q):                    # per chunk of Qc steps
        qc = min(Q, L - t0)
        pairs = qc * (qc + 1) // 2               # the causal (i >= j) pairs
        flops += B * H * (2 * pairs * N + 2 * pairs * P + 4 * qc * N * P)
    b_ms, b_by = bound_ms(nbytes(*args, y, hT), flops)
    return timed({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:72",
        "max_abs_err": errs[0], "f32_max_abs_err": errs[1],
        "plain_ms": cuda_ms(lambda: ssd_chunked_ref(*args, chunk=Q), iters=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }, "ssd_scan_kernel", lambda: ssd.ssd_scan_cuda(*args, chunk=Q),
        lambda: ssd.ssd_scan(*args, chunk=Q))


def check_reference(dev):
    """Reduced qwen3 (float32) through the kernels on the card against the
    same weights on the CPU's plain path: prefill logits, then four decode
    steps fed the CPU's greedy tokens."""
    phase("reference (reduced qwen3, card vs CPU plain path)")
    from repro_torch.api import greedy_from_logits
    from repro_torch.configs.registry import get_config
    from repro_torch.core.lowering import lower_serve_stages
    from repro_torch.models.common import MeshPlan
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("qwen3-1.7b").reduced()
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (37, 100)]
    geo = dict(num_stages=2, cache_len=160, max_prompt_len=128,
               group_size=len(prompts))
    # the same seeded weights on each device (the init runs on the CPU)
    progs = {d: lower_serve_stages(
        cfg, build_model(cfg, MeshPlan.single_device(), seed=SEED,
                         device="cpu").to(d),
        **geo) for d in ("cpu", dev)}
    worst = 0.0

    def compare(a, b, what):
        nonlocal worst
        err = (a.cpu() - b).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(a.cpu(), b, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"{what}: card and CPU disagree "
                                 f"(max abs err {err:.3e})")

    with torch.inference_mode():
        caches = {d: [s.init_caches(len(prompts)) for s in p.stages]
                  for d, p in progs.items()}
        toks = []
        for slot, pr in enumerate(prompts):
            out = {}
            for d, p in progs.items():
                x = torch.as_tensor(pr[None], dtype=torch.int32, device=d)
                for s, st in enumerate(p.stages):
                    x, sc = st.prefill(st.params, x, pr.size - 1)
                    st.write_slot(caches[d][s], sc, slot)
                out[d] = x
            compare(out[dev], out["cpu"], f"prefill logits, prompt {slot}")
            toks.append(int(greedy_from_logits(out["cpu"], cfg.vocab_size)))
        pos = [pr.size for pr in prompts]
        for step in range(4):
            out = {}
            for d, p in progs.items():
                x = torch.tensor(toks, dtype=torch.int32, device=d)
                pt = torch.tensor(pos, dtype=torch.int32, device=d)
                for s, st in enumerate(p.stages):
                    x, _ = st.decode(st.params, caches[d][s], x, pt)
                out[d] = x
            compare(out[dev], out["cpu"], f"decode step {step} logits")
            toks = greedy_from_logits(out["cpu"], cfg.vocab_size).tolist()
            pos = [p_ + 1 for p_ in pos]
    print(f"reduced qwen3 prefill + 4 decode steps: logits agree, max abs "
          f"err {worst:.3e} (bound 1e-3 + 1e-3*|ref|, float32)")


def check_reference_train(dev):
    """Two training steps of the reduced qwen3 (float32) through the
    kernels on the card against the same two steps on the CPU's plain path,
    from the same initial weights and batches."""
    phase("reference train (reduced qwen3, card vs CPU plain path, 2 steps)")
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.steps import make_train_step

    cfg = get_config("qwen3-1.7b").reduced()
    src = SyntheticLM(cfg.vocab_size, 2, 64, seed=SEED + 6)
    batches = [src(i) for i in range(2)]
    init = None
    runs = {}
    zero_train_counts()
    for d in ("cpu", dev):
        ts = make_train_step(cfg, device=d)
        params = ts.init_params(SEED)
        if init is None:
            init = {n: t.detach().clone() for n, t in params.state_dict().items()}
        params.load_state_dict(init)
        opt = ts.init_opt(params)
        runs[d] = []
        for b in batches:
            params, opt, m = ts.step_fn(params, opt, {"tokens": b})
            runs[d].append((float(m["loss"]), float(m["grad_norm"])))
    # float32 attention runs on the CUDA-core kernels, none on tensor cores
    n = train_counts()
    if (min(n["flash_attention"], n["flash_bwd_dq_kernel"],
            n["flash_bwd_dkdv_kernel"]) < 2
            or n["flash_fwd_wgmma_kernel"] or n["flash_bwd_dq_wgmma_kernel"]
            or n["flash_bwd_dkdv_wgmma_kernel"]):
        raise AssertionError(f"reduced qwen3 train steps, float32: launches "
                             f"{n}; expected the CUDA-core kernels only")
    print(f"reduced qwen3 float32 train steps: attention launches {n}")
    worst = 0.0
    for (lc, gc), (lg, gg) in zip(runs["cpu"], runs[dev]):
        err = max(abs(lg - lc) / abs(lc), abs(gg - gc) / abs(gc))
        worst = max(worst, err)
        if err > 1e-4:
            raise AssertionError(f"train steps: card {runs[dev]} vs CPU "
                                 f"{runs['cpu']}")
    print(f"reduced qwen3, 2 train steps: card (loss, grad_norm) "
          f"{runs[dev]}, CPU {runs['cpu']}; max relative err {worst:.3e} "
          "(bound 1e-4, float32)")


def check_reference_mamba(dev):
    """Reduced mamba2 (float32) served through the SSD kernel on the card
    against the same weights on the CPU's plain path: the same tokens on
    the stage actors, then prefill logits within 1e-3."""
    phase("reference (reduced mamba2, card vs CPU plain path)")
    from repro_torch import api
    from repro_torch.configs.registry import get_config
    from repro_torch.core.lowering import lower_serve_stages
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.models.common import MeshPlan
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("mamba2-370m").reduced()
    rng = np.random.default_rng(SEED + 8)
    requests = [(rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32), g)
                for n, g in ((37, 6), (100, 3), (5, 8), (64, 4))]
    # the same seeded weights on each device (the init runs on the CPU)
    state = build_model(cfg, MeshPlan.single_device(), seed=SEED,
                        device="cpu").state_dict()
    outs, launches = {}, {}
    for d in ("cpu", dev):
        ssd.launches = 0
        with api.compile(cfg, mode="serve", backend="actors", stages=2,
                         params=state, device=d, num_groups=2, group_size=1,
                         max_prompt_len=128, max_new_tokens=8) as sess:
            outs[d] = sess.generate(requests)
        launches[d] = ssd.launches
    want = {"cpu": 0, dev: len(requests) * cfg.num_layers}
    same = all(np.array_equal(a, b) for a, b in zip(outs["cpu"], outs[dev]))
    print(f"reduced mamba2 served on the stage actors: tokens identical to "
          f"the CPU's: {same}; ssd_scan launches {launches} (expected "
          f"{want})")
    if not same or launches != want:
        raise AssertionError(f"reduced mamba2: card {outs[dev]} vs CPU "
                             f"{outs['cpu']}, launches {launches}")
    progs = {d: lower_serve_stages(cfg, build_model(
        cfg, MeshPlan.single_device(), seed=SEED, device="cpu").to(d),
        num_stages=2, cache_len=128, max_prompt_len=100, group_size=1)
        for d in ("cpu", dev)}
    worst = 0.0
    with torch.inference_mode():
        for toks, _ in requests:
            out = {}
            for d, p in progs.items():
                x = torch.as_tensor(toks[None], device=d)
                for st in p.stages:
                    x, _ = st.prefill(st.params, x, toks.size - 1)
                out[d] = x.cpu()
            worst = max(worst, (out[dev] - out["cpu"]).abs().max().item())
            if not torch.allclose(out[dev], out["cpu"], rtol=1e-3, atol=1e-3):
                raise AssertionError(f"reduced mamba2 prefill of {toks.size} "
                                     "tokens: card and CPU logits disagree")
    print(f"reduced mamba2 prefill logits: max abs err {worst:.3e} (bound "
          "1e-3 + 1e-3*|ref|, float32)")


def serve_counts():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.ssd_scan import kernel as ssd
    return {"flash_attention": fa.launches,
            "flash_fwd_wgmma_kernel": fa.wgmma_launches,
            "flash_decode": fd.launches, "ssd_scan": ssd.launches}


def zero_serve_counts():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.ssd_scan import kernel as ssd
    fa.launches = fa.wgmma_launches = fd.launches = ssd.launches = 0


def serve(dev, arch: str):
    """The main path: full-width ``arch`` on the stage actors, then the
    same requests on the monolithic engine, each run's kernel launches
    counted and checked: per layer, one attention forward per prefill and
    one decode per decode item, or one SSD scan per prefill. Returns the
    launch counts of the actor run."""
    phase(f"serve ({arch}, full width, bf16, actors x 2 stages)")
    from repro_torch import api
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    n_req = 12
    rng = np.random.default_rng(SEED + 3)
    lens = rng.integers(64, 513, n_req)
    gens = rng.integers(8, 49, n_req)
    requests = [(rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32),
                 int(g)) for n, g in zip(lens, gens)]
    geo = dict(num_groups=2, group_size=4, max_prompt_len=512,
               max_new_tokens=48, seed=SEED)

    t0 = time.perf_counter()
    sess = api.compile(cfg, mode="serve", backend="actors", stages=2, **geo)
    torch.cuda.synchronize()
    print(f"compiled in {time.perf_counter() - t0:.1f} s "
          f"(cache_len {sess.cache_len})")
    print(sess.describe())
    def counted(session):
        zero_serve_counts()
        out = session.generate(requests)
        got = serve_counts()
        st = session.last_stats
        L = cfg.num_layers
        ssm = cfg.family == "ssm"
        # every bf16 attention forward on the tensor-core kernel
        want = {"flash_attention": 0 if ssm else L * st["prefill_items"],
                "flash_fwd_wgmma_kernel":
                    0 if ssm else L * st["prefill_items"],
                "flash_decode": 0 if ssm else L * st["decode_items"],
                "ssd_scan": L * st["prefill_items"] if ssm else 0}
        print(f"launches on the {session.backend} run: {got} (expected "
              f"{want}: {L} layers, {st['prefill_items']} prefills, "
              f"{st['decode_items']} decode items)")
        if got != want or st["prefill_items"] != n_req:
            raise AssertionError(f"{session.backend}: kernel launches {got},"
                                 f" expected {want}")
        return out, got

    torch.cuda.reset_peak_memory_stats()
    outs, launches = counted(sess)
    st = sess.last_stats
    peak = torch.cuda.max_memory_allocated()
    sess.close()
    del sess
    torch.cuda.empty_cache()

    for i, (o, (_, g)) in enumerate(zip(outs, requests)):
        if len(o) != g or (o < 0).any() or (o >= cfg.vocab_size).any():
            raise AssertionError(f"request {i}: {len(o)} ids (want {g}), "
                                 f"range [{o.min()}, {o.max()}]")
    if st["admitted_mid_flight"] < 1:
        raise AssertionError("no request was admitted mid-flight")
    print(f"actors: {st['requests']} requests, {st['tokens']} tokens in "
          f"{st['rounds']} rounds, {st['wall_s']:.3f} s wall, "
          f"{st['tok_per_s']:.2f} tok/s, {st['prefill_items']} prefill + "
          f"{st['decode_items']} decode items, {st['admitted_mid_flight']} "
          f"admitted mid-flight, peak memory {peak / 2**30:.2f} GiB")

    mono = api.compile(cfg, mode="serve", backend="monolithic", **geo)
    ref, _ = counted(mono)
    ms = mono.last_stats
    same = all(np.array_equal(a, b) for a, b in zip(outs, ref))
    print(f"monolithic: {ms['tokens']} tokens, {ms['wall_s']:.3f} s wall, "
          f"{ms['tok_per_s']:.2f} tok/s; tokens identical to actors: {same}")
    if not same:
        raise AssertionError("actors and monolithic tokens differ")
    profile_device(f"{mono.backend} generate",
                   lambda: mono.generate(requests))
    mono.close()
    return launches


def profile_device(what: str, fn, top: int = 8):
    """Where the time goes: the device's busy time and its kernels by name
    over one more run of ``fn``, from torch.profiler's device trace (the
    profiler's own cost is in the wall time): the ``top`` kernels by time,
    then the port's own kernels (``PORT_KERNELS``) that are not among
    them."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        print(f"profiled {what}: {wall:.3f} s wall; the trace holds no "
              "device events, so the idle share is not measured")
        return
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    print(f"profiled {what}: {wall:.3f} s wall (profiler on), device busy "
          f"{busy:.3f} s, idle share {1 - busy / wall:.3f}")
    ranked = sorted(kern, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):
        if i < top or any(k in e.key for k in PORT_KERNELS):
            print(f"  {e.self_device_time_total / 1e3:10.3f} ms  "
                  f"{e.count:6d} x  {e.key[:90]}")


TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 2048, 4
# The kernel path's 4 full-width bf16 steps against the same steps through
# the plain versions on the card, relative to the plain path's numbers:
# step 0 sees only the rounding of one forward and backward; from step 1 on,
# AdamW's first update (about lr times the sign of each gradient) turns that
# rounding into different weights, so later steps are held looser. Set at
# about 10x the measured worst: 9.6e-5 at step 0 (grad_norm), 4.3e-4 after.
CURVE_RTOL_FIRST, CURVE_RTOL = 1e-3, 5e-3


@contextlib.contextmanager
def plain_versions():
    """The model's kernel call sites (attention, and the loss's local stats)
    take the plain PyTorch versions on the card while the block runs: the
    reference the kernel path's training curve is held to."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.softmax_xent.ref import local_stats_ref
    from repro_torch.models import attention, transformer
    saved = attention.flash_attention, transformer.xent_local_stats
    attention.flash_attention = fa.plain_flash_attention
    transformer.xent_local_stats = local_stats_ref
    try:
        yield
    finally:
        attention.flash_attention, transformer.xent_local_stats = saved


def train_counts():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.softmax_xent import kernel as xk
    return {"flash_attention": fa.launches,
            "flash_bwd_dq_kernel": fa.bwd_dq_launches,
            "flash_bwd_dkdv_kernel": fa.bwd_dkdv_launches,
            "flash_fwd_wgmma_kernel": fa.wgmma_launches,
            "flash_bwd_dq_wgmma_kernel": fa.bwd_dq_wgmma_launches,
            "flash_bwd_dkdv_wgmma_kernel": fa.bwd_dkdv_wgmma_launches,
            "xent_local_stats": xk.launches,
            "xent_local_stats_bwd": xk.bwd_launches}


def zero_train_counts():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.softmax_xent import kernel as xk
    fa.launches = fa.bwd_dq_launches = fa.bwd_dkdv_launches = 0
    fa.wgmma_launches = fa.bwd_dq_wgmma_launches = 0
    fa.bwd_dkdv_wgmma_launches = 0
    xk.launches = xk.bwd_launches = 0


def train_steps(dev, what: str, want: dict):
    """Full-width, full-depth qwen3-1.7b through make_train_step from the
    seeded init, fed by the actor data pipeline, TRAIN_STEPS steps with the
    kernels' launches counted on every step and held to ``want``. Returns
    (step function, params, opt state, source, [(loss, grad_norm)], total
    launches)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import ActorDataPipeline, SyntheticLM
    from repro_torch.train.steps import make_train_step

    cfg = get_config("qwen3-1.7b")
    B, S = TRAIN_B, TRAIN_S
    t0 = time.perf_counter()
    ts = make_train_step(cfg, device=dev)
    params = ts.init_params(SEED)
    opt = ts.init_opt(params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{what}: params and AdamW state initialised in "
          f"{time.perf_counter() - t0:.1f} s: {n_params:,} params")
    src = SyntheticLM(cfg.vocab_size, B, S, seed=SEED)
    pipe = ActorDataPipeline(src, num_batches=TRAIN_STEPS)
    curve = []
    torch.cuda.reset_peak_memory_stats()
    zero_train_counts()
    prev = train_counts()
    for step, tokens in enumerate(pipe):
        t = time.perf_counter()
        params, opt, m = ts.step_fn(params, opt, {"tokens": tokens})
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        now = train_counts()
        per = {k: now[k] - prev[k] for k in now}
        prev = now
        curve.append((loss, gnorm))
        print(f"{what} step {step}: loss {loss:.4f}, grad_norm {gnorm:.4f}, "
              f"wall {wall:.3f} s, {B * S / wall:,.0f} tokens/s, launches "
              f"{per}")
        if per != want:
            raise AssertionError(f"{what} step {step}: kernel launches {per},"
                                 f" expected {want}")
    total = train_counts()
    print(f"{what}: launches over the {TRAIN_STEPS} steps: {total}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    losses = [c[0] for c in curve]
    if not all(np.isfinite(curve).ravel()) or not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: (loss, grad_norm) {curve}: not "
                             "finite, or the loss did not fall")
    return ts, params, opt, src, curve, total


def train(dev):
    """The main path of training: full-width, full-depth qwen3-1.7b through
    make_train_step, fed by the actor data pipeline, with the kernels'
    launches counted on every step, then one profiled step. Returns the
    run's launch counts and its (loss, grad_norm) curve."""
    phase(f"train (qwen3-1.7b, full width and depth, bf16 compute, float32 "
          f"params and AdamW, {TRAIN_STEPS} steps)")
    from repro_torch.configs.registry import get_config
    L = get_config("qwen3-1.7b").num_layers
    # per step: the forward of every layer, again in its remat recompute,
    # each backward kernel once per layer, one loss; every attention launch
    # of the bf16 step on the tensor-core kernels
    want = {"flash_attention": 2 * L, "flash_bwd_dq_kernel": L,
            "flash_bwd_dkdv_kernel": L, "flash_fwd_wgmma_kernel": 2 * L,
            "flash_bwd_dq_wgmma_kernel": L, "flash_bwd_dkdv_wgmma_kernel": L,
            "xent_local_stats": 1, "xent_local_stats_bwd": 1}
    ts, params, opt, src, curve, total = train_steps(dev, "kernels", want)
    batch = {"tokens": src(TRAIN_STEPS)}
    profile_device("train step", lambda: float(
        ts.step_fn(params, opt, batch)[2]["loss"]), top=10)
    return total, curve


def train_plain(dev, kernel_curve):
    """The same steps, from the same init and batches, with the model's call
    sites on the plain versions (autograd through them) on the card; the
    kernel path's loss and grad_norm are held to them step by step."""
    phase(f"train, plain versions (qwen3-1.7b, full width and depth, bf16, "
          f"the same {TRAIN_STEPS} steps)")
    with plain_versions():
        *_, curve, _ = train_steps(dev, "plain", {
            k: 0 for k in train_counts()})
    worst = [0.0, 0.0]
    for step, (got, want) in enumerate(zip(kernel_curve, curve)):
        errs = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        limit = CURVE_RTOL_FIRST if step == 0 else CURVE_RTOL
        print(f"step {step}: kernels (loss, grad_norm) {got}, plain {want}: "
              f"relative err {errs[0]:.3e}, {errs[1]:.3e} (limit {limit})")
        worst = [max(a, b) for a, b in zip(worst, errs)]
        if max(errs) > limit:
            raise AssertionError(f"step {step}: the kernel path's training "
                                 "curve left the plain path's")
    print(f"kernel path vs plain path over {TRAIN_STEPS} steps: max relative "
          f"err loss {worst[0]:.3e}, grad_norm {worst[1]:.3e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    dev = "cuda"
    smi = device_and_build()
    phase("kernels (path shapes)")
    kernels = [check_flash_attention(dev), check_flash_decode(dev),
               *check_xent(dev), check_flash_attention_bwd(dev),
               check_ssd_scan(dev)]
    for kr in kernels + [dict(kernels[0]["train_shape"],
                              name="flash_attention (training shape)")]:
        lib = kr["library_ms"]
        print(f"{kr['name']}: kernel {kr['ms']:.4f} ms, wrapper call "
              f"{kr['wrapper_ms']:.4f} ms, plain {kr['plain_ms']:.4f} "
              f"ms, bound {kr['bound_ms']:.4f} ms ({kr['bound_by']}; "
              f"{kr['bound_share']:.1%} of the kernel's time), library "
              + ("none" if lib is None else
                 f"{lib:.4f} ms (kernel / library {kr['vs_library']:.2f})"))
    check_reference(dev)
    check_reference_train(dev)
    check_reference_mamba(dev)
    served = serve(dev, "qwen3-1.7b")
    torch.cuda.empty_cache()
    served.update(ssd_scan=serve(dev, "mamba2-370m")["ssd_scan"])
    torch.cuda.empty_cache()
    trained, curve = train(dev)
    torch.cuda.empty_cache()
    train_plain(dev, curve)
    # each row's launches from the run of its path; the attention forward's
    # row is the serving shape and serve run, its training shape's the train
    # run; the backward's row holds each of its two kernels' counts
    for kr in kernels:
        name = kr["name"]
        if name == "flash_attention_bwd":
            kr["launches_by_kernel"] = {
                k: trained[k] for k in ("flash_bwd_dq_wgmma_kernel",
                                        "flash_bwd_dkdv_wgmma_kernel")}
            kr["launches"] = min(kr["launches_by_kernel"].values())
        elif name == "flash_attention":
            kr["launches"] = served["flash_fwd_wgmma_kernel"]
        else:
            kr["launches"] = (served if name in served else trained)[name]
    kernels[0]["train_shape"]["launches"] = trained["flash_fwd_wgmma_kernel"]
    print(f"all phases passed in {time.perf_counter() - _START:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
