"""Smoke run of the PyTorch port on one NVIDIA card: kernels, then serving.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own lines; any failure exits non-zero before the
result line is printed:

1. device and build: the card's name and power limit (``nvidia-smi``), then
   both CUDA kernels of the serving path built from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, started together);
2. kernels: each kernel against its plain PyTorch version at the shapes the
   serving path gives it (decode also against the plain version on float32
   copies of the same inputs, which is the kernel's own arithmetic), with
   the kernel's device time (torch.profiler), the wrapper call's, the plain
   version's, the least time the card could take (bytes over 3.35 TB/s or
   operations over 989 TFLOP/s, whichever is larger) and one
   ``scaled_dot_product_attention`` call as a yardstick (timed here only;
   the port never calls it);
3. reference: the reduced qwen3 config served through the kernels agrees
   with the same weights on the CPU's plain path (prefill and decode logits);
4. serve: qwen3-1.7b at full width, bf16, seeded init, through
   ``repro_torch.api.compile(backend="actors", stages=2)`` — 12 requests of
   64-512 prompt tokens and 8-48 new tokens in 2 groups of 4 slots; then
   the same requests on ``backend="monolithic"``, which must give the same
   tokens. Around each of the two runs the kernels' launch counters are
   zeroed just before and read just after, and must equal the launches the
   scheduler's work implies. One more monolithic run under torch.profiler
   gives the device's busy share and its kernels by time.

The last two lines are the kernel table as one JSON object and the result
``{"ok": true, "device": {...}}``. It imports nothing of jax.
"""
from __future__ import annotations

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
# Kernel vs plain version at the path shapes, bf16 inputs: set from the
# measured max abs errors 9.8e-4 (attention: bf16 rounding of the output)
# and 4.1e-3 (decode: the plain version rounds its scores to bf16, as JAX's
# einsum does; the kernel keeps them in float32).
ATOL, RTOL = 5e-3, 1e-2
# decode kernel vs the plain version on float32 copies of the same inputs:
# the same arithmetic, so only the order of float32 sums differs
F32_TOL = 1e-4
SEED = 0


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


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


def kernel_ms(fn, kernel: str, iters: int = 20, warmup: int = 3):
    """Mean device time of one launch of the kernel whose name contains
    ``kernel``, from torch.profiler's device trace over ``iters`` calls of
    ``fn`` after ``warmup`` calls; None if the trace holds no such kernel."""
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
          and kernel in e.key]
    if not ev:
        return None
    return (sum(e.self_device_time_total for e in ev)
            / sum(e.count for e in ev) / 1e3)


def timed(entry: dict, kernel: str, launch, wrapper) -> dict:
    """Fill ``ms`` (the kernel's own device time; CUDA events around
    ``launch`` if the profiler saw no device events) and ``wrapper_ms``
    (CUDA events around the wrapper call the model makes)."""
    ms = kernel_ms(launch, kernel)
    if ms is None:
        print(f"{kernel}: the profiler saw no device events; ms is from "
              "CUDA events around the launch call")
        ms = cuda_ms(launch)
    entry["ms"] = ms
    entry["wrapper_ms"] = cuda_ms(wrapper)
    return entry


def agree(name: str, got, want, atol: float, rtol: float) -> float:
    """Max abs error of ``got`` against ``want``; raise past the limit."""
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
    print(f"{name}: max_abs_err {err:.3e} (limit {atol} + {rtol}*|ref|) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             "version")
    return err


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
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
    t0 = time.perf_counter()
    _build.build([fa.SOURCE, fd.SOURCE])
    print(f"built {fa.SOURCE}, {fd.SOURCE} in "
          f"{time.perf_counter() - t0:.1f} s "
          f"(per source: {_build.build_seconds})")
    for src in (fa.SOURCE, fd.SOURCE):
        log = _build.library_path(src).with_suffix(".log").read_text()
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"ptxas {src}: " + " | ".join(usage))
    return smi


def check_flash_attention(dev):
    from repro_torch.kernels.flash_attention import kernel as fa
    B, S, H, KV, D = 1, 512, 16, 8, 128
    rng = np.random.default_rng(SEED)
    mk = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)
    q, k, v = mk(B, S, H, D), mk(B, S, KV, D), mk(B, S, KV, D)
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.plain_flash_attention(q, k, v, causal=True)
    err = agree(f"flash_attention q{tuple(q.shape)} kv{tuple(k.shape)} "
                "causal bf16", got, want, ATOL, RTOL)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = S * (S + 1) // 2                     # causal: unmasked (q, k)
    b_ms, b_by = bound_ms(nbytes(q, k, v, got), 4 * D * H * B * pairs)
    launch = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
    return timed({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:75",
        "max_abs_err": err,
        "plain_ms": cuda_ms(
            lambda: fa.plain_flash_attention(q, k, v, causal=True), iters=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.nn.functional
                              .scaled_dot_product_attention(
                                  qt, kt, vt, is_causal=True,
                                  enable_gqa=True)),
    }, "flash_fwd_kernel", launch, launch)


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


def serve(dev):
    """The main path: full-width qwen3-1.7b on the stage actors, then the
    same requests on the monolithic engine, each run's kernel launches
    counted and checked. Returns the launch counts of the actor run."""
    phase("serve (qwen3-1.7b, full width, bf16, actors x 2 stages)")
    from repro_torch import api
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_decode import kernel as fd

    cfg = get_config("qwen3-1.7b")
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
        fa.launches = 0
        fd.launches = 0
        out = session.generate(requests)
        got = {"flash_attention": fa.launches, "flash_decode": fd.launches}
        st = session.last_stats
        L = cfg.num_layers
        want = {"flash_attention": n_req * L,
                "flash_decode": L * st["decode_items"]}
        print(f"launches on the {session.backend} run: {got} (expected "
              f"{want}: {n_req} x {L} and {L} x {st['decode_items']} "
              "decode items)")
        if got != want:
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
    profile_generate(mono, requests)
    mono.close()
    return launches


def profile_generate(sess, requests, top: int = 8):
    """Where the time goes: the device's busy time and its kernels by name
    over one more ``generate`` of the same requests, from torch.profiler's
    device trace (the profiler's own cost is in the wall time)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.generate(requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        print(f"profiled generate: {wall:.3f} s wall; the trace holds no "
              "device events, so the idle share is not measured")
        return
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    print(f"profiled {sess.backend} generate: {wall:.3f} s wall (profiler "
          f"on), device busy {busy:.3f} s, idle share {1 - busy / wall:.3f}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms  {e.count:6d} x  "
              f"{e.key[:90]}")


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
    kernels = [check_flash_attention(dev), check_flash_decode(dev)]
    for kr in kernels:
        print(f"{kr['name']}: kernel {kr['ms']:.4f} ms, wrapper call "
              f"{kr['wrapper_ms']:.4f} ms, plain {kr['plain_ms']:.4f} "
              f"ms, bound {kr['bound_ms']:.4f} ms ({kr['bound_by']}), "
              f"sdpa {kr['library_ms']:.4f} ms")
    check_reference(dev)
    launches = serve(dev)
    for kr in kernels:
        kr["launches"] = launches[kr["name"]]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
