"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas``.
The kernel itself is ``src/repro_torch/csrc/flash_attention.cu`` (CUDA C++
for ``sm_90a``, built at first use and loaded with ctypes); its header says
what bounds it on the card and how its design answers that.

:func:`flash_attention` is what the model calls. A CUDA tensor launches the
kernel (or the wrapper raises on what the kernel does not take); a CPU
tensor takes the plain PyTorch version, :func:`plain_flash_attention` —
the same function the JAX model calls at ``models/attention.py:148-154``.
There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_ref, flash_attention_triangular)

SOURCE = "flash_attention.cu"
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (the wrapper adds one per launch)
launches = 0
_count_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load(SOURCE).repro_flash_attention_fwd
    # q, k, v, o; dtype, B, Sq, Sk, H, KV, D, Dv, causal, window, q_offset;
    # sm_scale; stream
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def plain_flash_attention(q, k, v, *, causal: bool = True,
                          sliding_window: int = 0, q_offset: int = 0,
                          sm_scale: Optional[float] = None):
    """The plain version: causal self-attention takes the triangular
    (block-skipping) path, everything else the full blocked ref — the same
    dispatch as the JAX ``gqa_forward``."""
    if causal and q_offset == 0 and q.shape[1] == k.shape[1]:
        return flash_attention_triangular(q, k, v,
                                          sliding_window=sliding_window,
                                          sm_scale=sm_scale)
    return flash_attention_ref(q, k, v, causal=causal,
                               sliding_window=sliding_window,
                               q_offset=q_offset, sm_scale=sm_scale)


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         sliding_window: int = 0, q_offset: int = 0,
                         sm_scale: Optional[float] = None):
    """Launch the CUDA kernel. q (B, Sq, H, D), k (B, Sk, KV, D),
    v (B, Sk, KV, Dv), contiguous, one dtype (bf16 or float32), on one
    card; returns o (B, Sq, H, Dv) in q's dtype."""
    global launches
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} must be on q's card, "
                             f"got {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"flash_attention: {name} has dtype {t.dtype}; "
                             "the kernel takes one of bfloat16/float32")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"4-d tensor, got shape {tuple(t.shape)}")
    if k.shape != (B, Sk, KV, D) or v.shape[:3] != (B, Sk, KV) or H % KV:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in HEAD_DIMS or Dv != D:
        raise ValueError(f"flash_attention: head dims (D={D}, Dv={Dv}); the "
                         f"kernel takes D = Dv in {HEAD_DIMS}")
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    fn = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 _DTYPES[q.dtype], B, Sq, Sk, H, KV, D, Dv, int(causal),
                 int(sliding_window), int(q_offset), float(sm_scale), stream)
    _build.check(err, "flash_attention")
    with _count_lock:
        launches += 1
    return o


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                    q_offset: int = 0, sm_scale: Optional[float] = None):
    """Blocked attention forward: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, causal=causal,
                                     sliding_window=sliding_window,
                                     q_offset=q_offset, sm_scale=sm_scale)
    return flash_attention_cuda(q, k, v, causal=causal,
                                sliding_window=sliding_window,
                                q_offset=q_offset, sm_scale=sm_scale)
