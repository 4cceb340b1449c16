"""Split-KV flash decode: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_decode/kernel.py:flash_decode_pallas``. The
kernel itself is ``src/repro_torch/csrc/flash_decode.cu`` (CUDA C++ for
``sm_90a``, built at first use and loaded with ctypes); its header says
what bounds it on the card and how its design answers that.

:func:`flash_decode` is what the model calls. A CUDA tensor launches the
kernel, which writes one partial ``(m, l, acc)`` per split of
``DECODE_SPLIT`` keys; the splits are combined here in plain PyTorch, as
the Pallas wrapper combines its splits outside its kernel. A CPU tensor
takes the plain version, :func:`repro_torch.kernels.flash_decode.ref
.flash_decode_partial_ref` — the function the JAX model calls at
``models/attention.py:268-272``. There is no fallback from one to the other.
The kernel's outputs are written through ctypes, which autograd cannot see,
so the raw wrapper refuses to run while autograd records.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode.ref import flash_decode_partial_ref

SOURCE = "flash_decode.cu"
HEAD_DIMS = (64, 128)
DECODE_SPLIT = 64          # keys per split; the kernel's compiled SPLIT
MAX_GROUP = 16             # q heads per kv head the kernel holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (the wrapper adds one per launch)
launches = 0
_count_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load(SOURCE).repro_flash_decode_partials
    # q, k, v, cur_pos, m, l, acc; dtype, B, L, H, KV, D, split, k_offset,
    # window; sm_scale; stream
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_decode_cuda_partials(q, k, v, cur_pos, *, k_offset: int = 0,
                               sliding_window: int = 0,
                               sm_scale: Optional[float] = None):
    """Launch the CUDA kernel; returns the per-split float32 partials
    m, l (B, NS, H) and acc (B, NS, H, D), NS = ceil(L / DECODE_SPLIT)."""
    global launches
    _build.refuse_grad("flash_decode_cuda_partials",
                       "decode has no backward: run it under torch.no_grad()",
                       q, k, v)
    B, H, D = q.shape
    L, KV = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v), ("cur_pos", cur_pos)):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"flash_decode: {name} must be on q's card, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"flash_decode: {name} has dtype {t.dtype}; "
                             "the kernel takes one of bfloat16/float32, "
                             "the same as q")
    if cur_pos.dtype != torch.int32 or cur_pos.shape != (B,):
        raise ValueError("flash_decode: cur_pos must be int32 of shape (B,)")
    if k.shape != (B, L, KV, D) or v.shape != (B, L, KV, D) or H % KV:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in HEAD_DIMS or H // KV > MAX_GROUP:
        raise ValueError(f"flash_decode: head dim {D} / group {H // KV}; the "
                         f"kernel takes D = Dv in {HEAD_DIMS} and groups of "
                         f"at most {MAX_GROUP} q heads")
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    ns = -(-L // DECODE_SPLIT)
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.empty((B, ns, H), **f32)
    l = torch.empty((B, ns, H), **f32)
    acc = torch.empty((B, ns, H, D), **f32)
    fn = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cur_pos.data_ptr(),
                 m.data_ptr(), l.data_ptr(), acc.data_ptr(), _DTYPES[q.dtype],
                 B, L, H, KV, D, DECODE_SPLIT, int(k_offset),
                 int(sliding_window), float(sm_scale), stream)
    _build.check(err, "flash_decode")
    with _count_lock:
        launches += 1
    return m, l, acc


def combine_splits(m, l, acc):
    """Second-level P(max)/P(sum) reduction over the split axis (dim 1),
    as the Pallas wrapper does at ``flash_decode/kernel.py:106-111``."""
    m_g = m.amax(dim=1)
    scale = torch.where(torch.isfinite(m), torch.exp(m - m_g[:, None]), 0.0)
    l_g = (l * scale).sum(dim=1)
    acc_g = (acc * scale[..., None]).sum(dim=1)
    return m_g, l_g, acc_g


def flash_decode(q, k, v, *, cur_pos, k_offset: int = 0,
                 sliding_window: int = 0, k_positions=None,
                 sm_scale: Optional[float] = None):
    """One-token decode attention partials over a KV cache: (m, l, acc) of
    shapes (B, H), (B, H), (B, H, Dv), float32. CUDA tensors launch the
    kernel and combine its splits; CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_decode_partial_ref(q, k, v, k_offset=k_offset,
                                        cur_pos=cur_pos,
                                        sliding_window=sliding_window,
                                        k_positions=k_positions,
                                        sm_scale=sm_scale)
    if k_positions is not None:
        raise NotImplementedError(
            "flash_decode: k_positions (ring-buffer caches) is not in the "
            "CUDA kernel yet (ROADMAP Queue 2 item 3)")
    if cur_pos is None:
        raise ValueError("flash_decode: the CUDA kernel needs cur_pos")
    return combine_splits(*flash_decode_cuda_partials(
        q, k, v, cur_pos, k_offset=k_offset, sliding_window=sliding_window,
        sm_scale=sm_scale))
