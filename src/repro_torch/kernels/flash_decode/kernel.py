"""Split-KV flash decode: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_decode/kernel.py:flash_decode_pallas`` and its
wrapper's split combine. The kernel itself is
``src/repro_torch/csrc/flash_decode.cu`` (CUDA C++ for ``sm_90a``, built at
first use and loaded with ctypes); its header says what bounds it on the
card and how its design answers that.

:func:`flash_decode` is what the model calls. A CUDA tensor launches the
kernel, which computes one partial ``(m, l, acc)`` per split of
``DECODE_SPLIT`` keys and combines the splits itself (the last block of
each group folds them in split order, :func:`combine_splits` is that
fold's plain version): one launch, and no PyTorch op on the card between
it and the returned tensors. A CPU tensor takes the plain version,
:func:`repro_torch.kernels.flash_decode.ref.flash_decode_partial_ref` — the
function the JAX model calls at ``models/attention.py:268-272``. There is
no fallback from one to the other. The kernel's outputs are written
through ctypes, which autograd cannot see, so the raw wrapper refuses to
run while autograd records.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional, Tuple

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
# the kernel's combine tickets, one zeroed int32 per (batch row, kv head),
# kept per (device, stream): the kernel leaves them zero, and calls on one
# stream never overlap
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load(SOURCE).repro_flash_decode
    # q, k, v, cur_pos, out, tickets; dtype, B, L, H, KV, D, split,
    # k_offset, window; sm_scale; stream
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _tickets_for(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    with _count_lock:
        t = _tickets.get(key)
        if t is None or t.numel() < n:
            t = _tickets[key] = torch.zeros(n, dtype=torch.int32,
                                            device=device)
    return t


def flash_decode_cuda_partials(q, k, v, cur_pos, *, k_offset: int = 0,
                               sliding_window: int = 0,
                               sm_scale: Optional[float] = None):
    """Launch the CUDA kernel; returns this cache's float32 partials
    m, l (B, H) and acc (B, H, D), its splits combined on the card."""
    global launches
    _build.refuse_grad("flash_decode_cuda_partials",
                       "decode has no backward: run it under torch.no_grad()",
                       q, k, v)
    B, H, D = q.shape
    L, KV = k.shape[1], k.shape[2]
    dev = q.device
    named = (("q", q), ("k", k), ("v", v), ("cur_pos", cur_pos))
    # the checks run on every decode step: one pass, messages only on error
    if dev.type != "cuda" or not all(t.device == dev for _, t in named[1:]):
        name, t = next((n, t) for n, t in named
                       if t.device != dev or t.device.type != "cuda")
        raise ValueError(f"flash_decode: {name} must be on q's card, "
                         f"got {t.device}")
    if not all(t.is_contiguous() for _, t in named):
        name = next(n for n, t in named if not t.is_contiguous())
        raise ValueError(f"flash_decode: {name} must be contiguous")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_decode: q, k, v have dtypes {q.dtype}, "
                         f"{k.dtype}, {v.dtype}; the kernel takes one of "
                         "bfloat16/float32 for all three")
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
    # m, l (B, H), acc (B, H, D), then the splits' partials: one allocation
    bh = B * H
    out = torch.empty(bh * (D + 2) * (1 + -(-L // DECODE_SPLIT)),
                      dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _tickets_for(dev, stream, B * KV)
    with torch.cuda.device(dev):
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    cur_pos.data_ptr(), out.data_ptr(), tickets.data_ptr(),
                    _DTYPES[q.dtype], B, L, H, KV, D, DECODE_SPLIT,
                    int(k_offset), int(sliding_window), float(sm_scale),
                    stream)
    _build.check(err, "flash_decode")
    with _count_lock:
        launches += 1
    return (out.as_strided((B, H), (H, 1), 0),
            out.as_strided((B, H), (H, 1), bh),
            out.as_strided((B, H, D), (H * D, D, 1), 2 * bh))


def combine_splits(m, l, acc):
    """The kernel's split combine, in plain PyTorch: partials stacked on
    dim 1 (splits) folded in split order, as the last block of each group
    folds them -- the second-level P(max)/P(sum) reduction of the Pallas
    wrapper (``flash_decode/kernel.py:106-111``)."""
    m_g = m.amax(dim=1)
    l_g = torch.zeros_like(l[:, 0])
    acc_g = torch.zeros_like(acc[:, 0])
    for s in range(m.shape[1]):
        w = torch.exp(m[:, s] - m_g)
        l_g = l_g + l[:, s] * w
        acc_g = acc_g + acc[:, s] * w[..., None]
    return m_g, l_g, acc_g


def flash_decode(q, k, v, *, cur_pos, k_offset: int = 0,
                 sliding_window: int = 0, k_positions=None,
                 sm_scale: Optional[float] = None):
    """One-token decode attention partials over a KV cache: (m, l, acc) of
    shapes (B, H), (B, H), (B, H, Dv), float32. CUDA tensors launch the
    kernel, which combines its splits; CPU tensors take the plain
    version."""
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
    return flash_decode_cuda_partials(
        q, k, v, cur_pos, k_offset=k_offset, sliding_window=sliding_window,
        sm_scale=sm_scale)
