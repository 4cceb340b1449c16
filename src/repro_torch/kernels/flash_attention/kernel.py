"""Flash attention: the CUDA kernels' wrappers, their autograd Function and
the plain version.

The forward replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas``; the
backward has no Pallas counterpart (the JAX model trains by autodiff through
``flash_attention_triangular``). The kernels are
``src/repro_torch/csrc/flash_attention.cu`` and ``flash_attention_bwd.cu``
(CUDA C++ for ``sm_90a``, built at first use and loaded with ctypes); their
headers say what bounds each on the card and how its design answers that.

Each source holds two versions of its kernels, and the input dtype chooses
between them: bf16 inputs launch the tensor-core kernels (``wgmma``), float32
inputs the CUDA-core ones (``wgmma`` takes no float32, and its TF32 mode
would miss the float32 checks at 1e-4). This dispatch is by dtype, stated
here; it is not a fallback, and nothing switches routes on an error. The
forward takes the head-dim pairs ``(D, Dv)`` of :data:`HEAD_DIMS` for its
dtype: ``D = Dv`` in {64, 128}, MLA's ``(192, 128)`` (deepseek-v2-lite's
prefill and training), and in float32 also ``(96, 64)`` (its reduced
config); the backward takes the same pairs (:data:`BWD_HEAD_DIMS`). A
CUDA tensor at any other pair raises. Every
launch adds one to ``launches``, ``bwd_dq_launches`` or
``bwd_dkdv_launches``; a tensor-core launch also adds one to its own
counter (``wgmma_launches``, ``bwd_dq_wgmma_launches``,
``bwd_dkdv_wgmma_launches``), and every forward launch and every backward
call (its dq and dk/dv pair) to its mask's count in ``mask_launches`` or
``bwd_mask_launches``: ``causal``, ``non_causal`` (Sq == Sk, an encoder)
or ``cross`` (non-causal, Sq != Sk).

:func:`flash_attention` is what the model calls. A CPU tensor takes the
plain PyTorch version, :func:`plain_flash_attention` -- the same function
the JAX model calls at ``models/attention.py:148-154`` -- and autograd runs
through it. A CUDA tensor launches the forward kernel; when autograd records
(an input requires grad) it goes through :class:`FlashAttention`, whose
forward also keeps the logsumexp and whose backward launches the backward
kernels: causal self-attention (an optional sliding window), and
non-causal self- and cross-attention (Sq != Sk: whisper's encoder and
decoder), at q_offset 0 (:func:`check_backward_scope` raises on the
rest). There is no fallback from one to the other.

The raw wrappers :func:`flash_attention_cuda` and
:func:`flash_attention_bwd_cuda` write their outputs through ctypes, which
autograd cannot see, so they refuse to run while autograd records.
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
BWD_SOURCE = "flash_attention_bwd.cu"
#: the (D, Dv) head-dim pairs the forward kernel takes, by dtype
HEAD_DIMS = {torch.bfloat16: ((64, 64), (128, 128), (192, 128)),
             torch.float32: ((64, 64), (128, 128), (192, 128), (96, 64))}
#: the (D, Dv) head-dim pairs the backward kernels take, by dtype: the
#: forward's, each of which a training path can reach
BWD_HEAD_DIMS = HEAD_DIMS
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_USE = ("call repro_torch.kernels.flash_attention.flash_attention (its "
        "FlashAttention Function) instead")

#: forward kernel launches since the last reset (one per launch)
launches = 0
#: backward dq kernel launches since the last reset (one per launch)
bwd_dq_launches = 0
#: backward dk/dv kernel launches since the last reset (one per launch)
bwd_dkdv_launches = 0
#: of those, the tensor-core (bf16) kernels' launches: forward, dq, dk/dv
wgmma_launches = 0
bwd_dq_wgmma_launches = 0
bwd_dkdv_wgmma_launches = 0
#: forward launches and backward calls by mask since the last reset
mask_launches = {"causal": 0, "non_causal": 0, "cross": 0}
bwd_mask_launches = {"causal": 0, "non_causal": 0, "cross": 0}
_count_lock = threading.Lock()


def _mask(causal: bool, Sq: int, Sk: int) -> str:
    return "causal" if causal else "non_causal" if Sq == Sk else "cross"


def reset_counts() -> None:
    """Zero every launch counter of this module."""
    global launches, bwd_dq_launches, bwd_dkdv_launches, wgmma_launches
    global bwd_dq_wgmma_launches, bwd_dkdv_wgmma_launches
    with _count_lock:
        launches = bwd_dq_launches = bwd_dkdv_launches = 0
        wgmma_launches = bwd_dq_wgmma_launches = bwd_dkdv_wgmma_launches = 0
        for counts in (mask_launches, bwd_mask_launches):
            counts.update(dict.fromkeys(counts, 0))


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load(SOURCE).repro_flash_attention_fwd
    # q, k, v, o, lse; dtype, B, Sq, Sk, H, KV, D, Dv, causal, window,
    # q_offset; sm_scale; stream
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_fns():
    lib = _build.load(BWD_SOURCE)
    dq = lib.repro_flash_attention_bwd_dq
    # q, k, v, dout, lse, delta, dq; dtype, B, Sq, Sk, H, KV, D, Dv, causal,
    # window; sm_scale; stream
    dq.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    dq.restype = ctypes.c_int
    dkdv = lib.repro_flash_attention_bwd_dkdv
    # q, k, v, dout, lse, delta, dk, dv; dtype, B, Sq, Sk, H, KV, D, Dv,
    # causal, window; sm_scale; stream
    dkdv.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                     + [ctypes.c_float, ctypes.c_void_p])
    dkdv.restype = ctypes.c_int
    return dq, dkdv


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


def _check_inputs(what: str, **tensors) -> None:
    """One card, one dtype the kernels take, contiguous 4-d tensors."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device != first.device or t.device.type != "cuda":
            raise ValueError(f"{what}: {name} must be on q's card, "
                             f"got {t.device}")
        if t.dtype != first.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{what}: {name} has dtype {t.dtype}; "
                             "the kernel takes one of bfloat16/float32")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"4-d tensor, got shape {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte "
                             "boundary (the kernels copy 16-byte chunks)")


def check_head_dims(dtype: torch.dtype, D: int, Dv: int,
                    backward: bool = False) -> None:
    """Raise unless the forward (or, with ``backward``, the backward)
    kernel takes head dims ``(D, Dv)`` at ``dtype``."""
    table, what = ((BWD_HEAD_DIMS, "flash_attention backward") if backward
                   else (HEAD_DIMS, "flash_attention"))
    if (D, Dv) not in table.get(dtype, ()):
        raise ValueError(
            f"{what}: head dims (D={D}, Dv={Dv}) in {dtype}; the kernel "
            "takes (D, Dv) in " + "; ".join(
                f"{t}: {p}" for t, p in table.items()))


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         sliding_window: int = 0, q_offset: int = 0,
                         sm_scale: Optional[float] = None,
                         return_lse: bool = False):
    """Launch the forward kernel: the tensor-core one for bf16, the
    CUDA-core one for float32. q (B, Sq, H, D), k (B, Sk, KV, D),
    v (B, Sk, KV, Dv), contiguous, one dtype, on one card; returns
    o (B, Sq, H, Dv) in q's dtype, and with ``return_lse`` also each row's
    float32 logsumexp of its scaled scores, (B, H, Sq)."""
    global launches, wgmma_launches
    _build.refuse_grad("flash_attention_cuda", _USE, q, k, v)
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    _check_inputs("flash_attention", q=q, k=k, v=v)
    if k.shape != (B, Sk, KV, D) or v.shape[:3] != (B, Sk, KV) or H % KV:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    check_head_dims(q.dtype, D, Dv)
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 _DTYPES[q.dtype], B, Sq, Sk, H, KV, D, Dv, int(causal),
                 int(sliding_window), int(q_offset), float(sm_scale), stream)
    _build.check(err, "flash_attention")
    with _count_lock:
        launches += 1
        wgmma_launches += int(q.dtype == torch.bfloat16)
        mask_launches[_mask(causal, Sq, Sk)] += 1
    return (o, lse) if return_lse else o


def check_backward_scope(causal: bool, sliding_window: int,
                         q_offset: int) -> None:
    """Raise for what the backward kernels do not take: a ``q_offset``
    (ROADMAP Queue 2 item 2(b)), or a sliding window without causal
    masking (no training path gives one)."""
    if q_offset:
        raise NotImplementedError(
            "flash_attention: the CUDA backward takes q_offset 0 only; "
            "q_offset > 0 is ROADMAP Queue 2 item 2(b)")
    if sliding_window and not causal:
        raise NotImplementedError(
            "flash_attention: the CUDA backward takes a sliding window "
            "with causal masking only (no training path gives another; "
            "ROADMAP Queue 2 item 2 lists the backward's scope)")


def flash_attention_bwd_cuda(q, k, v, lse, do, *, causal: bool = True,
                             sliding_window: int = 0,
                             sm_scale: Optional[float] = None):
    """Launch the backward kernels (q_offset 0), the dq kernel and then
    the dk/dv kernel (tensor cores for bf16, CUDA cores for float32):
    causal self-attention (Sq == Sk, an optional sliding window), or
    without ``causal`` non-causal self-attention (an encoder) and
    cross-attention (Sq != Sk). q (B, Sq, H, D), k (B, Sk, KV, D), v (B,
    Sk, KV, Dv), do (B, Sq, H, Dv), one dtype, contiguous, ``(D, Dv)`` in
    :data:`BWD_HEAD_DIMS`; ``lse`` (B, H, Sq) float32 from the forward.
    Returns (dq, dk, dv) in q's dtype, shaped as q, k and v."""
    global bwd_dq_launches, bwd_dkdv_launches
    global bwd_dq_wgmma_launches, bwd_dkdv_wgmma_launches
    _build.refuse_grad("flash_attention_bwd_cuda", _USE, q, k, v, do)
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    _check_inputs("flash_attention backward", q=q, k=k, v=v, do=do)
    check_head_dims(q.dtype, D, Dv, backward=True)
    check_backward_scope(causal, sliding_window, 0)
    if (k.shape != (B, Sk, KV, D) or v.shape != (B, Sk, KV, Dv) or H % KV
            or do.shape != (B, Sq, H, Dv)):
        raise ValueError(f"flash_attention backward: shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, do {tuple(do.shape)}")
    if (lse.dtype != torch.float32 or lse.shape != (B, H, Sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("flash_attention backward: lse must be contiguous "
                         f"float32 (B, H, Sq) on q's card, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    # each row's rowsum(dO * O), written by the dq kernel for the dk/dv one
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dq_fn, dkdv_fn = _bwd_fns()
    shape = (_DTYPES[q.dtype], B, Sq, Sk, H, KV, D, Dv, int(causal),
             int(sliding_window), float(sm_scale))
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    tc = q.dtype == torch.bfloat16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = dq_fn(*ins, dq.data_ptr(), *shape, stream)
        _build.check(err, "flash_attention backward (dq)")
        with _count_lock:
            bwd_dq_launches += 1
            bwd_dq_wgmma_launches += int(tc)
        err = dkdv_fn(*ins, dk.data_ptr(), dv.data_ptr(), *shape, stream)
        _build.check(err, "flash_attention backward (dk, dv)")
        with _count_lock:
            bwd_dkdv_launches += 1
            bwd_dkdv_wgmma_launches += int(tc)
            bwd_mask_launches[_mask(causal, Sq, Sk)] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention on the card with a backward -- causal or not, self- or
    cross-attention: the forward kernel (which also writes the logsumexp
    of every q row), then the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sliding_window: int, sm_scale):
        o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                      sliding_window=sliding_window,
                                      sm_scale=sm_scale, return_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.sliding_window = causal, sliding_window
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, lse, do.contiguous(), causal=ctx.causal,
            sliding_window=ctx.sliding_window, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                    q_offset: int = 0, sm_scale: Optional[float] = None):
    """Blocked attention: the CUDA kernels for CUDA tensors (through
    :class:`FlashAttention` when autograd records), the plain version for
    CPU tensors."""
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, causal=causal,
                                     sliding_window=sliding_window,
                                     q_offset=q_offset, sm_scale=sm_scale)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return flash_attention_cuda(q, k, v, causal=causal,
                                    sliding_window=sliding_window,
                                    q_offset=q_offset, sm_scale=sm_scale)
    check_backward_scope(causal, sliding_window, q_offset)
    check_head_dims(q.dtype, q.shape[-1], v.shape[-1], backward=True)
    return FlashAttention.apply(q, k, v, bool(causal), int(sliding_window),
                                sm_scale)
