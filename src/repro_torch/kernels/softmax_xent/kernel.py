"""Sharded-vocab xent local stats: the CUDA kernels' wrappers, their
autograd Function and the plain version.

The forward replaces the Pallas TPU kernel
``src/repro/kernels/softmax_xent/kernel.py:xent_local_stats_pallas``; the
backward has no Pallas counterpart (the JAX model trains by autodiff of
``local_stats_ref``). Both kernels are ``src/repro_torch/csrc/softmax_xent.cu``
(CUDA C++ for ``sm_90a``, built at first use and loaded with ctypes); its
header says what bounds them on the card and how the design answers that.

:func:`xent_local_stats` is what ``lm_loss`` calls. A CPU tensor takes the
plain version, :func:`repro_torch.kernels.softmax_xent.ref.local_stats_ref`
-- the function the JAX model calls at ``models/transformer.py:338-341`` --
and autograd runs through it. A CUDA tensor goes through
:class:`XentLocalStats`: the forward kernel, then on backward the backward
kernel. There is no fallback from one to the other. The raw wrappers write
their outputs through ctypes, which autograd cannot see, so they refuse to
run while autograd records.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.softmax_xent.ref import local_stats_ref

SOURCE = "softmax_xent.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_USE = ("call repro_torch.kernels.softmax_xent.xent_local_stats (its "
        "XentLocalStats Function) instead")

#: forward kernel launches since the last reset (one per launch)
launches = 0
#: backward kernel launches since the last reset (one per launch)
bwd_launches = 0
#: launches by vocab offset since the last reset: {offset: count}, forward
#: and backward (a vocab shard's launches carry its shard's offset)
offset_launches: Dict[int, int] = {}
bwd_offset_launches: Dict[int, int] = {}
_count_lock = threading.Lock()


def reset_counts() -> None:
    """Zero every launch counter of this module."""
    global launches, bwd_launches
    with _count_lock:
        launches = bwd_launches = 0
        offset_launches.clear()
        bwd_offset_launches.clear()


@functools.lru_cache(maxsize=None)
def _fns():
    lib = _build.load(SOURCE)
    fwd = lib.repro_xent_local_stats_fwd
    # logits, labels, m, s, z; dtype, N, Vl, vocab_offset; stream
    fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.repro_xent_local_stats_bwd
    # logits, labels, m, ds, dz, dlogits; dtype, N, Vl, vocab_offset; stream
    bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(what: str, logits, labels, **stats) -> None:
    """logits (N, Vl) bf16/float32 and labels (N,) int32 on one card, and
    float32 (N,) stats, all contiguous."""
    N = logits.shape[0] if logits.dim() == 2 else -1
    for name, t in (("logits", logits), ("labels", labels), *stats.items()):
        if t.device != logits.device or t.device.type != "cuda":
            raise ValueError(f"{what}: {name} must be on the logits' card, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if logits.dim() != 2 or logits.dtype not in _DTYPES:
        raise ValueError(f"{what}: logits must be (N, Vl) bfloat16/float32, "
                         f"got {logits.dtype} {tuple(logits.shape)}")
    if labels.dtype != torch.int32 or labels.shape != (N,):
        raise ValueError(f"{what}: labels must be int32 of shape ({N},)")
    for name, t in stats.items():
        if t.dtype != torch.float32 or t.shape != (N,):
            raise ValueError(f"{what}: {name} must be float32 of shape ({N},)")


def xent_local_stats_cuda(logits, labels, vocab_offset: int = 0):
    """Launch the forward kernel: (m, s, z), float32 (N,) each."""
    global launches
    _build.refuse_grad("xent_local_stats_cuda", _USE, logits)
    _check("xent_local_stats", logits, labels)
    N, Vl = logits.shape
    m, s, z = (torch.empty((N,), dtype=torch.float32, device=logits.device)
               for _ in range(3))
    fwd, _ = _fns()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = fwd(logits.data_ptr(), labels.data_ptr(), m.data_ptr(),
                  s.data_ptr(), z.data_ptr(), _DTYPES[logits.dtype], N, Vl,
                  int(vocab_offset), stream)
    _build.check(err, "xent_local_stats")
    with _count_lock:
        launches += 1
        offset_launches[int(vocab_offset)] = offset_launches.get(
            int(vocab_offset), 0) + 1
    return m, s, z


def xent_local_stats_bwd_cuda(logits, labels, vocab_offset: int, m, ds, dz):
    """Launch the backward kernel: dlogits (N, Vl) in the logits' dtype,
    ``ds * exp(logits - m)`` plus ``dz`` at each row's label column."""
    global bwd_launches
    _build.refuse_grad("xent_local_stats_bwd_cuda", _USE, logits, ds, dz)
    _check("xent_local_stats backward", logits, labels, m=m, ds=ds, dz=dz)
    N, Vl = logits.shape
    dlogits = torch.empty_like(logits)
    _, bwd = _fns()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = bwd(logits.data_ptr(), labels.data_ptr(), m.data_ptr(),
                  ds.data_ptr(), dz.data_ptr(), dlogits.data_ptr(),
                  _DTYPES[logits.dtype], N, Vl, int(vocab_offset), stream)
    _build.check(err, "xent_local_stats backward")
    with _count_lock:
        bwd_launches += 1
        bwd_offset_launches[int(vocab_offset)] = bwd_offset_launches.get(
            int(vocab_offset), 0) + 1
    return dlogits


class XentLocalStats(torch.autograd.Function):
    """(m, s, z) on the card with a backward. ``m`` is not differentiable
    (the reference's ``stop_gradient``); the gradient reaches the logits
    through ``s`` and ``z`` only."""

    @staticmethod
    def forward(ctx, logits, labels, vocab_offset: int):
        m, s, z = xent_local_stats_cuda(logits, labels, vocab_offset)
        ctx.save_for_backward(logits, labels, m)
        ctx.vocab_offset = vocab_offset
        ctx.mark_non_differentiable(m)
        return m, s, z

    @staticmethod
    def backward(ctx, dm, ds, dz):
        logits, labels, m = ctx.saved_tensors
        dlogits = xent_local_stats_bwd_cuda(
            logits, labels, ctx.vocab_offset, m, ds.float().contiguous(),
            dz.float().contiguous())
        return dlogits, None, None


def xent_local_stats(logits, labels, vocab_offset: int = 0):
    """Per-row local stats (m, s, z) of a vocab shard: the CUDA kernels for
    CUDA tensors (through :class:`XentLocalStats` when autograd records),
    the plain version for CPU tensors."""
    if logits.device.type == "cpu":
        return local_stats_ref(logits, labels, vocab_offset)
    if torch.is_grad_enabled() and logits.requires_grad:
        return XentLocalStats.apply(logits, labels, int(vocab_offset))
    return xent_local_stats_cuda(logits, labels, vocab_offset)
