"""Mamba-2 SSD chunked scan: the CUDA kernels' wrappers, their autograd
Function and the plain version.

The forward replaces the Pallas TPU kernel
``src/repro/kernels/ssd_scan/kernel.py:ssd_scan_pallas``; the backward has
no Pallas counterpart (the JAX model trains by autodiff through the jnp
``ssd_chunked_ref``). The kernels are ``src/repro_torch/csrc/ssd_scan.cu``
and ``ssd_scan_bwd.cu`` (CUDA C++ for ``sm_90a``, built at first use and
loaded with ctypes); their headers say what bounds each on the card and how
its design answers that.

The input dtype (and for the backward the shape) chooses the kernels, and
this dispatch is stated here; it is not a fallback, and nothing switches
routes on an error. The forward: bf16 runs three tensor-core (``wgmma``)
kernels over the chunk-parallel form (chunk states, the carry over chunks, the
outputs) and needs P <= 128; float32 runs the CUDA-core kernel (``wgmma``
takes no float32, and its TF32 mode would miss the float32 checks at
1e-4). Every forward call adds one to ``launches``, whatever the number of
kernels it runs; a bf16 call also adds one to ``wgmma_launches``. The
backward (:func:`bwd_kernels`): bf16 at P <= 64, or P <= 128 with N <= 64,
runs ``BWD_TC_KERNELS`` (the state pass and the chunk pass on the tensor
cores, the carry, the head-sum reduce); float32, and bf16 past those tiles
(P > 64 with N > 64, or P > 128: the chunk pass's tiles would not fit in a
block's shared memory), runs ``BWD_KERNELS``, five CUDA-core kernels in
float32 math (state, carry, inter, intra, reduce). Each launch adds one to
its kernel's entry of ``bwd_launches`` (the carry and the reduce are the
same kernels on both routes), and a call on the tensor-core route adds one
to ``bwd_wgmma_launches``.

:func:`ssd_scan` is what the model calls (``models/mamba.py``, at the
reference's ``ssd_chunked_ref`` call site). A CPU tensor takes the plain
version, :func:`repro_torch.kernels.ssd_scan.ref.ssd_chunked_ref`, and
autograd runs through it. A CUDA tensor launches the forward kernels; when
autograd records (an input requires grad) it goes through :class:`SsdScan`,
whose backward launches the backward kernels. There is no fallback from one
to the other. The raw wrappers :func:`ssd_scan_cuda` and
:func:`ssd_scan_bwd_cuda` write their outputs through ctypes, which
autograd cannot see, so they refuse to run while autograd records.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref

SOURCE = "ssd_scan.cu"
BWD_SOURCE = "ssd_scan_bwd.cu"
MAX_CHUNK = 128            # the kernel's QMAX
MAX_STATE = 128            # the kernel's NMAX
MAX_TC_HEAD = 128          # the tensor-core kernels' largest P
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel calls since the last reset (the wrapper adds one per call)
launches = 0
#: of those, the calls that ran the tensor-core (bf16) kernels
wgmma_launches = 0
#: the CUDA-core backward's kernels (float32, and bf16 past the tensor-core
#: tiles), in launch order
BWD_KERNELS = ("ssd_bwd_state_kernel", "ssd_bwd_carry_kernel",
               "ssd_bwd_inter_kernel", "ssd_bwd_intra_kernel",
               "ssd_bwd_reduce_kernel")
#: the tensor-core backward's kernels (bf16; state and chunk on wgmma), in
#: launch order
BWD_TC_KERNELS = ("ssd_bwd_tc_state_kernel", "ssd_bwd_carry_kernel",
                  "ssd_bwd_tc_chunk_kernel", "ssd_bwd_reduce_kernel")
#: each backward kernel's pass number in ``repro_ssd_scan_bwd``
_BWD_PASS = {**{k: i for i, k in enumerate(BWD_KERNELS)},
             "ssd_bwd_tc_state_kernel": 5, "ssd_bwd_tc_chunk_kernel": 6}
#: backward kernel launches since the last reset, by kernel (one per launch)
bwd_launches = dict.fromkeys(BWD_KERNELS + BWD_TC_KERNELS, 0)
#: backward calls that ran the tensor-core kernels
bwd_wgmma_launches = 0
_count_lock = threading.Lock()
_USE = ("call repro_torch.kernels.ssd_scan.ssd_scan (its SsdScan Function) "
        "instead")


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load(SOURCE).repro_ssd_scan
    # x, dt, A, Bm, Cm, D, y, hT, scratch; dtype, B, L, H, P, G, N, Q;
    # strides; stream
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    fn = _build.load(BWD_SOURCE).repro_ssd_scan_bwd
    # pass; x, dt, A, Bm, Cm, D, dy, dhT, dx, ddt, dA, dBm, dCm, dD, scratch;
    # dtype, B, L, H, P, G, N, Q; stream
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 15
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def reset_counts() -> None:
    """Zero every launch counter of the forward and the backward."""
    global launches, wgmma_launches, bwd_wgmma_launches
    with _count_lock:
        launches = wgmma_launches = bwd_wgmma_launches = 0
        bwd_launches.update(dict.fromkeys(bwd_launches, 0))


def _check(what: str, x, dt, A, Bm, Cm, D):
    """One card, the dtypes and shapes the kernels take; returns
    ``(B, L, H, P, G, N)``."""
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                    ("D", D)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{what}: {name} must be on x's card, got "
                             f"{t.device}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"{what}: x, Bm, Cm have dtypes {x.dtype}, "
                         f"{Bm.dtype}, {Cm.dtype}; the kernel takes one of "
                         "bfloat16/float32 for all three")
    if any(t.dtype != torch.float32 for t in (dt, A, D)):
        raise ValueError(f"{what}: dt, A and D must be float32")
    if (dt.shape != (B, L, H) or Bm.shape != (B, L, G, N)
            or Cm.shape != (B, L, G, N) or A.shape != (H,)
            or D.shape != (H,) or H % G):
        raise ValueError(f"{what}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}, A {tuple(A.shape)}, D "
                         f"{tuple(D.shape)}")
    return B, L, H, P, G, N


def _chunk_of(what: str, chunk: int, L: int, N: int) -> int:
    Q = min(chunk, L)
    if not (1 <= Q <= MAX_CHUNK) or N > MAX_STATE:
        raise ValueError(f"{what}: chunk {Q} / state size {N}; the kernels "
                         f"take chunks of at most {MAX_CHUNK} steps and "
                         f"states of at most {MAX_STATE}")
    return Q


def ssd_scan_cuda(x, dt, A, Bm, Cm, D, *, chunk: int = 128):
    """Launch the CUDA kernels: the tensor-core ones for bf16, the
    CUDA-core one for float32. Returns ``(y, hT)``: y (B, L, H, P) in x's
    dtype, hT (B, H, P, N) float32. x, Bm and Cm share one dtype (bfloat16
    or float32) and are read through their strides; dt, A and D are
    float32."""
    global launches, wgmma_launches
    _build.refuse_grad("ssd_scan_cuda", _USE, x, dt, A, Bm, Cm, D)
    B, L, H, P, G, N = _check("ssd_scan", x, dt, A, Bm, Cm, D)
    Q = _chunk_of("ssd_scan", chunk, L, N)
    tc = x.dtype == torch.bfloat16
    if tc and P > MAX_TC_HEAD:
        raise ValueError(f"ssd_scan: head dim {P}; the bf16 (tensor-core) "
                         f"kernels take at most {MAX_TC_HEAD}")
    A, D = A.contiguous(), D.contiguous()
    y = torch.empty((B, L, H, P), dtype=x.dtype, device=x.device)
    hT = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    # bf16: each chunk's state and cs_last, an allocation of its own so that
    # it is freed when the call returns (callers keep hT, one per layer)
    nc = -(-L // Q)
    scratch = (torch.empty(B * H * nc * (P * N + 1), dtype=torch.float32,
                           device=x.device) if tc else None)
    strides = (ctypes.c_longlong * 15)(*x.stride(), *dt.stride(),
                                       *Bm.stride(), *Cm.stride())
    fn = _fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), D.data_ptr(), y.data_ptr(), hT.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 _DTYPES[x.dtype], B, L, H, P, G, N, Q,
                 ctypes.cast(strides, ctypes.c_void_p), stream)
    _build.check(err, "ssd_scan")
    with _count_lock:
        launches += 1
        wgmma_launches += tc
    return y, hT


def bwd_tc(dtype, P: int, N: int) -> bool:
    """Whether the backward of inputs of ``dtype`` with head dim ``P`` and
    state size ``N`` runs on the tensor cores: bf16 where the chunk pass's
    tiles fit in a block's shared memory, P <= 64, or P <= 128 with N <=
    64."""
    return dtype == torch.bfloat16 and (
        P <= 64 or (P <= MAX_TC_HEAD and N <= 64))


def bwd_kernels(dtype, P: int, N: int) -> tuple:
    """The backward's kernels for inputs of ``dtype``, head dim ``P`` and
    state size ``N``, in launch order."""
    return BWD_TC_KERNELS if bwd_tc(dtype, P, N) else BWD_KERNELS


def bwd_scratch_floats(B, L, H, P, N, Q, tc: bool) -> int:
    """The float32 scratch of one backward call (``Args`` in the source):
    for both routes the chunk states and the reverse carries, and the
    per-head dB and dC terms; for the CUDA-core route (``tc`` False) also
    the inter pass's dx term and scalars."""
    nc = -(-L // Q)
    if tc:     # states, gstates; dBh, dCh; T_c, dA and dD partials
        return 2 * B * H * nc * P * N + 2 * B * L * H * N + 3 * B * H * nc
    return (2 * B * H * nc * P * N + 2 * B * H * nc
            + B * L * H * (P + 2 * N + 2) + 2 * B * nc * H)


def ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, D, dy, dhT=None, *,
                      chunk: int = 128):
    """Launch the backward kernels on the forward's inputs and the
    cotangents ``dy`` (x's shape and dtype) and ``dhT`` ((B, H, P, N)
    float32, or None for zero) on the route :func:`bwd_kernels` names:
    ``BWD_TC_KERNELS`` (tensor cores) for bf16 at P <= 64, or P <= 128
    with N <= 64, ``BWD_KERNELS`` (CUDA cores) otherwise. Returns ``(dx,
    ddt, dA, dBm, dCm, dD)`` in the inputs' dtypes: the gradient of
    :func:`~repro_torch.kernels.ssd_scan.ref.ssd_chunked_ref`'s ``(y,
    hT)`` with ``h0`` None, as
    :func:`~repro_torch.kernels.ssd_scan.ref.ssd_chunked_bwd_ref` computes
    it."""
    global bwd_wgmma_launches
    _build.refuse_grad("ssd_scan_bwd_cuda", _USE, x, dt, A, Bm, Cm, D, dy)
    B, L, H, P, G, N = _check("ssd_scan backward", x, dt, A, Bm, Cm, D)
    Q = _chunk_of("ssd_scan backward", chunk, L, N)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssd_scan backward: dy {dy.dtype} "
                         f"{tuple(dy.shape)} must match x {x.dtype} "
                         f"{tuple(x.shape)}")
    if dhT is not None and (dhT.shape != (B, H, P, N)
                            or dhT.dtype != torch.float32
                            or dhT.device != x.device):
        raise ValueError(f"ssd_scan backward: dhT must be float32 "
                         f"{(B, H, P, N)} on x's card, got {dhT.dtype} "
                         f"{tuple(dhT.shape)}")
    tc = bwd_tc(x.dtype, P, N)
    x, dt, A, Bm, Cm, D, dy = (t.contiguous()
                               for t in (x, dt, A, Bm, Cm, D, dy))
    dhT = None if dhT is None else dhT.contiguous()
    dx, ddt, dA = (torch.empty_like(t) for t in (x, dt, A))
    dBm, dCm, dD = (torch.empty_like(t) for t in (Bm, Cm, D))
    scratch = torch.empty(bwd_scratch_floats(B, L, H, P, N, Q, tc),
                          dtype=torch.float32, device=x.device)
    ptrs = (x, dt, A, Bm, Cm, D, dy, dhT, dx, ddt, dA, dBm, dCm, dD,
            scratch)
    ptrs = [None if t is None else t.data_ptr() for t in ptrs]
    fn = _bwd_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for name in bwd_kernels(x.dtype, P, N):
            err = fn(_BWD_PASS[name], *ptrs, _DTYPES[x.dtype], B, L, H, P, G,
                     N, Q, stream)
            _build.check(err, f"ssd_scan backward ({name})")
            with _count_lock:
                bwd_launches[name] += 1
    with _count_lock:
        bwd_wgmma_launches += tc
    return dx, ddt, dA, dBm, dCm, dD


class SsdScan(torch.autograd.Function):
    """The SSD scan on the card with a backward: the forward kernels, then
    the backward kernels on the saved inputs (the chunk states are
    recomputed there, not kept)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, chunk: int):
        y, hT = ssd_scan_cuda(x, dt, A, Bm, Cm, D, chunk=chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, A, Bm, Cm, D = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, D, dy, dhT,
                                  chunk=ctx.chunk)
        return (*grads, None)


def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk: int = 128):
    """The SSD chunked scan ``(y, hT)`` over chunks of ``min(chunk, L)``
    steps: the CUDA kernels for CUDA tensors (through :class:`SsdScan`
    when autograd records), the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm, D)):
        return SsdScan.apply(x, dt, A, Bm, Cm, D, chunk)
    return ssd_scan_cuda(x, dt, A, Bm, Cm, D, chunk=chunk)
