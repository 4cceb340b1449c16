"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel
``src/repro/kernels/ssd_scan/kernel.py:ssd_scan_pallas``. The kernel itself
is ``src/repro_torch/csrc/ssd_scan.cu`` (CUDA C++ for ``sm_90a``, built at
first use and loaded with ctypes); its header says what bounds it on the
card and how its design answers that.

The input dtype chooses the kernels, and this dispatch is stated here; it
is not a fallback, and nothing switches routes on an error. bf16 runs three
tensor-core (``wgmma``) kernels over the chunk-parallel form (chunk states,
the carry over chunks, the outputs) and needs P <= 128; float32 runs the
CUDA-core kernel (``wgmma`` takes no float32, and its TF32 mode would miss
the float32 checks at 1e-4). Every call adds one to ``launches``, whatever
the number of kernels it runs; a bf16 call also adds one to
``wgmma_launches``.

:func:`ssd_scan` is what the model calls (``models/mamba.py``, at the
reference's ``ssd_chunked_ref`` call site). A CUDA tensor launches the
kernels; a CPU tensor takes the plain version,
:func:`repro_torch.kernels.ssd_scan.ref.ssd_chunked_ref`. There is no
fallback from one to the other. The kernels have no backward and write their
outputs through ctypes, which autograd cannot see, so the raw wrapper
refuses to run while autograd records.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref

SOURCE = "ssd_scan.cu"
MAX_CHUNK = 128            # the kernel's QMAX
MAX_STATE = 128            # the kernel's NMAX
MAX_TC_HEAD = 128          # the tensor-core kernels' largest P
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel calls since the last reset (the wrapper adds one per call)
launches = 0
#: of those, the calls that ran the tensor-core (bf16) kernels
wgmma_launches = 0
_count_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load(SOURCE).repro_ssd_scan
    # x, dt, A, Bm, Cm, D, y, hT, scratch; dtype, B, L, H, P, G, N, Q;
    # strides; stream
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ssd_scan_cuda(x, dt, A, Bm, Cm, D, *, chunk: int = 128):
    """Launch the CUDA kernels: the tensor-core ones for bf16, the
    CUDA-core one for float32. Returns ``(y, hT)``: y (B, L, H, P) in x's
    dtype, hT (B, H, P, N) float32. x, Bm and Cm share one dtype (bfloat16
    or float32) and are read through their strides; dt, A and D are
    float32."""
    global launches, wgmma_launches
    _build.refuse_grad("ssd_scan_cuda", "the SSD scan has no backward "
                       "kernel yet (ROADMAP Queue 2 item 4): run it under "
                       "torch.no_grad()", x, dt, A, Bm, Cm, D)
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                    ("D", D)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"ssd_scan: {name} must be on x's card, got "
                             f"{t.device}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan: x, Bm, Cm have dtypes {x.dtype}, "
                         f"{Bm.dtype}, {Cm.dtype}; the kernel takes one of "
                         "bfloat16/float32 for all three")
    if any(t.dtype != torch.float32 for t in (dt, A, D)):
        raise ValueError("ssd_scan: dt, A and D must be float32")
    if (dt.shape != (B, L, H) or Bm.shape != (B, L, G, N)
            or Cm.shape != (B, L, G, N) or A.shape != (H,)
            or D.shape != (H,) or H % G):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}, A {tuple(A.shape)}, D "
                         f"{tuple(D.shape)}")
    Q = min(chunk, L)
    if not (1 <= Q <= MAX_CHUNK) or N > MAX_STATE:
        raise ValueError(f"ssd_scan: chunk {Q} / state size {N}; the kernel "
                         f"takes chunks of at most {MAX_CHUNK} steps and "
                         f"states of at most {MAX_STATE}")
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


def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk: int = 128):
    """The SSD chunked scan ``(y, hT)`` over chunks of ``min(chunk, L)``
    steps. CUDA tensors launch the kernels; CPU tensors take the plain
    version."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk)
    return ssd_scan_cuda(x, dt, A, Bm, Cm, D, chunk=chunk)
