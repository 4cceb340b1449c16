"""Split-KV flash decode: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_decode/kernel.py:flash_decode_pallas`` and its
wrapper's split combine. The kernel itself is
``src/repro_torch/csrc/flash_decode.cu`` (CUDA C++ for ``sm_90a``, built at
first use and loaded with ctypes); its header says what bounds it on the
card (bytes: every unmasked K and V row read once) and how its design
answers that.

:func:`flash_decode` is what the model calls. A CUDA tensor launches the
kernel: one thread-block cluster per (batch row, kv head) group, whose
:func:`split_plan` blocks each take an even part of the row's unmasked key
range (:func:`split_bounds` is that cut in plain Python), stream their K/V
tiles through shared memory, push their partials into each other's shared
memory and fold them in split order (:func:`combine_splits`; the whole
algorithm in plain PyTorch is :func:`split_partials_ref` folded by it).
One launch, one output allocation, no PyTorch op on the card between it
and the returned tensors, and nothing kept between calls. A CPU tensor
takes the plain version,
:func:`repro_torch.kernels.flash_decode.ref.flash_decode_partial_ref` —
the function the JAX model calls at ``models/attention.py:268-272``.
There is no fallback from one to the other. The kernel's outputs are
written through ctypes, which autograd cannot see, so the raw wrapper
refuses to run while autograd records.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode.ref import (NEG_INF,
                                                  flash_decode_partial_ref)

SOURCE = "flash_decode.cu"
HEAD_DIMS = (64, 128)
MAX_GROUP = 16             # q heads per kv head the kernel holds
MAX_SPLITS = 16            # the largest thread-block cluster Hopper launches
MIN_SPLIT_KEYS = 32        # a cache shorter than NS * 32 gets fewer splits
H100_SMS = 132
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (the wrapper adds one per launch)
launches = 0
#: launches by ``k_offset`` since the last reset: {offset: count} (a rank's
#: cache shard on a mesh carries its shard's offset)
offset_launches: Dict[int, int] = {}
#: launches by cache length since the last reset: {L: count} (whisper's
#: cross-attention decodes over its 1,500-position encoder cache)
length_launches: Dict[int, int] = {}
_count_lock = threading.Lock()


def reset_counts() -> None:
    """Zero every launch counter of this module."""
    global launches
    with _count_lock:
        launches = 0
        offset_launches.clear()
        length_launches.clear()


def split_plan(B: int, KV: int, L: int, sms: int = H100_SMS) -> int:
    """NS, the splits (blocks of one cluster) per (batch row, kv head)
    group: the largest power of two, at most :data:`MAX_SPLITS`, with
    ``B * KV * NS`` blocks no more than ``sms`` -- one block an SM, which
    leaves every cluster resident at once (two blocks fit an SM, but
    clusters pack into a GPC's SMs with gaps: at 8 splits only 30 clusters
    fit the H100, fewer than qwen3's 32 groups) -- halved while the cache
    holds fewer than :data:`MIN_SPLIT_KEYS` keys a split."""
    ns = 1
    while ns < MAX_SPLITS and B * KV * ns * 2 <= sms:
        ns *= 2
    while ns > 1 and ns * MIN_SPLIT_KEYS > L:
        ns //= 2
    return ns


def split_bounds(cur_pos, L: int, ns: int, *, k_offset: int = 0,
                 sliding_window: int = 0) -> List[Tuple[bool, List[int]]]:
    """Each row's cut, as the kernel makes it: ``(masked, starts)`` with
    split ``s`` over local keys ``[starts[s], starts[s + 1])``, the row's
    unmasked range ``[lo, hi]`` cut into ``ns`` even parts. A row with no
    unmasked key (``masked``) cuts the whole cache, every key at the
    finite sentinel."""
    rows = []
    for cur in (int(c) for c in cur_pos):
        lo = max(0, cur - sliding_window + 1 - k_offset) \
            if sliding_window > 0 else 0
        hi = min(L - 1, cur - k_offset)
        masked = lo > hi
        if masked:
            lo, hi = 0, L - 1
        n = hi - lo + 1
        rows.append((masked, [lo + n * s // ns for s in range(ns + 1)]))
    return rows


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SM count, the split plan's one input from the card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def resident_clusters(dtype: torch.dtype, D: int, splits: int,
                      device) -> int:
    """How many clusters of ``splits`` blocks of the kernel (``dtype``,
    head dim ``D``) the card holds at once, from the CUDA occupancy API:
    the evidence behind :func:`split_plan`'s one block an SM."""
    fn = _build.load(SOURCE).repro_flash_decode_max_clusters
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    n = fn(_DTYPES[dtype], D, splits, torch.device(device).index or 0)
    if n < 0:
        raise RuntimeError(f"flash_decode: CUDA error {-n} in the occupancy "
                           "query")
    return n


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load(SOURCE).repro_flash_decode
    # q, k, v, cur_pos, out; dtype, B, L, H, KV, D, splits, k_offset,
    # window; sm_scale; device; stream
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_decode_cuda_partials(q, k, v, cur_pos, *, k_offset: int = 0,
                               sliding_window: int = 0,
                               sm_scale: Optional[float] = None,
                               splits: Optional[int] = None):
    """Launch the CUDA kernel; returns this cache's float32 partials
    m, l (B, H) and acc (B, H, D), its splits combined on the card.
    ``splits`` overrides :func:`split_plan`'s NS (1 to 16)."""
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
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("flash_decode: q, k and v must start at 16-byte "
                         "aligned addresses (the kernel copies 16 bytes "
                         "at a time)")
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
    if splits is None:
        splits = split_plan(B, KV, L, sm_count(dev))
    elif not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"flash_decode: splits {splits}, the kernel takes "
                         f"1 to {MAX_SPLITS}")
    bh = B * H
    out = torch.empty(bh * (D + 2), dtype=torch.float32, device=dev)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), cur_pos.data_ptr(),
                out.data_ptr(), _DTYPES[q.dtype], B, L, H, KV, D,
                splits, int(k_offset),
                int(sliding_window), float(sm_scale), dev.index,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_decode")
    with _count_lock:
        launches += 1
        offset_launches[int(k_offset)] = offset_launches.get(
            int(k_offset), 0) + 1
        length_launches[L] = length_launches.get(L, 0) + 1
    return (out.as_strided((B, H), (H, 1), 0),
            out.as_strided((B, H), (H, 1), bh),
            out.as_strided((B, H, D), (H * D, D, 1), 2 * bh))


def combine_splits(m, l, acc):
    """The kernel's split combine, in plain PyTorch: partials stacked on
    dim 1 (splits) folded in split order, as the blocks of each cluster
    fold them -- the second-level P(max)/P(sum) reduction of the Pallas
    wrapper (``flash_decode/kernel.py:106-111``)."""
    m_g = m.amax(dim=1)
    l_g = torch.zeros_like(l[:, 0])
    acc_g = torch.zeros_like(acc[:, 0])
    for s in range(m.shape[1]):
        w = torch.exp(m[:, s] - m_g)
        l_g = l_g + l[:, s] * w
        acc_g = acc_g + acc[:, s] * w[..., None]
    return m_g, l_g, acc_g


def split_partials_ref(q, k, v, cur_pos, ns: int, *, k_offset: int = 0,
                       sliding_window: int = 0,
                       sm_scale: Optional[float] = None):
    """The kernel's splits in plain PyTorch: each row's range cut as
    :func:`split_bounds` cuts it and one :func:`flash_decode_partial_ref`
    partial per split (an empty split leaves ``(-1e30, 0, 0)``, as the
    kernel's does), stacked on dim 1: m, l (B, ns, H), acc (B, ns, H, D).
    :func:`combine_splits` of them is the kernel's whole algorithm."""
    B, H, D = q.shape
    m = torch.full((B, ns, H), NEG_INF, dtype=torch.float32)
    l = torch.zeros((B, ns, H), dtype=torch.float32)
    acc = torch.zeros((B, ns, H, D), dtype=torch.float32)
    bounds = split_bounds(cur_pos, k.shape[1], ns, k_offset=k_offset,
                          sliding_window=sliding_window)
    for b, (_, starts) in enumerate(bounds):
        for s in range(ns):
            a, e = starts[s], starts[s + 1]
            if a < e:
                pm, pl, pa = flash_decode_partial_ref(
                    q[b:b + 1], k[b:b + 1, a:e], v[b:b + 1, a:e],
                    k_offset=k_offset + a, cur_pos=cur_pos[b:b + 1],
                    sliding_window=sliding_window, sm_scale=sm_scale)
                m[b, s], l[b, s], acc[b, s] = pm[0], pl[0], pa[0]
    return m, l, acc


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
