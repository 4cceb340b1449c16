"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without an NVIDIA card; run them
there with ``pytest -m gpu tests/test_torch_gpu.py``. This file imports no
jax (the machine with the card has none): the plain versions, already held
against the JAX package on the CPU by ``test_torch_kernels.py``, are the
oracle.

Tolerances. float32 inputs: ``rtol=atol=2e-4`` (the kernels sum in another
order than PyTorch's matmuls). bfloat16 inputs: ``2e-2``, as
``tests/test_kernels.py``. The kernels keep every score in float32, while the
plain decode version (like the JAX reference) rounds the score einsum to
bfloat16 before the scale, and an output in bf16 may round either way. The
xent stats are float32 outputs of the same float32 arithmetic on the same
values, so they are held at ``2e-4`` for bf16 logits too, as is the SSD
scan's float32 state ``hT``. Gradients compare
the backward kernels with autograd through the plain versions.

bf16 attention runs on the tensor-core kernels, which round P (and in the
backward dS) to bf16 for their products; float32 attention runs on the
CUDA-core kernels. Each case asserts through the per-kernel counters which
of the two it reached. The bf16 backward cases are also held to the plain
version's autograd on float32 copies of the same inputs, as chip_smoke.py
holds the training shape; the backward also at MLA's head dims (v and dO
narrower than q and k: (192, 128) in bf16 and float32, the reduced
config's (96, 64) in float32), and a pair outside ``BWD_HEAD_DIMS`` raises
before any launch. The SSD scan likewise runs bf16 through its
tensor-core kernels (chunk states, carry, outputs) and float32 through its
CUDA-core kernel, and its bf16 cases are also held to the plain version on
float32 copies. The SSD scan's backward runs bf16 through its tensor-core
route (``BWD_TC_KERNELS``: state and chunk passes on wgmma, the carry, the
head-sum reduce) and float32 through its five CUDA-core kernels
(``BWD_KERNELS``); both are held to ``ssd_chunked_bwd_ref`` over the same
cases and mamba2's training layer, relative error in norm 1e-4 for float32
outputs and 1e-2 for bf16 ones, each call launching its route's kernels
once and none of the other's, a bf16 call bitwise repeatable, and
``SsdScan`` under autograd held to autograd through the plain version on
float32 copies. Flash decode combines its splits inside the kernel, in a
thread-block cluster, and its wrapper keeps no state between calls. On a
mesh, the xent kernels run on vocab shards at offsets 0 and V/2, and one
graph train step on two ranks of the card (a 60 s session timeout, which
its collectives share, so a deadlock fails instead of hanging) matches the
CPU's. Four ranks of the card whose rank 1 skips a rendezvous (or sits in
card work or in autograd past the timeout) all raise within it. Serving on
a mesh: decode on two sequence shards of one cache (k_offset 0 and L/2,
the second shard's rows wholly masked) combined across two ranks equals
the plain decode over the whole cache, and reduced qwen3 served on two
ranks of the card gives the same tokens on both backends as on the CPU.
Training on a mesh: the attention backward at a tp = 2 rank's heads, the
bf16 xent kernels on qwen3's vocab shard at V/2, and one
``make_train_step`` step of reduced qwen3 on two ranks of the card under a
60 s collective timeout (the deadlock's own test: a backward node waiting
at a rendezvous would stall the card's one autograd thread), float32
held to the CPU's mesh step at 1e-4 and bf16 at the bf16 tolerance.
The process runtime: reduced qwen3 (bf16) served with each stage in a
worker process of the card gives the threads session's tokens and kernel
launches (counted in the workers, summed in the driver), and a small graph
trained for three AdamW steps on worker processes is bitwise the threads
runtime.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ref import attention_dense_ref
from repro_torch.kernels.flash_decode import kernel as fd
from repro_torch.kernels.flash_decode.ref import combine_partials
from repro_torch.kernels.softmax_xent import kernel as xk
from repro_torch.kernels.softmax_xent.ref import (combine_stats,
                                                  local_stats_ref,
                                                  softmax_xent_ref)
from repro_torch.kernels.ssd_scan import kernel as ssd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref

pytestmark = pytest.mark.gpu

DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype: str):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device=device, dtype=DT[dtype])


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # B, Sq, Sk, H, KV, D, causal, window, q_offset, dtype
    (2, 50, 50, 4, 2, 64, True, 0, 0, "float32"),        # ragged tiles
    (1, 128, 128, 8, 2, 64, True, 0, 0, "bfloat16"),
    (1, 200, 200, 16, 8, 128, True, 0, 0, "bfloat16"),
    (2, 16, 64, 2, 1, 64, False, 0, 0, "float32"),       # cross attention
    (1, 17, 65, 2, 2, 128, True, 0, 48, "float32"),      # ragged + offset
    (1, 130, 130, 4, 4, 128, True, 33, 0, "float32"),    # sliding window
    (1, 8, 4, 2, 2, 64, True, 2, 4, "float32"),          # fully masked rows
    (1, 512, 512, 16, 8, 128, True, 0, 0, "bfloat16"),   # qwen3 prefill
    # bf16 twins of the float32 cases: the tensor-core kernel
    (2, 50, 50, 4, 2, 64, True, 0, 0, "bfloat16"),       # ragged tiles
    (2, 16, 64, 2, 1, 64, False, 0, 0, "bfloat16"),      # cross attention
    (1, 17, 65, 2, 2, 128, True, 0, 48, "bfloat16"),     # ragged + offset
    (1, 130, 130, 4, 4, 128, True, 33, 0, "bfloat16"),   # sliding window
    (1, 8, 4, 2, 2, 64, True, 2, 4, "bfloat16"),         # fully masked rows
    (1, 150, 150, 4, 2, 128, True, 0, 0, "bfloat16"),    # S not a tile multiple
    (1, 100, 230, 4, 2, 64, False, 0, 0, "bfloat16"),    # cross, ragged Sk
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, case):
    B, Sq, Sk, H, KV, D, causal, w, qoff, dt = case
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, Sq, H, D), dt, cuda)
    k = _randn(rng, (B, Sk, KV, D), dt, cuda)
    v = _randn(rng, (B, Sk, KV, D), dt, cuda)
    kw = dict(causal=causal, sliding_window=w, q_offset=qoff)
    before = fa.launches, fa.wgmma_launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    # bf16 reaches the tensor-core kernel, float32 the CUDA-core one
    assert (fa.launches, fa.wgmma_launches) == (
        before[0] + 1, before[1] + (dt == "bfloat16"))
    assert got.dtype == q.dtype and got.shape == (B, Sq, H, D)
    _close(got, fa.plain_flash_attention(q, k, v, **kw), dt)
    _close(got, attention_dense_ref(q, k, v, **kw), dt)


def test_flash_attention_refuses_other_head_dims(cuda):
    q = torch.zeros((1, 8, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)


MLA_FLASH_CASES = [
    # B, Sq, Sk, H, KV, D, Dv, causal, window, q_offset, dtype
    (1, 512, 512, 16, 16, 192, 128, True, 0, 0, "bfloat16"),  # deepseek prefill
    (1, 150, 150, 4, 4, 192, 128, True, 0, 0, "bfloat16"),    # ragged Sq
    (2, 77, 77, 4, 2, 192, 128, False, 0, 0, "bfloat16"),     # not causal
    (1, 33, 97, 4, 4, 192, 128, True, 0, 64, "bfloat16"),     # ragged + offset
    (1, 8, 4, 2, 2, 192, 128, True, 2, 4, "bfloat16"),        # fully masked rows
    (1, 150, 150, 4, 4, 192, 128, True, 0, 0, "float32"),
    (2, 77, 77, 4, 2, 192, 128, False, 0, 0, "float32"),
    (1, 8, 4, 2, 2, 192, 128, True, 2, 4, "float32"),
    (1, 100, 100, 4, 4, 96, 64, True, 0, 0, "float32"),       # reduced MLA
    (2, 45, 45, 4, 2, 96, 64, False, 0, 0, "float32"),
    (1, 33, 97, 4, 4, 96, 64, True, 0, 64, "float32"),
]


@pytest.mark.parametrize("case", MLA_FLASH_CASES)
def test_flash_attention_mla_head_dims_match_plain(cuda, case):
    """MLA's head dims, v narrower than q and k: (192, 128) in bf16 on the
    tensor cores and in float32, and the reduced config's (96, 64) in
    float32, causal and not, ragged, against the plain version."""
    B, Sq, Sk, H, KV, D, Dv, causal, w, qoff, dt = case
    rng = np.random.default_rng(1)
    q = _randn(rng, (B, Sq, H, D), dt, cuda)
    k = _randn(rng, (B, Sk, KV, D), dt, cuda)
    v = _randn(rng, (B, Sk, KV, Dv), dt, cuda)
    kw = dict(causal=causal, sliding_window=w, q_offset=qoff)
    before = fa.launches, fa.wgmma_launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fa.launches, fa.wgmma_launches) == (
        before[0] + 1, before[1] + (dt == "bfloat16"))
    assert got.dtype == q.dtype and got.shape == (B, Sq, H, Dv)
    _close(got, fa.plain_flash_attention(q, k, v, **kw), dt)
    _close(got, attention_dense_ref(q, k, v, **kw), dt)
    if dt == "bfloat16":       # and the float32 plain version of its inputs
        _close(got, fa.plain_flash_attention(q.float(), k.float(),
                                             v.float(), **kw), dt)


@pytest.mark.parametrize("pair", [(96, 64, "bfloat16"), (192, 192, "bfloat16"),
                                  (128, 64, "float32"), (192, 64, "float32")])
def test_flash_attention_refuses_unsupported_pairs(cuda, pair):
    """A pair the kernel does not take raises on the card, before any
    launch; nothing falls back to the plain version."""
    D, Dv, dt = pair
    q = torch.zeros((1, 8, 2, D), device=cuda, dtype=DT[dt])
    v = torch.zeros((1, 8, 2, Dv), device=cuda, dtype=DT[dt])
    before = fa.launches
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, v)
    assert fa.launches == before


MLA_BWD_CASES = [
    # B, S, H, KV, D, Dv, window, dtype
    (1, 512, 16, 16, 192, 128, 0, "bfloat16"),          # a deepseek layer's heads
    (1, 150, 4, 4, 192, 128, 0, "bfloat16"),            # ragged tiles
    (2, 77, 4, 2, 192, 128, 0, "bfloat16"),             # GQA, ragged
    (1, 200, 4, 4, 192, 128, 70, "bfloat16"),           # sliding window
    (1, 150, 4, 4, 192, 128, 0, "float32"),
    (2, 77, 4, 2, 192, 128, 33, "float32"),             # GQA + window
    (1, 100, 4, 4, 96, 64, 0, "float32"),               # reduced MLA
    (2, 45, 4, 2, 96, 64, 0, "float32"),
]


@pytest.mark.parametrize("case", MLA_BWD_CASES)
def test_flash_attention_backward_at_mla_head_dims_matches_plain(cuda, case):
    """The backward at MLA's head dims, v and dO narrower than q and k:
    (192, 128) in bf16 on the tensor cores and in float32, and the reduced
    config's (96, 64) in float32, against autograd through the plain
    version (bf16 also on float32 copies); dq, dk, dv take q's, k's and v's
    shapes."""
    B, S, H, KV, D, Dv, w, dt = case
    rng = np.random.default_rng(4)
    q = _randn(rng, (B, S, H, D), dt, cuda).requires_grad_(True)
    k = _randn(rng, (B, S, KV, D), dt, cuda).requires_grad_(True)
    v = _randn(rng, (B, S, KV, Dv), dt, cuda).requires_grad_(True)
    do = _randn(rng, (B, S, H, Dv), dt, cuda)
    counters = ("launches", "bwd_dq_launches", "bwd_dkdv_launches",
                "wgmma_launches", "bwd_dq_wgmma_launches",
                "bwd_dkdv_wgmma_launches")
    before = [getattr(fa, c) for c in counters]
    out = fa.flash_attention(q, k, v, causal=True, sliding_window=w)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    tc = int(dt == "bfloat16")
    assert [getattr(fa, c) - n for c, n in zip(counters, before)] == [
        1, 1, 1, tc, tc, tc]
    ref = fa.plain_flash_attention(q, k, v, causal=True, sliding_window=w)
    want = torch.autograd.grad(ref, (q, k, v), do)
    for g, wv, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert g.abs().max() > 0
        _close(g, wv, dt)
    if dt == "bfloat16":
        leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
        ref32 = fa.plain_flash_attention(*leaves, causal=True,
                                         sliding_window=w)
        for g, wv in zip(got, torch.autograd.grad(ref32, leaves, do.float())):
            _close(g, wv, dt)


@pytest.mark.parametrize("pair", [(96, 64, "bfloat16"), (192, 192, "bfloat16"),
                                  (128, 64, "float32")])
def test_flash_attention_backward_refuses_other_pairs(cuda, pair):
    """A pair outside ``BWD_HEAD_DIMS`` raises on the card under grad,
    before any launch; nothing falls back to the plain version."""
    D, Dv, dt = pair
    q = torch.zeros((1, 32, 2, D), device=cuda, dtype=DT[dt],
                    requires_grad=True)
    v = torch.zeros((1, 32, 2, Dv), device=cuda, dtype=DT[dt],
                    requires_grad=True)
    before = fa.launches
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, v)
    assert fa.launches == before


# ---------------------------------------------------------------------------
# flash decode
# ---------------------------------------------------------------------------

DECODE_CASES = [
    # B, H, KV, D, L, window, k_offset, dtype
    (2, 4, 2, 64, 64, 0, 0, "float32"),
    (1, 8, 8, 128, 100, 17, 0, "float32"),
    (3, 4, 1, 64, 96, 0, 0, "bfloat16"),
    (2, 16, 1, 128, 300, 0, 0, "float32"),               # group of 16
    (2, 4, 2, 64, 70, 0, 40, "float32"),                 # offset shard
    (4, 16, 8, 128, 569, 0, 0, "bfloat16"),              # qwen3 decode
    (2, 8, 4, 128, 200, 0, 0, "bfloat16"),               # L not a multiple of 64
    (2, 16, 8, 128, 300, 50, 0, "bfloat16"),             # sliding window
    (4, 16, 8, 128, 8192, 0, 0, "bfloat16"),             # long cache
    (1, 16, 8, 128, 8192, 0, 0, "bfloat16"),             # 8 groups, 16 splits
    (2, 8, 4, 128, 40, 0, 0, "bfloat16"),                # under one tile
    (2, 16, 8, 128, 8192, 0, 0, "float32"),              # float32, long cache
]


def _decode_case(case, device, seed=0):
    B, H, KV, D, L, w, koff, dt = case
    rng = np.random.default_rng(seed)
    q = _randn(rng, (B, H, D), dt, device)
    k = _randn(rng, (B, L, KV, D), dt, device)
    v = _randn(rng, (B, L, KV, D), dt, device)
    cur = rng.integers(koff + 1, koff + L, size=(B,))
    cur[-1] = koff + L - 1                               # a parked row
    cur = torch.as_tensor(cur, dtype=torch.int32, device=device)
    return q, k, v, cur, dict(k_offset=koff, sliding_window=w)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_kernel_matches_plain(cuda, case):
    q, k, v, cur, kw = _decode_case(case, cuda)
    before = fd.launches
    m, l, acc = fd.flash_decode(q, k, v, cur_pos=cur, **kw)
    torch.cuda.synchronize()
    assert fd.launches == before + 1
    pm, pl, pacc = fd.flash_decode_partial_ref(q, k, v, cur_pos=cur, **kw)
    dt = case[-1]
    _close(combine_partials(m[None], l[None], acc[None]),
           combine_partials(pm[None], pl[None], pacc[None]), dt)
    _close(m, pm, dt)


def test_flash_decode_fully_masked_rows_average_v(cuda):
    """A shard wholly after cur_pos: every key is masked with the finite
    sentinel, so the row averages v over the shard, as in the reference."""
    q, k, v, _, _ = _decode_case((2, 4, 2, 64, 80, 0, 0, "float32"), cuda)
    cur = torch.tensor([10, 30], dtype=torch.int32, device=cuda)
    m, l, acc = fd.flash_decode(q, k, v, cur_pos=cur, k_offset=100)
    got = combine_partials(m[None], l[None], acc[None])
    want = v.repeat_interleave(2, dim=2).mean(dim=1)
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_decode_on_two_shards_combined_across_ranks(cuda, dtype):
    """The mesh serve path's decode: one cache cut in two sequence shards,
    the kernel at k_offset 0 and L/2 on two virtual ranks of the card, and
    their partials combined across the ranks (pmax, then psums in rank
    order), against the plain decode over the whole cache. Three rows end
    in the first half, so the second shard's rows are wholly masked there
    and must weigh nothing."""
    from repro_torch.core.mesh import spmd
    from repro_torch.core.placement import Placement
    B, H, KV, D, L = 4, 16, 8, 128, 570
    half = L // 2
    rng = np.random.default_rng(5)
    q = _randn(rng, (B, H, D), dtype, cuda)
    k, v = (_randn(rng, (B, L, KV, D), dtype, cuda) for _ in "kv")
    cur = torch.tensor([0, 70, half - 1, L - 1], dtype=torch.int32,
                       device=cuda)
    shards = [tuple(t[:, r * half:(r + 1) * half].contiguous()
                    for t in (k, v)) for r in range(2)]
    mesh = Placement(("model",), (2,)).to_mesh(cuda, timeout=60.0)
    fd.reset_counts()
    outs = spmd(lambda r: combine_partials(*fd.flash_decode(
        q, *shards[r], cur_pos=cur, k_offset=r * half), axis_name="model"),
        mesh)([0, 1])
    torch.cuda.synchronize()
    assert fd.offset_launches == {0: 1, half: 1}
    assert torch.equal(outs[0], outs[1])
    pm, pl, pacc = fd.flash_decode_partial_ref(q, k, v, cur_pos=cur)
    _close(outs[0], combine_partials(pm[None], pl[None], pacc[None]), dtype)
    # the second shard alone: its masked rows hold the finite sentinel
    m, l, _ = fd.flash_decode(q, *shards[1], cur_pos=cur, k_offset=half)
    assert (m[:3] == -1e30).all() and (l[:3] == half).all()


def _decode_matches_plain(q, k, v, cur, dt, **kw):
    m, l, acc = fd.flash_decode(q, k, v, cur_pos=cur, **kw)
    pm, pl, pacc = fd.flash_decode_partial_ref(q, k, v, cur_pos=cur, **kw)
    _close(combine_partials(m[None], l[None], acc[None]),
           combine_partials(pm[None], pl[None], pacc[None]), dt)
    return m, l, acc


def test_flash_decode_rows_inside_one_split(cuda):
    """Every row's cur_pos in the same split: the splits before it are
    full, those after it empty, and the combine weighs the empty ones 0."""
    q, k, v, _, _ = _decode_case((4, 16, 8, 128, 569, 0, 0, "bfloat16"),
                                 cuda, seed=1)
    cur = torch.tensor([128, 150, 170, 191], dtype=torch.int32, device=cuda)
    _decode_matches_plain(q, k, v, cur, "bfloat16")


def test_flash_decode_back_to_back_mixed_shapes(cuda):
    """Calls in a row on the same shapes, then on fewer groups, then on the
    first shapes again, each give the plain version's result, and repeated
    calls give the same bits: nothing carries from one call to the next."""
    big = _decode_case((4, 16, 8, 128, 569, 0, 0, "bfloat16"), cuda, seed=2)
    small = _decode_case((2, 4, 2, 64, 100, 0, 0, "float32"), cuda, seed=3)
    before = fd.launches
    first = _decode_matches_plain(*big[:4], "bfloat16")
    again = _decode_matches_plain(*big[:4], "bfloat16")
    _decode_matches_plain(*small[:4], "float32")
    last = _decode_matches_plain(*big[:4], "bfloat16")
    torch.cuda.synchronize()
    assert fd.launches == before + 4
    for a, b, c in zip(first, again, last):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("case", [(4, 16, 8, 128, 8192, 0, 0, "bfloat16"),
                                  (2, 16, 8, 128, 300, 50, 0, "float32")])
def test_flash_decode_repeats_its_bits(cuda, case):
    """The split fold runs in a fixed order: ten calls, ten equal results."""
    q, k, v, cur, kw = _decode_case(case, cuda, seed=4)
    first = fd.flash_decode(q, k, v, cur_pos=cur, **kw)
    for _ in range(9):
        again = fd.flash_decode(q, k, v, cur_pos=cur, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_decode_two_streams_match_one_after_the_other(cuda):
    """Calls on two streams at once give the bits of the same calls run one
    after the other: the wrapper and the kernel share no state."""
    a = _decode_case((4, 16, 8, 128, 8192, 0, 0, "bfloat16"), cuda, seed=5)
    b = _decode_case((2, 16, 2, 64, 3000, 0, 0, "bfloat16"), cuda, seed=6)
    want = [fd.flash_decode(*c[:3], cur_pos=c[3]) for c in (a, b)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(8):
        for i, (st, c) in enumerate(zip(streams, (a, b))):
            with torch.cuda.stream(st):
                got[i].append(fd.flash_decode(*c[:3], cur_pos=c[3]))
    torch.cuda.synchronize()
    for outs, ref in zip(got, want):
        for out in outs:
            assert all(torch.equal(x, y) for x, y in zip(out, ref))


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8, 16])
def test_flash_decode_every_cluster_size(cuda, splits):
    """The kernel at each cluster size the plan may pick, and at sizes it
    does not, against the plain version (rows shorter than the splits
    included)."""
    q, k, v, _, _ = _decode_case((3, 16, 8, 128, 700, 0, 0, "bfloat16"),
                                 cuda, seed=7)
    cur = torch.tensor([5, 400, 699], dtype=torch.int32, device=cuda)
    m, l, acc = fd.flash_decode_cuda_partials(q, k, v, cur, splits=splits)
    pm, pl, pacc = fd.flash_decode_partial_ref(q, k, v, cur_pos=cur)
    _close(combine_partials(m[None], l[None], acc[None]),
           combine_partials(pm[None], pl[None], pacc[None]), "bfloat16")


def test_paged_gather_then_decode_matches_plain(cuda):
    """Paged serving on the card: the gather of a slot group's pages (and
    the scatter of its decode writes) equals the same index program on the
    CPU bit for bit, and the kernel on the gathered window matches the
    plain version on it, at the qwen3 paged decode shape (4 slots, 576
    positions in 36 pages of 16, one slot parked)."""
    from repro_torch.serve.paged_cache import (PagedCacheSpec,
                                               _build_paged_ops)
    B, H, KV, D, L, pl = 4, 16, 8, 128, 576, 16
    spec = PagedCacheSpec(page_len=pl, num_pages=144, max_requests=8,
                          pages_per_req=L // pl)
    rng = np.random.default_rng(4)
    slabs_cpu = [{key: _randn(rng, (spec.num_pages * pl + 2, KV, D),
                              "bfloat16", "cpu") for key in ("k", "v")}]
    for t in slabs_cpu[0].values():
        t[-2:] = 0                                   # the sentinel rows
    rows = rng.permutation(spec.num_pages)[:B * spec.pages_per_req]
    rows = rows.reshape(B, -1).astype(np.int32)
    rows[0, 30:] = -1                                # unmapped tail
    rows[3] = -1                                     # a parked slot
    sids = np.array([0, 5, 2, -1], np.int32)
    cur = np.array([300, 575 - 16, 17, L - 1], np.int32)
    windows = {}
    for dev in ("cpu", cuda):
        ops = _build_paged_ops(spec, B, L, dev)
        slabs = [{k: t.to(dev) for k, t in slabs_cpu[0].items()}]
        win = ops["gather"](slabs, torch.as_tensor(rows, device=dev),
                            torch.as_tensor(sids, device=dev))
        windows[str(torch.device(dev).type)] = (ops, slabs, win)
    _, _, wc = windows["cpu"]
    ops, slabs, wg = windows["cuda"]
    for key in ("k", "v"):
        assert torch.equal(wg[0][key].cpu(), wc[0][key])
    assert not wg[0]["k"][3].any() and not wg[0]["k"][0, 30 * pl:].any()
    q = _randn(rng, (B, H, D), "bfloat16", cuda)
    pos = torch.as_tensor(cur, device=cuda)
    before = fd.launches
    _decode_matches_plain(q, wg[0]["k"], wg[0]["v"], pos, "bfloat16")
    assert fd.launches == before + 1
    # the decode's writes go back to their pages, the parked one drops
    wg[0]["k"][torch.arange(B), pos.long()] = 1.0
    ops["scatter_decode"](slabs, torch.as_tensor(rows, device=cuda),
                          torch.as_tensor(sids, device=cuda), pos, wg)
    flat = slabs[0]["k"]
    for b in range(3):
        p = int(rows[b, cur[b] // pl]) * pl + int(cur[b]) % pl
        assert (flat[p] == 1.0).all()
    assert not flat[-2].any()


def test_flash_decode_refuses_k_positions(cuda):
    q, k, v, cur, _ = _decode_case((1, 4, 2, 64, 16, 0, 0, "float32"), cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fd.flash_decode(q, k, v, cur_pos=cur,
                        k_positions=torch.zeros((1, 16), dtype=torch.int32,
                                                device=cuda))


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------

BWD_CASES = [
    # B, S, H, KV, D, window, dtype
    (2, 50, 4, 2, 64, 0, "float32"),                     # ragged tiles
    (1, 130, 4, 4, 128, 33, "float32"),                  # sliding window
    (1, 256, 4, 1, 128, 0, "float32"),                   # group of 4
    (1, 128, 8, 2, 64, 0, "bfloat16"),
    (1, 200, 16, 8, 128, 70, "bfloat16"),                # window, bf16
    (1, 512, 16, 8, 128, 0, "bfloat16"),                 # qwen3 layer
    (2, 50, 4, 2, 64, 0, "bfloat16"),                    # ragged, G 2, D 64
    (1, 130, 4, 4, 128, 33, "bfloat16"),                 # G 1, window
    (1, 256, 4, 1, 128, 0, "bfloat16"),                  # G 4, D 128
    (1, 200, 8, 2, 64, 0, "bfloat16"),                   # G 4, D 64, ragged
    (2, 1024, 8, 4, 128, 0, "bfloat16"),                 # a tp = 2 rank's heads
]


def _grad_case(case, device, seed=3):
    B, S, H, KV, D, w, dt = case
    rng = np.random.default_rng(seed)
    q = _randn(rng, (B, S, H, D), dt, device).requires_grad_(True)
    k = _randn(rng, (B, S, KV, D), dt, device).requires_grad_(True)
    v = _randn(rng, (B, S, KV, D), dt, device).requires_grad_(True)
    do = _randn(rng, (B, S, H, D), dt, device)
    return q, k, v, do, w


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_attention_backward_matches_plain_autograd(cuda, case):
    q, k, v, do, w = _grad_case(case, cuda)
    counters = ("launches", "bwd_dq_launches", "bwd_dkdv_launches",
                "wgmma_launches", "bwd_dq_wgmma_launches",
                "bwd_dkdv_wgmma_launches")
    before = [getattr(fa, c) for c in counters]
    out = fa.flash_attention(q, k, v, causal=True, sliding_window=w)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    tc = int(case[-1] == "bfloat16")     # the tensor-core kernels
    assert [getattr(fa, c) - n for c, n in zip(counters, before)] == [
        1, 1, 1, tc, tc, tc]
    ref = fa.plain_flash_attention(q, k, v, causal=True, sliding_window=w)
    want = torch.autograd.grad(ref, (q, k, v), do)
    dt = case[-1]
    _close(out, ref, dt)
    for g, wv in zip(got, want):
        assert g.dtype == wv.dtype and g.shape == wv.shape
        assert g.abs().max() > 0
        _close(g, wv, dt)
    if dt == "bfloat16":
        leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
        ref32 = fa.plain_flash_attention(*leaves, causal=True,
                                         sliding_window=w)
        want32 = torch.autograd.grad(ref32, leaves, do.float())
        for g, wv in zip(got, want32):
            _close(g, wv, dt)


CROSS_BWD_CASES = [
    # B, Sq, Sk, H, KV, D, dtype: non-causal (Sq == Sk) and cross (Sq != Sk)
    (2, 1500, 1500, 16, 16, 64, "bfloat16"),   # whisper's encoder layer
    (2, 448, 1500, 16, 16, 64, "bfloat16"),    # its decoder's cross layer
    (2, 1500, 1500, 16, 16, 64, "float32"),
    (2, 448, 1500, 16, 16, 64, "float32"),
    (2, 37, 100, 4, 2, 64, "float32"),         # ragged, G 2
    (1, 100, 37, 8, 2, 128, "bfloat16"),       # Sq > Sk, G 4, D 128
    (2, 50, 50, 4, 2, 64, "bfloat16"),         # ragged encoder, G 2
]


@pytest.mark.parametrize("case", CROSS_BWD_CASES)
def test_flash_attention_backward_non_causal_and_cross(cuda, case):
    """The backward of non-causal self-attention and of cross-attention
    (whisper's encoder and decoder shapes, ragged tails) against autograd
    through the plain version: the tensor-core kernels for bf16 (also held
    on float32 copies), the CUDA-core ones for float32."""
    B, Sq, Sk, H, KV, D, dt = case
    rng = np.random.default_rng(11)
    q = _randn(rng, (B, Sq, H, D), dt, cuda).requires_grad_(True)
    k = _randn(rng, (B, Sk, KV, D), dt, cuda).requires_grad_(True)
    v = _randn(rng, (B, Sk, KV, D), dt, cuda).requires_grad_(True)
    do = _randn(rng, (B, Sq, H, D), dt, cuda)
    counters = ("launches", "bwd_dq_launches", "bwd_dkdv_launches",
                "wgmma_launches", "bwd_dq_wgmma_launches",
                "bwd_dkdv_wgmma_launches")
    before = [getattr(fa, c) for c in counters]
    out = fa.flash_attention(q, k, v, causal=False)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    tc = int(dt == "bfloat16")
    assert [getattr(fa, c) - n for c, n in zip(counters, before)] == [
        1, 1, 1, tc, tc, tc]
    ref = fa.plain_flash_attention(q, k, v, causal=False)
    want = torch.autograd.grad(ref, (q, k, v), do)
    _close(out, ref, dt)
    for g, wv in zip(got, want):
        assert g.shape == wv.shape and g.abs().max() > 0
        _close(g, wv, dt)
    if dt == "bfloat16":
        leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
        ref32 = fa.plain_flash_attention(*leaves, causal=False)
        for g, wv in zip(got, torch.autograd.grad(ref32, leaves, do.float())):
            _close(g, wv, dt)


@pytest.mark.parametrize("kw", [dict(causal=False, sliding_window=8),
                                dict(q_offset=8),
                                dict(sk=48, causal=False, q_offset=8)])
def test_flash_attention_backward_scope_raises(cuda, kw):
    """q_offset, and a sliding window without causal masking, have no CUDA
    backward: asking for one raises before any launch."""
    kw = dict(kw)
    sk = kw.pop("sk", 32)
    q = torch.zeros((1, 32, 2, 64), device=cuda, requires_grad=True)
    k = torch.zeros((1, sk, 2, 64), device=cuda, requires_grad=True)
    before = fa.launches
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fa.flash_attention(q, k, k, **kw)
    assert fa.launches == before


# ---------------------------------------------------------------------------
# sharded-vocab xent
# ---------------------------------------------------------------------------

XENT_CASES = [
    # N, Vl, vocab_offset, dtype
    (64, 1000, 0, "float32"),
    (100, 700, 2100, "float32"),                         # unaligned rows
    (7, 130, 130, "float32"),
    (256, 2048, 4096, "bfloat16"),
    (16, 151936, 0, "bfloat16"),                         # qwen3 vocab
    (64, 75968, 75968, "bfloat16"),                      # its shard at V/2
    (512, 151936, 0, "bfloat16"),                # a bf16 graph microbatch
]


@pytest.mark.parametrize("case", XENT_CASES)
def test_xent_kernels_match_plain(cuda, case):
    N, Vl, off, dt = case
    rng = np.random.default_rng(4)
    logits = (_randn(rng, (N, Vl), dt, cuda) * 3).requires_grad_(True)
    labels = torch.as_tensor(rng.integers(0, 3 * Vl, size=(N,)),
                             dtype=torch.int32, device=cuda)
    labels[0] = off                                      # a hit at column 0
    ds = _randn(rng, (N,), "float32", cuda)
    dz = _randn(rng, (N,), "float32", cuda)
    f0, b0 = xk.launches, xk.bwd_launches
    got = xk.xent_local_stats(logits, labels, off)
    (g,) = torch.autograd.grad(got[1:], logits, (ds, dz))
    torch.cuda.synchronize()
    assert (xk.launches, xk.bwd_launches) == (f0 + 1, b0 + 1)
    assert not got[0].requires_grad
    want = local_stats_ref(logits, labels, off)
    (wg,) = torch.autograd.grad(want[1:], logits, (ds, dz))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    assert g.dtype == logits.dtype
    _close(g, wg, dt)


@pytest.mark.parametrize("shard", [0, 1], ids=["offset0", "offset_half"])
def test_xent_kernels_on_vocab_shards(cuda, shard):
    """The xent kernels on one of two vocab shards (offset 0 and V/2),
    forward and backward against their plain versions, the launch counted
    at its offset; with the other shard's plain stats they combine to the
    unsplit loss."""
    N, V = 256, 8192
    Vl = V // 2
    rng = np.random.default_rng(5)
    full = _randn(rng, (N, V), "float32", cuda) * 3
    labels = torch.as_tensor(rng.integers(0, V, N), dtype=torch.int32,
                             device=cuda)
    ds = _randn(rng, (N,), "float32", cuda)
    dz = _randn(rng, (N,), "float32", cuda)
    off = shard * Vl
    logits = full[:, off:off + Vl].contiguous().requires_grad_(True)
    xk.reset_counts()
    got = xk.xent_local_stats(logits, labels, off)
    (g,) = torch.autograd.grad(got[1:], logits, (ds, dz))
    torch.cuda.synchronize()
    assert xk.offset_launches == xk.bwd_offset_launches == {off: 1}
    want = local_stats_ref(logits, labels, off)
    (wg,) = torch.autograd.grad(want[1:], logits, (ds, dz))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    _close(g, wg, "float32")
    other = 1 - shard
    rest = local_stats_ref(full[:, other * Vl:(other + 1) * Vl], labels,
                           other * Vl)
    pair = [got, rest] if shard == 0 else [rest, got]
    loss = combine_stats(*(torch.stack([p[i].detach() for p in pair])
                           for i in range(3)))
    torch.testing.assert_close(loss, softmax_xent_ref(full, labels),
                               rtol=1e-5, atol=1e-5)


def test_graph_train_step_on_two_ranks_of_the_card(cuda):
    """One AdamW step of a graph with a vocab-split embedding and
    softmax_xent on two ranks of the card (stage actors, mesh collectives):
    each rank's xent kernels launch at its offset, and loss and gradients
    match the same step on the CPU. The session's 60 s timeout governs its
    actors and its mesh's collectives, so a deadlock fails the test
    instead of hanging it."""
    from repro_torch import api
    from repro_torch.core.graph import LogicalGraph
    from repro_torch.core.lowering import OptimizerSpec
    from repro_torch.core.placement import Placement
    N, V, D = 64, 1024, 32
    g = LogicalGraph(Placement(("model",), (2,)))
    ids = g.input("ids", (N,), dtype="int32", sbp="B")
    labels = g.input("labels", (N,), dtype="int32", sbp="B")
    h = g.embedding(g.input("E", (V, D), sbp="S(0)"), ids, name="emb")
    h = g.unary(g.matmul(h, g.input("w", (D, D)), name="mm"), "gelu",
                name="act")
    g.softmax_xent(g.matmul(h, g.input("W_out", (D, V), sbp="S(1)"),
                            name="head"), labels, name="loss")
    rng = np.random.default_rng(6)
    params = {t.name: (rng.normal(size=t.shape) * 0.3).astype(np.float32)
              for t in g.inputs if t.dtype == "float32"}
    data = {n: rng.integers(0, V, N).astype(np.int32)
            for n in ("ids", "labels")}
    res = {}
    for d in ("cpu", "cuda"):
        xk.reset_counts()
        sess = api.compile(g, mode="train", params=params, stages=2,
                           num_microbatches=2, timeout=60.0, device=d,
                           optimizer=OptimizerSpec.adamw(lr=1e-2))
        res[d] = sess.step(**data)
        sess.close()
    torch.cuda.synchronize()
    assert xk.offset_launches == xk.bwd_offset_launches == {0: 2, V // 2: 2}
    torch.testing.assert_close(res["cuda"].loss.cpu(), res["cpu"].loss,
                               rtol=1e-5, atol=1e-5)
    for n in params:
        torch.testing.assert_close(res["cuda"].grads[n].cpu(),
                                   res["cpu"].grads[n], rtol=1e-4, atol=1e-5)


class _SlowBackward(torch.autograd.Function):
    """Doubles its input; its backward holds the card's autograd worker for
    ``seconds`` before it returns."""

    seconds = 0.0

    @staticmethod
    def forward(ctx, v):
        return v * 2

    @staticmethod
    def backward(ctx, g):
        time.sleep(_SlowBackward.seconds)
        return g * 2


@pytest.mark.parametrize("fault", ["returns", "late", "other_collective",
                                   "busy_on_the_card", "inside_autograd"])
def test_a_skipped_collective_raises_on_every_rank_of_the_card(cuda, fault):
    """Four ranks on the card meet at a psum of card tensors; rank 1 skips
    it (returns, comes late, calls another collective, keeps the card busy
    past the timeout, or sits inside ``torch.autograd.grad``). Every rank
    raises a CollectiveError within the timeout and nothing hangs."""
    from repro_torch.core import mesh as M
    from repro_torch.core.mesh import CollectiveError, spmd
    from repro_torch.core.placement import Placement
    timeout = 0.5
    _SlowBackward.seconds = 3 * timeout
    mesh = Placement(("d",), (4,)).to_mesh(cuda, timeout=timeout)
    big = torch.randn((2048, 2048), device=cuda)

    def body(x):
        if M.current_rank() == 1:
            if fault == "returns":
                return x
            if fault == "late":
                time.sleep(3 * timeout)
            if fault == "other_collective":
                return M.all_gather(x, "d")
            if fault == "busy_on_the_card":
                t = time.perf_counter()
                while time.perf_counter() - t < 3 * timeout:
                    torch.cuda.synchronize(big.device)
                    big.copy_(big @ big / 2048)
                torch.cuda.synchronize(big.device)
            if fault == "inside_autograd":
                v = x.clone().requires_grad_(True)
                (x,) = torch.autograd.grad(_SlowBackward.apply(v).sum(), v)
        return M.psum(x, "d")

    t0 = time.perf_counter()
    with pytest.raises(CollectiveError) as err:
        spmd(body, mesh)([torch.ones(2, device=cuda) for _ in range(4)])
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    ranks = set(err.value.rank_errors)
    assert all(isinstance(e, CollectiveError)
               for e in err.value.rank_errors.values())
    if fault == "returns":
        assert ranks == {0, 2, 3}           # rank 1 returned without it
        assert elapsed < timeout
    else:
        assert ranks == {0, 1, 2, 3}
        assert elapsed < 3 * timeout + 2.0
    if fault in ("late", "busy_on_the_card", "inside_autograd"):
        assert f"timed out after {timeout:g} s" in str(err.value)


def test_raw_wrappers_refuse_under_grad(cuda):
    q, k, v, do, _ = _grad_case((1, 64, 2, 2, 64, 0, "float32"), cuda)
    logits = torch.zeros((4, 64), device=cuda, requires_grad=True)
    labels = torch.zeros((4,), dtype=torch.int32, device=cuda)
    stat = torch.zeros((4,), device=cuda)
    cur = torch.zeros((1,), dtype=torch.int32, device=cuda)
    for call in (lambda: fa.flash_attention_cuda(q, k, v),
                 lambda: fa.flash_attention_bwd_cuda(
                     q, k, v, torch.zeros((1, 2, 64), device=cuda), do),
                 lambda: fd.flash_decode_cuda_partials(q[:, 0], k, v, cur),
                 lambda: xk.xent_local_stats_cuda(logits, labels, 0),
                 lambda: xk.xent_local_stats_bwd_cuda(logits, labels, 0,
                                                      stat, stat, stat)):
        with pytest.raises(RuntimeError, match="cut the autograd graph"):
            call()


def test_model_grads_on_card_match_plain_path(cuda):
    """Reduced qwen3 (float32): the training loss's gradients through the
    kernels on the card against the same weights on the CPU's plain path.
    The attention weights get a gradient only through the attention
    backward kernel."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.common import MeshPlan
    from repro_torch.models.model_zoo import build_model, loss_fn
    cfg = get_config("qwen3-1.7b").reduced()
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 65)).astype(np.int32)}
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, MeshPlan(), seed=0, device="cpu").to(dev)
        for p in model.parameters():
            p.requires_grad_(True)
        loss, _ = loss_fn(model, batch)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[str(dev)] = loss.item(), dict(zip(names, grads))
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(lc - lg) <= 1e-4 * abs(lc)
    for name, g in gc.items():
        if name.split(".")[-1] in ("wq", "wk", "wv", "q_norm", "k_norm"):
            assert gg[name].abs().max() > 0, name
        torch.testing.assert_close(gg[name].cpu(), g, rtol=2e-3, atol=2e-5,
                                   msg=name)


# ---------------------------------------------------------------------------
# SSD chunked scan
# ---------------------------------------------------------------------------

SSD_CASES = [
    # B, L, H, P, N, G, chunk, dtype
    (2, 67, 4, 8, 16, 1, 16, "float32"),
    (1, 128, 2, 16, 8, 2, 32, "float32"),
    (1, 64, 4, 32, 16, 1, 128, "float32"),               # chunk > L
    (2, 96, 4, 16, 16, 1, 32, "bfloat16"),
    (2, 77, 4, 8, 16, 1, 16, "float32"),                 # ragged tail chunk
    (1, 77, 32, 64, 128, 1, 128, "bfloat16"),            # one chunk of 77
    (1, 300, 8, 40, 64, 4, 128, "bfloat16"),             # P not a multiple of 16
    (1, 512, 32, 64, 128, 1, 128, "bfloat16"),           # mamba2 prefill
    (1, 256, 4, 64, 128, 2, 128, "bfloat16"),            # 2 chunks, G 2
    (2, 600, 4, 64, 128, 1, 128, "bfloat16"),            # 5 chunks, ragged
    (1, 160, 4, 128, 64, 1, 32, "bfloat16"),             # 5 chunks, P 128
    (1, 100, 4, 21, 36, 2, 128, "bfloat16"),             # one chunk, odd P, N
]


def _ssd_case(case, device, seed=0):
    B, L, H, P, N, G, Q, dt = case
    rng = np.random.default_rng(seed)
    x = _randn(rng, (B, L, H, P), dt, device)
    dtv = torch.as_tensor(rng.uniform(0.01, 0.2, size=(B, L, H)),
                          dtype=torch.float32, device=device)
    A = torch.as_tensor(-rng.uniform(0.5, 2, size=(H,)), dtype=torch.float32,
                        device=device)
    # B and C as the model passes them: views into one (B, L, 2GN) tensor
    bc = _randn(rng, (B, L, 2 * G * N), dt, device)
    Bm = bc[..., :G * N].reshape(B, L, G, N)
    Cm = bc[..., G * N:].reshape(B, L, G, N)
    D = _randn(rng, (H,), "float32", device)
    return (x, dtv, A, Bm, Cm, D), Q


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_kernel_matches_plain(cuda, case):
    args, Q = _ssd_case(case, cuda)
    dt = case[-1]
    before = ssd.launches, ssd.wgmma_launches
    y, hT = ssd.ssd_scan(*args, chunk=Q)
    torch.cuda.synchronize()
    # bf16 reaches the tensor-core kernels, float32 the CUDA-core one
    assert (ssd.launches, ssd.wgmma_launches) == (
        before[0] + 1, before[1] + (dt == "bfloat16"))
    assert y.dtype == args[0].dtype and y.shape == args[0].shape
    assert hT.dtype == torch.float32
    yr, hr = ssd_chunked_ref(*args, chunk=Q)
    _close(y, yr, dt)
    torch.testing.assert_close(hT, hr, rtol=2e-4, atol=2e-4)
    # on float32 copies of the same inputs, and with B and C contiguous
    f32 = [t.float().contiguous() for t in args]
    before = ssd.wgmma_launches
    y32, h32 = ssd.ssd_scan(*f32, chunk=Q)
    yr32, hr32 = ssd_chunked_ref(*f32, chunk=Q)
    assert ssd.wgmma_launches == before
    _close(y32, yr32, "float32")
    torch.testing.assert_close(h32, hr32, rtol=2e-4, atol=2e-4)
    if dt == "bfloat16":      # the bf16 kernels against float32 copies
        _close(y, yr32, dt)
        torch.testing.assert_close(hT, hr32, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("offset", [0, 1])
def test_ssd_scan_reads_strided_views_as_copies(cuda, offset):
    """B and C as the model's views, and x as a view into a wider tensor:
    at offset 0 its rows stay 16-byte aligned (the kernels' 16-byte loads),
    at offset 1 they do not (element loads). Both read what a contiguous
    copy gives."""
    args, Q = _ssd_case((1, 200, 4, 32, 32, 2, 64, "bfloat16"), cuda, seed=1)
    x = args[0]
    wide = torch.zeros(x.shape[:-1] + (x.shape[-1] + 8,), dtype=x.dtype,
                       device=cuda)
    wide[..., offset:offset + x.shape[-1]] = x
    args = (wide[..., offset:offset + x.shape[-1]],) + args[1:]
    y, hT = ssd.ssd_scan(*args, chunk=Q)
    yc, hc = ssd.ssd_scan(*[t.contiguous() for t in args], chunk=Q)
    assert torch.equal(y, yc) and torch.equal(hT, hc)


def test_ssd_raw_wrapper_refuses_under_grad(cuda):
    args, Q = _ssd_case(SSD_CASES[0], cuda, seed=2)
    args[0].requires_grad_(True)
    before = ssd.launches
    with pytest.raises(RuntimeError, match="cut the autograd graph"):
        ssd.ssd_scan_cuda(*args, chunk=Q)
    assert ssd.launches == before


# the backward: the cases above, the mamba2 training layer's shape, and
# bf16 past the tensor-core tiles (P 128, N 128: the CUDA-core route)
SSD_BWD_CASES = SSD_CASES + [
    (2, 2048, 32, 64, 128, 1, 128, "bfloat16"),          # mamba2 training
    (1, 300, 4, 64, 128, 1, 128, "float32"),             # 3 chunks, ragged
    (1, 300, 4, 128, 128, 1, 128, "bfloat16"),           # P 128, N 128
]


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def _bwd_route_counted(before, dtype, P, N):
    """The backward launches since ``before`` (``(bwd_launches,
    bwd_wgmma_launches)``) are one of each kernel of the route of
    ``dtype``, ``P`` and ``N`` and none of the other's."""
    route = ssd.bwd_kernels(dtype, P, N)
    assert {k: n - before[0][k] for k, n in ssd.bwd_launches.items()} \
        == {k: int(k in route) for k in ssd.bwd_launches}
    assert ssd.bwd_wgmma_launches - before[1] == ssd.bwd_tc(dtype, P, N)


@pytest.mark.parametrize("with_dhT", [True, False], ids=["dhT", "no_dhT"])
@pytest.mark.parametrize("case", SSD_BWD_CASES)
def test_ssd_scan_backward_kernels_match_plain(cuda, case, with_dhT):
    """The backward kernels against ``ssd_chunked_bwd_ref`` on the same
    inputs (the plain version upcasts bf16 to float32, so this is also the
    comparison on float32 copies). Relative error in norm: 1e-4 for the
    float32 outputs (dt, A, D always; every output of a float32 case: the
    same float32 arithmetic summed in another order), 1e-2 for bf16 ones
    (one bf16 rounding of each element, 2^-9, on top). Every kernel of the
    route of the dtype and shape launches once, and none of the other
    route's."""
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd_ref
    args, Q = _ssd_case(case, cuda, seed=3)
    B, L, H, P, N = case[:5]
    rng = np.random.default_rng(4)
    dy = _randn(rng, (B, L, H, P), case[-1], cuda)
    dhT = (_randn(rng, (B, H, P, N), "float32", cuda) if with_dhT
           else None)
    before = dict(ssd.bwd_launches), ssd.bwd_wgmma_launches
    got = ssd.ssd_scan_bwd_cuda(*args, dy, dhT, chunk=Q)
    torch.cuda.synchronize()
    _bwd_route_counted(before, args[0].dtype, P, N)
    want = ssd_chunked_bwd_ref(*args, dy, dhT, chunk=Q)
    for name, g, w, a in zip(("x", "dt", "A", "Bm", "Cm", "D"), got, want,
                             args):
        assert g.dtype == a.dtype and g.shape == a.shape, name
        assert torch.isfinite(g).all(), name
        limit = 1e-2 if g.dtype == torch.bfloat16 else 1e-4
        err = _rel(g, w)
        assert err <= limit, f"d{name}: {err:.3e} relative (limit {limit})"


@pytest.mark.parametrize("case", [SSD_CASES[0], SSD_CASES[3], SSD_CASES[8],
                                  SSD_BWD_CASES[-1]])
def test_ssd_scan_function_under_autograd_matches_plain(cuda, case):
    """``ssd_scan`` with inputs that require grad goes through ``SsdScan``
    (the forward kernels, then the backward kernels); its gradients of
    ``(y, hT)`` against autograd through the plain version on float32
    copies of the same inputs. A bf16 case's y is bf16, so the cotangent
    reaching the kernels is ``dy`` rounded to bf16: ``dy`` is made
    bf16-exact, so both arms get the same cotangent. A bf16 gradient is
    held at 1e-2 relative (one bf16 rounding of each element), a float32
    one at 1e-4 (float32 sums in another order)."""
    args, Q = _ssd_case(case, cuda, seed=5)
    B, L, H, P, N = case[:5]
    rng = np.random.default_rng(6)
    dy = _randn(rng, (B, L, H, P), "float32", cuda).bfloat16().float()
    dhT = _randn(rng, (B, H, P, N), "float32", cuda)

    def grads(fn, ins):
        ins = [t.detach().clone().requires_grad_(True) for t in ins]
        y, hT = fn(*ins, chunk=Q)
        loss = (y.float() * dy).sum() + (hT * dhT).sum()
        return torch.autograd.grad(loss, ins)
    before = ssd.launches, dict(ssd.bwd_launches), ssd.bwd_wgmma_launches
    got = grads(ssd.ssd_scan, args)
    torch.cuda.synchronize()
    assert ssd.launches == before[0] + 1
    _bwd_route_counted(before[1:], args[0].dtype, P, N)
    want = grads(ssd_chunked_ref, [t.float() for t in args])
    for name, g, w, a in zip(("x", "dt", "A", "Bm", "Cm", "D"), got, want,
                             args):
        assert g.dtype == a.dtype, name
        limit = 1e-2 if g.dtype == torch.bfloat16 else 1e-4
        err = _rel(g, w)
        assert err <= limit, f"d{name}: {err:.3e} relative (limit {limit})"


# the bf16 cases on the tensor-core route
SSD_BWD_BF16 = [c for c in SSD_BWD_CASES
                if ssd.bwd_tc(getattr(torch, c[-1]), c[3], c[4])]


@pytest.mark.parametrize("case", [SSD_BWD_BF16[0], SSD_BWD_BF16[-1]])
def test_ssd_scan_backward_bf16_is_bitwise_repeatable(cuda, case):
    """Two bf16 backward calls on the same inputs give the same bits: the
    tensor-core route sums dB and dC over the heads (and dA, dD over the
    chunks) in a fixed order, with no atomics."""
    args, Q = _ssd_case(case, cuda, seed=8)
    dy = _randn(np.random.default_rng(9), args[0].shape, "bfloat16", cuda)
    first = ssd.ssd_scan_bwd_cuda(*args, dy, chunk=Q)
    second = ssd.ssd_scan_bwd_cuda(*args, dy, chunk=Q)
    torch.cuda.synchronize()
    for name, a, b in zip(("x", "dt", "A", "Bm", "Cm", "D"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case", SSD_BWD_BF16)
def test_ssd_scan_backward_bf16_never_launches_cuda_core_kernels(cuda,
                                                                  case):
    """A bf16 backward call runs the tensor-core route alone: its state and
    chunk kernels once each, and none of the CUDA-core state, inter or
    intra kernels."""
    args, Q = _ssd_case(case, cuda, seed=10)
    dy = torch.ones_like(args[0])
    before = dict(ssd.bwd_launches)
    ssd.ssd_scan_bwd_cuda(*args, dy, chunk=Q)
    torch.cuda.synchronize()
    for k in ("ssd_bwd_state_kernel", "ssd_bwd_inter_kernel",
              "ssd_bwd_intra_kernel"):
        assert ssd.bwd_launches[k] == before[k], k
    for k in ("ssd_bwd_tc_state_kernel", "ssd_bwd_tc_chunk_kernel"):
        assert ssd.bwd_launches[k] == before[k] + 1, k


def test_ssd_backward_bf16_past_its_tiles_runs_cuda_core_kernels(cuda):
    """The tensor-core route takes P <= 64, or P <= 128 with N <= 64; past
    that, by the wrapper's stated dispatch (not on an error), a bf16 call
    runs the five CUDA-core kernels once each and no tensor-core kernel."""
    args, Q = _ssd_case((1, 128, 2, 128, 128, 1, 128, "bfloat16"), cuda,
                        seed=11)
    before = dict(ssd.bwd_launches), ssd.bwd_wgmma_launches
    ssd.ssd_scan_bwd_cuda(*args, torch.ones_like(args[0]), chunk=Q)
    torch.cuda.synchronize()
    assert ssd.bwd_kernels(torch.bfloat16, 128, 128) == ssd.BWD_KERNELS
    _bwd_route_counted(before, torch.bfloat16, 128, 128)


def test_ssd_backward_wrapper_refuses_under_grad(cuda):
    args, Q = _ssd_case(SSD_CASES[0], cuda, seed=7)
    dy = torch.ones_like(args[0])
    args[1].requires_grad_(True)
    before = dict(ssd.bwd_launches)
    with pytest.raises(RuntimeError, match="cut the autograd graph"):
        ssd.ssd_scan_bwd_cuda(*args, dy, chunk=Q)
    assert ssd.bwd_launches == before


def test_reduced_mamba2_prefill_on_card_matches_cpu(cuda):
    """Reduced mamba2 (float32): prefill logits and SSM caches through the
    kernel on the card against the same weights on the CPU's plain path,
    then two decode steps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.lowering import lower_serve_stages
    from repro_torch.models.common import MeshPlan
    from repro_torch.models.model_zoo import build_model
    cfg = get_config("mamba2-370m").reduced()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (37, 100)]
    # the same seeded weights on each device (the init runs on the CPU)
    progs = {d: lower_serve_stages(
        cfg, build_model(cfg, MeshPlan(), seed=0, device="cpu").to(d),
        num_stages=2, cache_len=128, max_prompt_len=100, group_size=2)
        for d in ("cpu", "cuda")}
    tol = dict(rtol=1e-3, atol=1e-3)
    before = ssd.launches
    with torch.inference_mode():
        caches = {d: [s.init_caches(2) for s in p.stages]
                  for d, p in progs.items()}
        out = {}
        for slot, pr in enumerate(prompts):
            for d, p in progs.items():
                x = torch.as_tensor(pr[None], device=d)
                for s, st in enumerate(p.stages):
                    x, sc = st.prefill(st.params, x, pr.size - 1)
                    st.write_slot(caches[d][s], sc, slot)
                out[d] = x
            torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], **tol)
        for gc, cc in zip(caches["cuda"], caches["cpu"]):
            for a, b in zip(gc, cc):
                for key in a:
                    torch.testing.assert_close(a[key].cpu(), b[key], **tol)
        tok = [5, 7]
        for _ in range(2):
            for d, p in progs.items():
                x = torch.tensor(tok, dtype=torch.int32, device=d)
                pos = torch.tensor([37, 100], dtype=torch.int32, device=d)
                for s, st in enumerate(p.stages):
                    x, _ = st.decode(st.params, caches[d][s], x, pos)
                out[d] = x
            torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], **tol)
    assert ssd.launches == before + len(prompts) * cfg.num_layers


def test_reduced_qwen3_served_on_two_ranks_of_the_card(cuda):
    """Reduced qwen3 (float32) served on a (1, 2) mesh of two ranks of the
    card: actors ≡ monolithic tokens, equal to the same mesh on the CPU,
    each rank launching one attention forward a layer a prefill and one
    decode a layer a decode item, at its shard's k_offset."""
    from repro_torch import api
    from repro_torch.configs.registry import get_config
    from repro_torch.core.placement import Placement
    from repro_torch.models.common import MeshPlan
    from repro_torch.models.model_zoo import build_model
    cfg = get_config("qwen3-1.7b").reduced()
    plan = MeshPlan(("data", "model"), (1, 2))
    state = build_model(cfg, plan, seed=0, device="cpu").state_dict()
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32), g)
            for n, g in ((8, 3), (5, 6), (7, 2), (3, 5), (6, 4))]
    geo = dict(num_groups=2, group_size=2, max_prompt_len=8,
               max_new_tokens=6, cache_len=24, timeout=60.0)
    out = {}
    for d in ("cpu", "cuda"):
        for backend in ("actors", "monolithic"):
            mesh = Placement(("data", "model"), (1, 2)).to_mesh(
                d, timeout=60.0)
            kw = dict(stages=2) if backend == "actors" else {}
            fd.reset_counts()
            fa.launches = 0
            with api.compile(cfg, mode="serve", backend=backend,
                             params=state, mesh=mesh, **kw, **geo) as sess:
                out[(d, backend)] = sess.generate(reqs)
                st = sess.last_stats
            torch.cuda.synchronize()
            if d == "cuda":
                L = cfg.num_layers
                assert fa.launches == 2 * L * st["prefill_items"]
                assert fd.offset_launches == {
                    0: L * st["decode_items"], 12: L * st["decode_items"]}
    want = out[("cpu", "monolithic")]
    for key, got in out.items():
        assert all(np.array_equal(a, b) for a, b in zip(got, want)), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mesh_train_step_on_two_ranks_of_the_card(cuda, dtype):
    """One ``make_train_step`` step of reduced qwen3 on a (1, 2) mesh of
    two ranks of the card, its collectives under a 60 s timeout: the
    assembled gradients, loss and grad_norm against the same step on the
    CPU; each rank's attention launches (forward and remat recompute, dq,
    dk/dv a layer) on the kernels of its dtype, and its xent kernels at
    its vocab shard's offset."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.common import MeshPlan
    from repro_torch.train.steps import make_train_step
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(), dtype=dtype)
    batch = {"tokens": SyntheticLM(cfg.vocab_size, 2, 64, seed=9)(0)}
    plan = MeshPlan(("data", "model"), (1, 2))
    init, res = None, {}
    for d in ("cpu", "cuda"):
        ts = make_train_step(cfg, plan, zero=False, device=d)
        ts.mesh.timeout = 60.0
        params = ts.init_params(0)
        if init is None:
            init = {n: t.clone() for n, t in params.state_dict().items()}
        params.load_state_dict(init)
        opt = ts.init_opt(params)
        _, grads = ts.grad_fn(params, batch)
        fa.launches = fa.bwd_dq_launches = fa.bwd_dkdv_launches = 0
        fa.wgmma_launches = fa.bwd_dq_wgmma_launches = 0
        fa.bwd_dkdv_wgmma_launches = 0
        xk.reset_counts()
        t0 = time.perf_counter()
        params, opt, m = ts.step_fn(params, opt, batch)
        torch.cuda.synchronize()
        res[d] = (m, grads, time.perf_counter() - t0)
    assert res["cuda"][2] < ts.mesh.timeout
    L, tc = cfg.num_layers, int(dtype == "bfloat16")
    assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkdv_launches) == (
        4 * L, 2 * L, 2 * L)
    assert (fa.wgmma_launches, fa.bwd_dq_wgmma_launches,
            fa.bwd_dkdv_wgmma_launches) == (4 * L * tc, 2 * L * tc,
                                            2 * L * tc)
    Vl = cfg.padded_vocab() // 2
    assert xk.offset_launches == xk.bwd_offset_launches == {0: 1, Vl: 1}
    tol = _tol(dtype) if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-4)
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(res["cuda"][0][k].cpu(), res["cpu"][0][k],
                                   **tol)
    for n, w in res["cpu"][1].items():
        torch.testing.assert_close(res["cuda"][1][n].cpu(), w,
                                   **(tol if tc else dict(rtol=1e-4,
                                                          atol=1e-5)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_train_step_on_two_ranks_of_the_card(cuda, dtype):
    """One ``make_train_step(zero=True)`` step of reduced qwen3 on a (2, 1)
    mesh of two ranks of the card -- each rank's master rows cast,
    all-gathered and their gradients reduce-scattered on the tape, its
    collectives under a 60 s timeout -- against the same step on the CPU's
    plain path: loss and grad_norm within 1e-4 relative (float32; the
    bf16 compute at the kernels' bf16 tolerance). Each rank's attention launches on the kernels of its dtype,
    its xent kernels once each way at offset 0."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.common import MeshPlan
    from repro_torch.train.steps import make_train_step
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(), dtype=dtype)
    batch = {"tokens": SyntheticLM(cfg.vocab_size, 2, 64, seed=9)(0)}
    plan = MeshPlan(("data", "model"), (2, 1))
    plain = make_train_step(cfg, plan, zero=False, device="cpu")
    params = plain.init_params(0)
    init = {n: t.clone() for n, t in params.state_dict().items()}
    _, _, want = plain.step_fn(params, plain.init_opt(params), batch)
    ts = make_train_step(cfg, plan, zero=True, device=cuda)
    ts.mesh.timeout = 60.0
    zp = ts.shard_params_fn(init)
    opt = ts.init_opt(zp)
    fa.launches = fa.bwd_dq_launches = fa.bwd_dkdv_launches = 0
    fa.wgmma_launches = fa.bwd_dq_wgmma_launches = 0
    fa.bwd_dkdv_wgmma_launches = 0
    xk.reset_counts()
    ts.mesh.stats.reset()
    t0 = time.perf_counter()
    zp, opt, got = ts.step_fn(zp, opt, batch)
    torch.cuda.synchronize()
    assert time.perf_counter() - t0 < ts.mesh.timeout
    L, tc = cfg.num_layers, int(dtype == "bfloat16")
    assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkdv_launches) == (
        4 * L, 2 * L, 2 * L)
    assert (fa.wgmma_launches, fa.bwd_dq_wgmma_launches,
            fa.bwd_dkdv_wgmma_launches) == (4 * L * tc, 2 * L * tc,
                                            2 * L * tc)
    assert xk.offset_launches == xk.bwd_offset_launches == {0: 2}
    n = len(zp.shapes)
    assert ts.mesh.stats.calls["all_gather"] == n
    assert ts.mesh.stats.calls["psum_scatter"] == n
    tol = _tol(dtype) if tc else dict(rtol=1e-4, atol=0.0)
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(got[k].cpu(), want[k], **tol)


# ---------------------------------------------------------------------------
# the process runtime on the card
# ---------------------------------------------------------------------------

def test_reduced_qwen3_served_on_worker_processes_of_the_card(cuda):
    """Reduced qwen3 (bf16) served with each stage in a worker process of
    its own on the card: the tokens of the threads session, the kernel
    launches (counted in the workers, summed in the driver) equal the
    threads session's, and each worker runs in a process of its own on
    the card."""
    import dataclasses
    import os

    from repro_torch import api
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="bfloat16")
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32), g)
            for n, g in ((8, 3), (5, 6), (7, 2), (3, 5), (6, 4))]
    geo = dict(num_groups=2, group_size=2, max_prompt_len=8,
               max_new_tokens=6, cache_len=24, seed=0, timeout=120.0)
    out, counts = {}, {}
    for runtime in ("threads", "processes"):
        with api.compile(cfg, mode="serve", stages=2, runtime=runtime,
                         **geo) as sess:
            fd.reset_counts()
            fa.launches = fa.wgmma_launches = 0
            out[runtime] = sess.generate(reqs)
            counts[runtime] = (fa.launches, fa.wgmma_launches, fd.launches)
            st = sess.last_stats
            if runtime == "processes":
                workers = sess.executor.runtime.workers
                assert len({w["pid"] for w in workers.values()}) == 3
                assert os.getpid() not in {w["pid"] for w in
                                           workers.values()}
                assert all(w["device"].startswith("cuda")
                           for w in workers.values())
    L = cfg.num_layers
    assert counts["processes"] == counts["threads"] == (
        L * st["prefill_items"], L * st["prefill_items"],
        L * st["decode_items"])
    assert all(np.array_equal(a, b)
               for a, b in zip(out["threads"], out["processes"]))


def test_graph_train_on_worker_processes_of_the_card_is_bitwise(cuda):
    """Three AdamW steps of a small graph with softmax_xent, one worker
    process per stage on the card, bitwise the threads runtime (loss,
    params, moments); the xent kernels launched in the last stage's worker
    are counted in the driver."""
    from repro_torch import api
    from repro_torch.core.graph import LogicalGraph
    from repro_torch.core.lowering import OptimizerSpec
    from repro_torch.core.placement import Placement
    N, V, D = 64, 512, 32
    rng = np.random.default_rng(7)

    def graph():
        g = LogicalGraph(Placement(("d",), (1,)))
        ids = g.input("ids", (N,), dtype="int32")
        labels = g.input("labels", (N,), dtype="int32")
        h = g.embedding(g.input("E", (V, D)), ids, name="emb")
        h = g.unary(g.matmul(h, g.input("w", (D, D)), name="mm"), "gelu",
                    name="act")
        g.softmax_xent(g.matmul(h, g.input("W_out", (D, V)), name="head"),
                       labels, name="loss")
        return g

    params = {t.name: (rng.normal(size=t.shape) * 0.3).astype(np.float32)
              for t in graph().inputs if t.dtype == "float32"}
    data = {n: rng.integers(0, V, N).astype(np.int32)
            for n in ("ids", "labels")}
    res = {}
    for runtime in ("threads", "processes"):
        xk.reset_counts()
        with api.compile(graph(), mode="train", params=params, stages=2,
                         num_microbatches=2, runtime=runtime, timeout=120.0,
                         optimizer=OptimizerSpec.adamw(lr=1e-2,
                                                       grad_clip=1.0)
                         ) as sess:
            losses = [sess.step(**data).loss.cpu() for _ in range(3)]
            res[runtime] = (losses, {n: v.cpu() for n, v in
                                     sess.params.items()},
                            sess.opt_state, (xk.launches, xk.bwd_launches))
    (lt, pt, ot, ct), (lp, pp, op, cp) = res["threads"], res["processes"]
    assert ct == cp == (3 * 2, 3 * 2)
    assert all(torch.equal(a, b) for a, b in zip(lt, lp))
    for n in params:
        assert torch.equal(pt[n], pp[n]), n
        assert torch.equal(ot.mu[n].cpu(), op.mu[n].cpu()), n
        assert torch.equal(ot.nu[n].cpu(), op.nu[n].cpu()), n
