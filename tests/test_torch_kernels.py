"""The port's plain kernel versions against the JAX package's kernels.

Inputs come from a numpy seed and go through both packages. The JAX Pallas
kernels run with ``interpret=True`` on the CPU, as ``test_kernels.py`` runs
them. Tolerances: float32 ``rtol=2e-4, atol=2e-5`` (summation order differs
between XLA and PyTorch); bfloat16 ``2e-2`` (one bf16 rounding of scores or
outputs may land on the other side), as in ``test_kernels.py``.

Gradients: the plain versions' autograd against ``jax.vjp`` of the JAX
refs, float32, within 1e-5 -- the CUDA backward kernels are held against
the same plain autograd on the card.

The CUDA kernels themselves run only on the card (``test_torch_gpu.py``);
here the wrappers must take the plain path for CPU tensors, never launch,
refuse a non-CPU tensor they cannot launch on, and refuse (raw wrappers)
to run while autograd records.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_dense_ref as jax_dense, flash_attention_ref as jax_flash_ref,
    flash_attention_triangular as jax_triangular)
from repro.kernels.flash_decode.kernel import flash_decode_pallas  # noqa: E402
from repro.kernels.flash_decode.ref import (  # noqa: E402
    decode_attention_ref as jax_decode_ref,
    flash_decode_partial_ref as jax_decode_partial)
from repro.kernels.softmax_xent.kernel import xent_local_stats_pallas  # noqa: E402
from repro.kernels.softmax_xent.ref import (  # noqa: E402
    local_stats_ref as jax_local_stats, softmax_xent_ref as jax_xent_ref)
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_dense_ref, flash_attention_ref, flash_attention_triangular)
from repro_torch.kernels.flash_decode import kernel as fd_kernel  # noqa: E402
from repro_torch.kernels.flash_decode.ref import (  # noqa: E402
    combine_partials, decode_attention_ref, flash_decode_partial_ref)
from repro_torch.kernels.softmax_xent import kernel as xent_kernel  # noqa: E402
from repro_torch.kernels.softmax_xent.ref import (  # noqa: E402
    combine_stats, local_stats_ref, softmax_xent_ref)

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype: str):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-5)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, JNP[dtype])
    return j, torch.from_numpy(np.array(j, np.float32)).to(TORCH[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # B, Sq, Sk, H, KV, D, Dv, causal, window, dtype
    (2, 50, 50, 4, 2, 16, 16, True, 0, "float32"),
    (1, 33, 33, 4, 4, 32, 16, True, 7, "float32"),      # MLA-ish Dv != D
    (2, 16, 64, 2, 1, 16, 16, False, 0, "float32"),     # cross attention
    (1, 128, 128, 8, 2, 64, 64, True, 0, "bfloat16"),
    (1, 17, 65, 2, 2, 8, 8, True, 0, "float32"),        # ragged + offset
]


def _flash_inputs(case, seed=0):
    B, Sq, Sk, H, KV, D, Dv, causal, w, dt = case
    rng = np.random.default_rng(seed)
    q = _pair(rng.normal(size=(B, Sq, H, D)), dt)
    k = _pair(rng.normal(size=(B, Sk, KV, D)), dt)
    v = _pair(rng.normal(size=(B, Sk, KV, Dv)), dt)
    qoff = Sk - Sq if causal else 0
    return q, k, v, dict(causal=causal, sliding_window=w, q_offset=qoff)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_plain_flash_matches_pallas_kernel(case):
    (qj, qt), (kj, kt), (vj, vt), kw = _flash_inputs(case)
    want = flash_attention_pallas(qj, kj, vj, block_q=16, block_k=16,
                                  interpret=True, **kw)
    got = flash_attention_ref(qt, kt, vt, block_q=16, block_k=16, **kw)
    assert got.dtype == qt.dtype
    assert_allclose(_np(got), _np(want), **_tol(case[-1]))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_plain_dense_matches_jax_dense(case):
    (qj, qt), (kj, kt), (vj, vt), kw = _flash_inputs(case, seed=1)
    want = jax_dense(qj, kj, vj, **kw)
    got = attention_dense_ref(qt, kt, vt, **kw)
    assert_allclose(_np(got), _np(want), **_tol(case[-1]))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_wrapper_takes_plain_path_on_cpu(case):
    """The model-facing wrapper on CPU tensors: the plain version (the JAX
    model's own ref dispatch), and no kernel launch."""
    (qj, qt), (kj, kt), (vj, vt), kw = _flash_inputs(case, seed=2)
    before = fa_kernel.launches
    got = fa_kernel.flash_attention(qt, kt, vt, **kw)
    assert fa_kernel.launches == before == 0
    want = jax_dense(qj, kj, vj, **kw)
    assert_allclose(_np(got), _np(want), **_tol(case[-1]))


@pytest.mark.parametrize("S,window,block", [
    (50, 0, 16), (64, 0, 16), (70, 9, 16), (33, 0, 512)])
def test_triangular_matches_rectangular_and_jax(S, window, block):
    rng = np.random.default_rng(3)
    q = _pair(rng.normal(size=(2, S, 4, 16)), "float32")
    k = _pair(rng.normal(size=(2, S, 2, 16)), "float32")
    v = _pair(rng.normal(size=(2, S, 2, 16)), "float32")
    tri = flash_attention_triangular(q[1], k[1], v[1], sliding_window=window,
                                     block_q=block, block_k=block)
    rect = flash_attention_ref(q[1], k[1], v[1], causal=True,
                               sliding_window=window, block_q=block,
                               block_k=block)
    assert_allclose(_np(tri), _np(rect), rtol=1e-6, atol=1e-6)
    want = jax_triangular(q[0], k[0], v[0], sliding_window=window,
                          block_q=block, block_k=block)
    assert_allclose(_np(tri), _np(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("blocks", [(16, 16), (32, 16), (16, 64)])
def test_flash_ref_block_invariance(blocks):
    """The plain flash ref is block-size invariant, as the JAX one is."""
    bq, bk = blocks
    rng = np.random.default_rng(4)
    q = _pair(rng.normal(size=(2, 40, 4, 16)), "float32")
    k = _pair(rng.normal(size=(2, 40, 2, 16)), "float32")
    v = _pair(rng.normal(size=(2, 40, 2, 16)), "float32")
    got = flash_attention_ref(q[1], k[1], v[1], causal=True, block_q=bq,
                              block_k=bk)
    want = jax_flash_ref(q[0], k[0], v[0], causal=True, block_q=bq,
                         block_k=bk)
    assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-5)
    assert_allclose(_np(got), _np(attention_dense_ref(q[1], k[1], v[1])),
                    rtol=2e-4, atol=2e-5)


def test_fully_masked_rows_average_v():
    """The finite sentinel: a row whose keys are all masked averages v in
    both packages (here: a window that excludes every key of late rows)."""
    rng = np.random.default_rng(5)
    q = _pair(rng.normal(size=(1, 8, 2, 8)), "float32")
    k = _pair(rng.normal(size=(1, 4, 2, 8)), "float32")
    v = _pair(rng.normal(size=(1, 4, 2, 8)), "float32")
    kw = dict(causal=True, sliding_window=2, q_offset=4)
    got = attention_dense_ref(q[1], k[1], v[1], **kw)
    want = jax_dense(q[0], k[0], v[0], **kw)
    assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-5)
    assert_allclose(_np(got)[0, -1], _np(v[1]).mean(axis=1)[0], rtol=1e-5,
                    atol=1e-6)


GRAD_CASES = [
    # B, S, H, KV, D, window
    (2, 40, 4, 2, 16, 0),                 # GQA, ragged blocks
    (1, 70, 4, 1, 16, 9),                 # GQA + sliding window
    (1, 33, 2, 2, 8, 0),
]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_plain_attention_grads_match_jax_vjp(case):
    """dq, dk, dv of the plain causal path (what the CPU model trains
    through) against ``jax.vjp`` of ``flash_attention_triangular``."""
    B, S, H, KV, D, w = case
    rng = np.random.default_rng(9)
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) for shape in (
        (B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))
    _, vjp = jax.vjp(jax.jit(lambda a, b, c: jax_triangular(
        a, b, c, sliding_window=w)), q, k, v)
    want = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = fa_kernel.flash_attention(qt, kt, vt, causal=True, sliding_window=w)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    for name, g, wv in zip("qkv", got, want):
        assert_allclose(_np(g), _np(wv), rtol=1e-5, atol=1e-5,
                        err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# the tensor-core kernels' rounding, emulated
# ---------------------------------------------------------------------------
# The bf16 attention kernels on the card (csrc/flash_attention.cu,
# flash_attention_bwd.cu) feed the tensor cores bf16 operands where the
# float32 plain version keeps float32: P in the forward's P V; in the
# backward dS in dQ = dS K (one bf16 rounding), and P in dV = P^T dO and dS
# in dK = dS^T Q as bf16 hi + lo pairs (x = hi + lo to 2^-17). Everything
# else is float32, as on the card (a product of two bf16 values is exact in
# float32). This emulation runs the kernels' tiles (64 q rows, 64 keys) and
# their online softmax on the CPU and holds the result to the float32 plain
# version within the limits chip_smoke.py holds the kernels to at the
# training shape (ATOL, RTOL below), so the rounding is checked here
# before any card runs. The card's kernels themselves are held to the same
# limits in chip_smoke.py and tests/test_torch_gpu.py.

TC_ATOL, TC_RTOL = 5e-3, 1e-2       # chip_smoke.py's ATOL, RTOL
TC_TILE = 64
TC_CASES = [
    # B, S, H, KV, D, window: qwen3-like heads at small S, then a window,
    # then D = 64 with a ragged last tile and a group of 4
    (1, 256, 4, 2, 128, 0),
    (1, 256, 4, 2, 128, 100),
    (2, 200, 4, 1, 64, 0),
]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _hilo(x):
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def _band(qpos, kpos, S, window):
    ok = (qpos[:, None] >= kpos[None, :]) & (kpos[None, :] < S)
    if window:
        ok &= kpos[None, :] > qpos[:, None] - window
    return ok


def _tc_forward(q, k, v, window):
    """The tensor-core forward's arithmetic: online softmax over 64-key
    tiles in float32, P rounded to bf16 for P V, l from the float32 P."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    Dv = v.shape[-1]
    scale = D ** -0.5
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(G, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, 2).transpose(1, 2)
    out = torch.empty(B, H, S, Dv)
    lse = torch.empty(B, H, S)
    for q0 in range(0, S, TC_TILE):
        qi = qf[:, :, q0:q0 + TC_TILE]
        qpos = q0 + torch.arange(qi.shape[2])
        m = torch.full(qi.shape[:3], -1e30)
        l = torch.zeros(qi.shape[:3])
        acc = torch.zeros(*qi.shape[:3], Dv)
        for k0 in range(0, min(S, q0 + TC_TILE), TC_TILE):
            kpos = k0 + torch.arange(min(TC_TILE, S - k0))
            s = qi @ kf[:, :, k0:k0 + TC_TILE].transpose(-1, -2) * scale
            s = torch.where(_band(qpos, kpos, S, window), s,
                            torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _bf16(p) @ vf[:, :, k0:k0 + TC_TILE]
            m = m_new
        lm = l.clamp_min(1e-30)
        out[:, :, q0:q0 + TC_TILE] = acc / lm[..., None]
        lse[:, :, q0:q0 + TC_TILE] = m + torch.log(lm)
    return out.transpose(1, 2).to(torch.bfloat16), lse


def _tc_backward(q, k, v, do, lse, window, split=True):
    """The tensor-core backward's arithmetic: P = exp(S - lse) and delta =
    rowsum(P dP) in float32; dQ from bf16 dS; dK, dV from hi + lo P, dS
    (``split``; else from single bf16 P, dS, the rounding the split
    replaces)."""
    B, S, H, D = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    G = H // KV
    scale = D ** -0.5
    qf, dof = q.float().transpose(1, 2), do.float().transpose(1, 2)
    kf = k.float().repeat_interleave(G, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, 2).transpose(1, 2)
    pos = torch.arange(S)
    s = qf @ kf.transpose(-1, -2) * scale
    p = torch.where(_band(pos, pos, S, window),
                    torch.exp(s - lse[..., None]), torch.tensor(0.0))
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = scale * (_bf16(ds) @ kf)
    rnd = _hilo if split else _bf16
    dk = scale * (rnd(ds).transpose(-1, -2) @ qf)
    dv = rnd(p).transpose(-1, -2) @ dof
    dk = dk.reshape(B, KV, G, S, D).sum(2)
    dv = dv.reshape(B, KV, G, S, Dv).sum(2)
    return [t.transpose(1, 2).to(torch.bfloat16) for t in (dq, dk, dv)]


def _tc_inputs(case, seed):
    B, S, H, KV, D, w = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(torch.bfloat16) for shape in
            ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D))], w


@pytest.mark.parametrize("case", TC_CASES)
def test_tensor_core_forward_rounding_within_chip_limits(case):
    (q, k, v, _), w = _tc_inputs(case, seed=12)
    got, lse = _tc_forward(q, k, v, w)
    want = fa_kernel.plain_flash_attention(q.float(), k.float(), v.float(),
                                           causal=True, sliding_window=w)
    torch.testing.assert_close(got.float(), want, atol=TC_ATOL,
                               rtol=TC_RTOL)
    # the logsumexp the backward reads, against the dense softmax's
    G = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(G, 2)) * q.shape[-1] ** -0.5
    pos = torch.arange(q.shape[1])
    s = torch.where(_band(pos, pos, q.shape[1], w), s, torch.tensor(-1e30))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5,
                               rtol=1e-5)


#: MLA's prefill head dims (q/k 192, v 128), forward only: deepseek-v2-lite's
#: 16 heads at a short prompt, a ragged last tile, a window
TC_MLA_CASES = [
    # B, S, H, D, Dv, window
    (1, 256, 16, 192, 128, 0),
    (1, 150, 4, 192, 128, 0),
    (1, 200, 4, 192, 128, 70),
]


@pytest.mark.parametrize("case", TC_MLA_CASES)
def test_tensor_core_forward_rounding_at_mla_head_dims(case):
    """The tensor-core forward at D = 192, Dv = 128 (three 64-column panels
    of q and k, P V at n = 128): the same one rounding of P, held to the
    float32 plain version within the card's limits."""
    B, S, H, D, Dv, w = case
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(torch.bfloat16) for shape in
               ((B, S, H, D), (B, S, H, D), (B, S, H, Dv)))
    got, _ = _tc_forward(q, k, v, w)
    assert got.shape == (B, S, H, Dv)
    want = fa_kernel.plain_flash_attention(q.float(), k.float(), v.float(),
                                           causal=True, sliding_window=w)
    torch.testing.assert_close(got.float(), want, atol=TC_ATOL,
                               rtol=TC_RTOL)


@pytest.mark.parametrize("case", TC_CASES)
def test_tensor_core_backward_rounding_within_chip_limits(case):
    (q, k, v, do), w = _tc_inputs(case, seed=13)
    _, lse = _tc_forward(q, k, v, w)
    got = _tc_backward(q, k, v, do, lse, w)
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    out = fa_kernel.plain_flash_attention(*leaves, causal=True,
                                          sliding_window=w)
    want = torch.autograd.grad(out, leaves, do.float())
    for name, g, wv in zip("qkv", got, want):
        torch.testing.assert_close(g.float(), wv, atol=TC_ATOL,
                                   rtol=TC_RTOL, msg=f"d{name}")


@pytest.mark.parametrize("case", TC_MLA_CASES)
def test_tensor_core_backward_rounding_at_mla_head_dims(case):
    """The tensor-core backward at D = 192, Dv = 128 (dq and dk over three
    64-column panels, dv and dO over two), rounded as the kernels round it:
    dq from one bf16 dS, dk and dv from hi + lo P and dS, held to the
    float32 plain version's autograd within the card's limits (worst
    element 0.51-0.78 of its limit on dq, 0.25-0.32 on dk and dv). Single
    bf16 P and dS would put dv at 1.11-1.24x of its limit on the first and
    third cases (dk 0.51-0.81x): the split is kept at D = 192."""
    B, S, H, D, Dv, w = case
    rng = np.random.default_rng(15)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   .to(torch.bfloat16) for shape in
                   ((B, S, H, D), (B, S, H, D), (B, S, H, Dv), (B, S, H, Dv)))
    _, lse = _tc_forward(q, k, v, w)
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    out = fa_kernel.plain_flash_attention(*leaves, causal=True,
                                          sliding_window=w)
    want = torch.autograd.grad(out, leaves, do.float())
    got = _tc_backward(q, k, v, do, lse, w)
    for name, g, wv, t in zip("qkv", got, want, (q, k, v)):
        assert g.shape == t.shape
        torch.testing.assert_close(g.float(), wv, atol=TC_ATOL,
                                   rtol=TC_RTOL, msg=f"d{name}")


# ---------------------------------------------------------------------------
# softmax xent
# ---------------------------------------------------------------------------

XENT_CASES = [
    # N, Vl, vocab_offset, dtype
    (64, 1000, 0, "float32"),
    (100, 700, 2100, "float32"),
    (7, 130, 130, "float32"),
    (256, 2048, 4096, "bfloat16"),
]


def _xent_inputs(case, seed=0):
    N, Vl, off, dt = case
    rng = np.random.default_rng(seed)
    logits = _pair(rng.normal(size=(N, Vl)) * 3, dt)
    labels = rng.integers(0, 3 * Vl, size=(N,)).astype(np.int32)
    return logits, (jnp.asarray(labels), torch.from_numpy(labels)), off


@pytest.mark.parametrize("case", XENT_CASES)
def test_plain_xent_matches_pallas_kernel_and_jax_ref(case):
    (lj, lt), (yj, yt), off = _xent_inputs(case)
    got = local_stats_ref(lt, yt, off)
    for want in (xent_local_stats_pallas(lj, yj, off, block_v=256,
                                         interpret=True),
                 jax_local_stats(lj, yj, off)):
        for g, wv in zip(got, want):
            assert g.dtype == torch.float32
            assert_allclose(_np(g), _np(wv), **_tol(case[-1]))


@pytest.mark.parametrize("case", XENT_CASES)
def test_xent_wrapper_takes_plain_path_on_cpu(case):
    (lj, lt), (yj, yt), off = _xent_inputs(case, seed=1)
    got = xent_kernel.xent_local_stats(lt, yt, off)
    assert xent_kernel.launches == xent_kernel.bwd_launches == 0
    for g, wv in zip(got, jax_local_stats(lj, yj, off)):
        assert_allclose(_np(g), _np(wv), **_tol(case[-1]))


def test_xent_shard_combine_matches_full():
    """Four vocab shards' plain stats combine to the dense softmax-xent."""
    rng = np.random.default_rng(10)
    N, V = 32, 1024
    logits = torch.from_numpy((rng.normal(size=(N, V)) * 2).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, V, size=(N,)).astype(np.int32))
    Vl = V // 4
    stats = [local_stats_ref(logits[:, i * Vl:(i + 1) * Vl], labels, i * Vl)
             for i in range(4)]
    got = combine_stats(*(torch.stack([s[i] for s in stats]) for i in range(3)))
    want = jax_xent_ref(jnp.asarray(logits.numpy()), jnp.asarray(labels.numpy()))
    assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)
    assert_allclose(_np(softmax_xent_ref(logits, labels)), _np(want),
                    rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", XENT_CASES[:3])
def test_plain_xent_vjp_matches_jax_vjp(case):
    """The gradient the CUDA backward kernel computes: through s and z
    only, m held fixed (the reference's stop_gradient)."""
    N, Vl, off, _ = case
    rng = np.random.default_rng(11)
    logits = (rng.normal(size=(N, Vl)) * 3).astype(np.float32)
    labels = rng.integers(0, 3 * Vl, size=(N,)).astype(np.int32)
    dm, ds, dz = (rng.normal(size=(N,)).astype(np.float32) for _ in range(3))
    _, vjp = jax.vjp(jax.jit(lambda x: jax_local_stats(
        x, jnp.asarray(labels), off)), jnp.asarray(logits))
    (want,) = vjp((jnp.asarray(dm), jnp.asarray(ds), jnp.asarray(dz)))
    lt = torch.from_numpy(logits).requires_grad_(True)
    m, s, z = xent_kernel.xent_local_stats(lt, torch.from_numpy(labels), off)
    assert not m.requires_grad
    (got,) = torch.autograd.grad((s, z), lt, (torch.from_numpy(ds),
                                              torch.from_numpy(dz)))
    assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_combine_stats_over_an_axis_is_not_ported():
    """The collective form: ``combine_stats(axis_name=)`` inside spmd over
    four vocab shards gives every rank the stacked form's loss. (The name
    dates from before the mesh substrate, when this form raised.)"""
    from repro_torch.core.mesh import spmd
    from repro_torch.core.placement import Placement
    N, Vl, n = 6, 16, 4
    rng = np.random.default_rng(12)
    logits = torch.from_numpy((rng.normal(size=(N, n * Vl)) * 3)
                              .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, n * Vl, N).astype(np.int32))
    stats = [local_stats_ref(logits[:, r * Vl:(r + 1) * Vl], labels, r * Vl)
             for r in range(n)]
    want = combine_stats(*(torch.stack([st[i] for st in stats])
                           for i in range(3)))
    mesh = Placement(("model",), (n,)).to_mesh("cpu")
    got = spmd(lambda m, s, z: combine_stats(m, s, z, axis_name="model"),
               mesh)(*([st[i] for st in stats] for i in range(3)))
    for g in got:
        assert_allclose(_np(g), _np(want), rtol=1e-6, atol=1e-6)
    assert_allclose(_np(want), _np(softmax_xent_ref(logits, labels)),
                    rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# flash decode
# ---------------------------------------------------------------------------

DECODE_CASES = [
    # B, H, KV, D, L, window, dtype
    (2, 4, 2, 16, 64, 0, "float32"),
    (1, 8, 8, 32, 100, 17, "float32"),
    (3, 4, 1, 64, 96, 0, "bfloat16"),
]


def _decode_inputs(case, seed=0):
    B, H, KV, D, L, w, dt = case
    rng = np.random.default_rng(seed)
    q = _pair(rng.normal(size=(B, H, D)), dt)
    k = _pair(rng.normal(size=(B, L, KV, D)), dt)
    v = _pair(rng.normal(size=(B, L, KV, D)), dt)
    cur = rng.integers(10, L, size=(B,)).astype(np.int32)
    return q, k, v, (jnp.asarray(cur), torch.from_numpy(cur)), w


@pytest.mark.parametrize("case", DECODE_CASES)
def test_plain_decode_matches_pallas_kernel(case):
    (qj, qt), (kj, kt), (vj, vt), (cj, ct), w = _decode_inputs(case)
    m1, l1, a1 = flash_decode_pallas(qj, kj, vj, cur_pos=cj,
                                     sliding_window=w, block_k=16,
                                     interpret=True)
    m2, l2, a2 = flash_decode_partial_ref(qt, kt, vt, cur_pos=ct,
                                          sliding_window=w)
    o1 = a1 / jnp.maximum(l1, 1e-30)[..., None]
    o2 = a2 / torch.clamp_min(l2, 1e-30)[..., None]
    assert_allclose(_np(o2), _np(o1), **_tol(case[-1]))
    assert_allclose(_np(m2), _np(m1), **_tol(case[-1]))


@pytest.mark.parametrize("case", DECODE_CASES)
def test_plain_decode_partials_match_jax_ref(case):
    (qj, qt), (kj, kt), (vj, vt), (cj, ct), w = _decode_inputs(case, seed=1)
    want = jax_decode_partial(qj, kj, vj, cur_pos=cj, sliding_window=w)
    got = flash_decode_partial_ref(qt, kt, vt, cur_pos=ct, sliding_window=w)
    for g, wv in zip(got, want):
        assert g.dtype == torch.float32
        assert_allclose(_np(g), _np(wv), **_tol(case[-1]))


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_wrapper_takes_plain_path_on_cpu(case):
    (qj, qt), (kj, kt), (vj, vt), (cj, ct), w = _decode_inputs(case, seed=2)
    before = fd_kernel.launches
    m, l, acc = fd_kernel.flash_decode(qt, kt, vt, cur_pos=ct,
                                       sliding_window=w)
    assert fd_kernel.launches == before == 0
    got = combine_partials(m[None], l[None], acc[None])
    want = jax_decode_ref(qj, kj, vj, cj, sliding_window=w)
    assert_allclose(_np(got), _np(want), **_tol(case[-1]))
    assert_allclose(_np(decode_attention_ref(qt, kt, vt, ct, sliding_window=w)),
                    _np(want), **_tol(case[-1]))


def test_decode_shard_combine():
    """Partials from 4 disjoint cache shards combine to the full attention —
    the P(max)/P(sum) algebra of the distributed decode."""
    rng = np.random.default_rng(6)
    B, H, KV, D, L = 2, 4, 2, 16, 64
    q = _pair(rng.normal(size=(B, H, D)), "float32")
    k = _pair(rng.normal(size=(B, L, KV, D)), "float32")
    v = _pair(rng.normal(size=(B, L, KV, D)), "float32")
    cur = np.asarray([40, 63], np.int32)
    parts = [flash_decode_partial_ref(
        q[1], k[1][:, i * 16:(i + 1) * 16], v[1][:, i * 16:(i + 1) * 16],
        cur_pos=torch.from_numpy(cur), k_offset=i * 16) for i in range(4)]
    got = combine_partials(*(torch.stack([p[i] for p in parts])
                             for i in range(3)))
    want = jax_decode_ref(q[0], k[0], v[0], jnp.asarray(cur))
    assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("ns", [1, 2, 4, 8, 16])
def test_wrapper_split_combine_matches_single_shard(ns):
    """The kernel's combine over ``ns`` splits of each row's range, fed by
    the plain partials of each split, equals the one-shard attention."""
    rng = np.random.default_rng(7)
    B, H, KV, D, L = 3, 4, 2, 16, 150
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, L, KV, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, L, KV, D)).astype(np.float32))
    cur = torch.tensor([5, 70, 149], dtype=torch.int32)
    m, l, acc = fd_kernel.combine_splits(
        *fd_kernel.split_partials_ref(q, k, v, cur, ns))
    got = acc / torch.clamp_min(l, 1e-30)[..., None]
    want = decode_attention_ref(q, k, v, cur)
    assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("L,cur", [(569, [70, 300, 511, 568]),
                                   (150, [5, 70, 149, 10]),
                                   (150, [1, 0, 149, 2])])
def test_kernel_split_fold_matches_combine_partials(L, cur):
    """The kernel's combine -- the blocks of a cluster fold the splits'
    partials in split order (``combine_splits``) -- equals
    ``combine_partials`` of the same splits of the qwen3 plan, including
    empty splits of rows with fewer keys than splits."""
    rng = np.random.default_rng(11)
    B, H, KV, D = 4, 16, 8, 128
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, L, KV, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, L, KV, D)).astype(np.float32))
    cur = torch.tensor(cur, dtype=torch.int32)
    parts = fd_kernel.split_partials_ref(q, k, v, cur,
                                         fd_kernel.split_plan(B, KV, L))
    _, l, acc = fd_kernel.combine_splits(*parts)
    got = acc / torch.clamp_min(l, 1e-30)[..., None]
    want = combine_partials(*(t.transpose(0, 1) for t in parts))
    assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_single_shard_normalisation_equals_combine_partials(case):
    """``gqa_decode`` divides the one shard's acc by its l, which is
    ``combine_partials`` of that shard bit for bit (its weight is
    exp(m - m) = 1): on the port's CPU outputs, and on a fully masked row
    (a shard wholly after cur_pos)."""
    (_, qt), (_, kt), (_, vt), (_, ct), w = _decode_inputs(case, seed=12)
    for koff in (0, kt.shape[1]):
        m, l, acc = fd_kernel.flash_decode(qt, kt, vt, cur_pos=ct,
                                           k_offset=koff, sliding_window=w)
        got = acc / torch.clamp_min(l, 1e-30)[..., None]
        assert torch.equal(got, combine_partials(m[None], l[None],
                                                 acc[None]))


def test_decode_k_positions_matches_jax():
    """Ring-buffer caches: explicit per-slot positions (-1 = empty)."""
    rng = np.random.default_rng(8)
    B, H, KV, D, L = 2, 4, 2, 16, 12
    q = _pair(rng.normal(size=(B, H, D)), "float32")
    k = _pair(rng.normal(size=(B, L, KV, D)), "float32")
    v = _pair(rng.normal(size=(B, L, KV, D)), "float32")
    kpos = np.stack([np.r_[np.arange(20, 32)],
                     np.r_[np.arange(0, 7), -np.ones(5)]]).astype(np.int32)
    cur = np.asarray([31, 6], np.int32)
    want = jax_decode_partial(q[0], k[0], v[0], cur_pos=jnp.asarray(cur),
                              sliding_window=8, k_positions=jnp.asarray(kpos))
    got = flash_decode_partial_ref(q[1], k[1], v[1],
                                   cur_pos=torch.from_numpy(cur),
                                   sliding_window=8,
                                   k_positions=torch.from_numpy(kpos))
    for g, wv in zip(got, want):
        assert_allclose(_np(g), _np(wv), rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# no fallback: a non-CPU tensor goes to the kernel or raises
# ---------------------------------------------------------------------------

def test_flash_wrapper_refuses_non_cuda_device():
    q = torch.empty((1, 8, 2, 64), device="meta")
    k = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="card"):
        fa_kernel.flash_attention(q, k, k)
    assert fa_kernel.launches == 0


def test_decode_wrapper_refuses_non_cuda_device():
    q = torch.empty((1, 2, 64), device="meta")
    k = torch.empty((1, 8, 2, 64), device="meta")
    cur = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="card"):
        fd_kernel.flash_decode(q, k, k, cur_pos=cur)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fd_kernel.flash_decode(q, k, k, cur_pos=cur,
                               k_positions=torch.zeros((1, 8), device="meta"))
    assert fd_kernel.launches == 0


def test_xent_wrapper_refuses_non_cuda_device():
    logits = torch.empty((4, 64), device="meta")
    labels = torch.zeros((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="card"):
        xent_kernel.xent_local_stats(logits, labels, 0)
    with pytest.raises(ValueError, match="card"):
        xent_kernel.xent_local_stats(logits.requires_grad_(True), labels, 0)
    assert xent_kernel.launches == xent_kernel.bwd_launches == 0


@pytest.mark.parametrize("wrapper", ["flash_attention", "flash_attention_bwd",
                                     "flash_decode", "xent", "xent_bwd"])
def test_raw_wrappers_refuse_to_cut_the_graph(wrapper):
    """A raw wrapper writes through ctypes; under autograd with an input
    that requires grad it raises instead of returning an output with no
    link to its inputs."""
    meta = dict(device="meta", requires_grad=True)
    q = torch.empty((1, 8, 2, 64), **meta)
    logits = torch.empty((4, 64), **meta)
    labels = torch.zeros((4,), dtype=torch.int32, device="meta")
    stat = torch.empty((4,), device="meta")
    calls = {
        "flash_attention": lambda: fa_kernel.flash_attention_cuda(q, q, q),
        "flash_attention_bwd": lambda: fa_kernel.flash_attention_bwd_cuda(
            q, q, q, torch.empty((1, 2, 8), device="meta"), q),
        "flash_decode": lambda: fd_kernel.flash_decode_cuda_partials(
            q[:, 0], q, q, torch.zeros((1,), dtype=torch.int32,
                                       device="meta")),
        "xent": lambda: xent_kernel.xent_local_stats_cuda(logits, labels, 0),
        "xent_bwd": lambda: xent_kernel.xent_local_stats_bwd_cuda(
            logits, labels, 0, stat, stat, stat),
    }
    with pytest.raises(RuntimeError, match="cut the autograd graph"):
        calls[wrapper]()
    with torch.no_grad(), pytest.raises(ValueError, match="card"):
        calls[wrapper]()          # without autograd: the device check


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """A built kernel library is named by a hash of its source and of every
    shared header in csrc/, so editing a header that a source includes
    rebuilds it instead of loading the stale library."""
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k.cu")
    assert first == _build.library_path("k.cu")
    (tmp_path / "h.cuh").write_text("// v2\n")
    assert _build.library_path("k.cu") != first


@pytest.mark.parametrize("kw", [dict(causal=False, sliding_window=4),
                                dict(q_offset=4)])
def test_flash_attention_backward_scope_raises(kw):
    """The CUDA backward takes q_offset 0, causal or not, and a sliding
    window only with causal masking; other calls that need a gradient raise
    before launching."""
    q = torch.empty((1, 8, 2, 64), device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fa_kernel.flash_attention(q, q, q, **kw)
    with torch.no_grad(), pytest.raises(ValueError, match="card"):
        fa_kernel.flash_attention(q, q, q, **kw)
