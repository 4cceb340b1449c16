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
holds the training shape.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ref import attention_dense_ref
from repro_torch.kernels.flash_decode import kernel as fd
from repro_torch.kernels.flash_decode.ref import combine_partials
from repro_torch.kernels.softmax_xent import kernel as xk
from repro_torch.kernels.softmax_xent.ref import local_stats_ref
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


@pytest.mark.parametrize("kw", [dict(causal=False), dict(q_offset=8),
                                dict(sk=48)])
def test_flash_attention_backward_scope_raises(cuda, kw):
    """Cross-attention, q_offset and a non-causal mask have no CUDA
    backward yet: asking for one raises before any launch."""
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
    before = ssd.launches
    y, hT = ssd.ssd_scan(*args, chunk=Q)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    assert y.dtype == args[0].dtype and y.shape == args[0].shape
    assert hT.dtype == torch.float32
    yr, hr = ssd_chunked_ref(*args, chunk=Q)
    _close(y, yr, dt)
    torch.testing.assert_close(hT, hr, rtol=2e-4, atol=2e-4)
    # on float32 copies of the same inputs, and with B and C contiguous
    f32 = [t.float().contiguous() for t in args]
    y32, h32 = ssd.ssd_scan(*f32, chunk=Q)
    yr32, hr32 = ssd_chunked_ref(*f32, chunk=Q)
    _close(y32, yr32, "float32")
    torch.testing.assert_close(h32, hr32, rtol=2e-4, atol=2e-4)


def test_ssd_scan_reads_strided_views_as_copies(cuda):
    args, Q = _ssd_case((1, 200, 4, 32, 32, 2, 64, "bfloat16"), cuda, seed=1)
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
