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
bfloat16 before the scale, and an output in bf16 may round either way.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ref import attention_dense_ref
from repro_torch.kernels.flash_decode import kernel as fd
from repro_torch.kernels.flash_decode.ref import combine_partials

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
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, case):
    B, Sq, Sk, H, KV, D, causal, w, qoff, dt = case
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, Sq, H, D), dt, cuda)
    k = _randn(rng, (B, Sk, KV, D), dt, cuda)
    v = _randn(rng, (B, Sk, KV, D), dt, cuda)
    kw = dict(causal=causal, sliding_window=w, q_offset=qoff)
    before = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
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
