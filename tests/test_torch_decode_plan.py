"""The decode kernel's split plan and its plain fold, on the CPU.

The CUDA kernel (``src/repro_torch/csrc/flash_decode.cu``) launches one
thread-block cluster of ``split_plan(B, KV, L)`` blocks per (batch row, kv
head) group, cuts each row's unmasked key range into that many even parts
(``split_bounds``) and folds the parts' partials in split order
(``combine_splits``). The kernel runs only on the card
(``test_torch_gpu.py``); here the plan is pinned and the same algorithm in
plain PyTorch (``split_partials_ref`` folded by ``combine_splits``) is held
to ``combine_partials``, ``decode_attention_ref`` and the JAX
``flash_decode_pallas`` in interpret mode (as ``tests/test_kernels.py``
runs it), float32, at ``rtol=1e-4, atol=1e-5``: the same partials summed in
another order.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_decode.kernel import flash_decode_pallas  # noqa: E402
from repro_torch.kernels.flash_decode import kernel as fd  # noqa: E402
from repro_torch.kernels.flash_decode.ref import (  # noqa: E402
    combine_partials, decode_attention_ref, flash_decode_partial_ref)

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("B,KV,L", [(4, 8, 569), (4, 8, 8192), (1, 8, 8192),
                                    (2, 8, 40), (1, 1, 16), (3, 2, 150),
                                    (64, 8, 4096), (2, 1, 300)])
@pytest.mark.parametrize("window,k_offset", [(0, 0), (37, 0), (0, 40),
                                             (100, 64)])
def test_split_plan_covers_each_row_once_in_order(B, KV, L, window,
                                                  k_offset):
    """Each row's splits tile its unmasked range [lo, hi] exactly once, in
    order, in parts that differ by at most one key; a row with no unmasked
    key tiles the whole cache; at most 16 splits, a power of two."""
    ns = fd.split_plan(B, KV, L)
    assert 1 <= ns <= fd.MAX_SPLITS and ns & (ns - 1) == 0
    rng = np.random.default_rng(L + B)
    cur = rng.integers(0, L + k_offset + 5, size=(32,))
    cur[:3] = (0, k_offset - 1, L + k_offset - 1)
    kpos = k_offset + np.arange(L)
    for c, (masked, starts) in zip(cur, fd.split_bounds(
            cur, L, ns, k_offset=k_offset, sliding_window=window)):
        keep = kpos <= c
        if window:
            keep &= kpos > c - window
        want = np.flatnonzero(keep) if keep.any() else np.arange(L)
        assert masked == (not keep.any())
        assert len(starts) == ns + 1
        assert starts[0] == want[0] and starts[-1] == want[-1] + 1
        sizes = np.diff(starts)
        assert (sizes >= 0).all() and sizes.max() - sizes.min() <= 1
        assert sizes.sum() == len(want)


@pytest.mark.parametrize("B,KV,L", [(4, 8, 569), (4, 8, 8192),
                                    (1, 8, 8192)])
def test_split_plan_grid_covers_the_card(B, KV, L):
    """At qwen3's serve shape and at a long cache the grid covers the
    H100's 132 SMs once: at most one block an SM, and no power of two more
    splits would still fit."""
    ns = fd.split_plan(B, KV, L)
    assert B * KV * ns <= fd.H100_SMS < B * KV * ns * 2
    assert B * KV * ns >= 0.9 * fd.H100_SMS


def test_split_plan_limits():
    assert fd.split_plan(4, 8, 569) == 4                   # qwen3 serve
    assert fd.split_plan(1, 8, 8192) == fd.MAX_SPLITS       # 8 groups
    assert fd.split_plan(1, 1, 8192) == fd.MAX_SPLITS
    assert fd.split_plan(2, 8, 40) == 1                    # under one tile
    assert fd.split_plan(64, 8, 8192) == 1                 # 512 groups
    assert fd.split_plan(4, 8, 569, sms=264) == 8
    assert fd.split_plan(1, 1, 100) == 2                   # 100 keys < 4 x 32


FOLD_CASES = [
    # B, H, KV, D, L, cur_pos, window, k_offset
    (4, 4, 2, 16, 150, [0, 2, 70, 149], 0, 0),      # empty splits
    (3, 4, 2, 16, 200, [150, 199, 20], 37, 0),      # window over borders
    (3, 4, 2, 16, 64, [70, 100, 30], 0, 40),        # shard; row 2 masked
    (2, 16, 1, 32, 96, [20, 95], 0, 0),             # group of 16
    (2, 16, 1, 32, 96, [60, 95], 25, 0),            # group of 16, window
]


@pytest.mark.parametrize("case", FOLD_CASES)
@pytest.mark.parametrize("ns", [None, 3, 16])
def test_split_fold_matches_references(case, ns):
    """The plain fold over the plan's splits (and over 3 and 16 splits)
    equals ``combine_partials`` of the one-shard partials, the JAX Pallas
    kernel in interpret mode and, on an unsharded cache,
    ``decode_attention_ref``."""
    B, H, KV, D, L, cur, w, koff = case
    rng = np.random.default_rng(sum(cur) + L)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, H, D), (B, L, KV, D), (B, L, KV, D)))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    ct = torch.tensor(cur, dtype=torch.int32)
    ns = ns or fd.split_plan(B, KV, L)
    m, l, acc = fd.combine_splits(*fd.split_partials_ref(
        qt, kt, vt, ct, ns, k_offset=koff, sliding_window=w))
    got = (acc / torch.clamp_min(l, 1e-30)[..., None]).numpy()

    pm, pl, pacc = flash_decode_partial_ref(qt, kt, vt, k_offset=koff,
                                            cur_pos=ct, sliding_window=w)
    assert_allclose(got, combine_partials(pm[None], pl[None],
                                          pacc[None]).numpy(), **TOL)
    assert_allclose(m.numpy(), pm.numpy(), **TOL)
    assert_allclose(l.numpy(), pl.numpy(), **TOL)

    jm, jl, jacc = flash_decode_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        cur_pos=jnp.asarray(cur, jnp.int32), k_offset=koff,
        sliding_window=w, block_k=16, interpret=True)
    jout = np.asarray(jacc) / np.maximum(np.asarray(jl), 1e-30)[..., None]
    assert_allclose(got, jout, **TOL)
    assert_allclose(m.numpy(), np.asarray(jm), **TOL)
    if koff == 0:
        assert_allclose(got, decode_attention_ref(
            qt, kt, vt, ct, sliding_window=w).numpy(), **TOL)
