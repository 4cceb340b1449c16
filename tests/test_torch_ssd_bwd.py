"""The SSD scan's plain backward, ``ssd_chunked_bwd_ref``, on the CPU.

``ssd_chunked_bwd_ref`` writes out, in the order the backward kernels
(``csrc/ssd_scan_bwd.cu``) run it, the gradient of ``ssd_chunked_ref``'s
``(y, hT)`` with respect to ``(x, dt, A, Bm, Cm, D)``; the reference has no
such function, because it differentiates the jnp ``ssd_chunked_ref`` by
autodiff. Its oracles:

* autograd through the port's ``ssd_chunked_ref`` and ``ssd_sequential_ref``
  in float64, within 1e-10 relative in norm (measured about 1e-15: the same
  sums in another order);
* ``jax.vjp`` of the JAX package's ``ssd_chunked_ref`` in float32, within
  1e-5 relative in norm (float32 sums in different orders, over up to 300
  steps);
* ``torch.autograd.gradcheck`` of the CPU route of ``ssd_scan`` (autograd
  through ``ssd_chunked_ref``) at a tiny size, in float64.

Inputs come from a numpy seed: the five cases of ``test_torch_ssd.py``,
plus a ragged L with G = 2, one chunk longer than L at P 64 and N 128, and
G = 4 with a ragged tail; each with ``dhT`` given and with None (zero). The
kernels themselves run only on the card (``test_torch_gpu.py``).
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked_ref as jax_chunked)
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked_bwd_ref, ssd_chunked_ref, ssd_sequential_ref)
from torch_threads import one_intra_op_thread  # noqa: E402,F401

CASES = [
    # B, L, H, P, N, G, chunk
    (2, 67, 4, 8, 16, 1, 16),
    (1, 128, 2, 16, 8, 2, 32),
    (1, 64, 4, 32, 16, 1, 128),         # chunk > L
    (2, 96, 4, 16, 16, 1, 32),
    (2, 77, 4, 8, 16, 1, 16),           # ragged tail chunk
    (1, 45, 4, 32, 32, 2, 16),          # ragged, G = 2
    (1, 20, 2, 64, 128, 1, 128),        # L < chunk, P 64, N 128
    (1, 150, 4, 64, 32, 4, 64),         # G = 4, ragged
]
IDS = ["x".join(map(str, c)) for c in CASES]
NAMES = ("x", "dt", "A", "Bm", "Cm", "D")


def _inputs(case, seed, dtype=np.float64):
    """Numpy arrays ``(x, dt, A, Bm, Cm, D, dy, dhT)`` of one case."""
    B, L, H, P, N, G, _ = case
    rng = np.random.default_rng(seed)
    return [a.astype(dtype) for a in (
        rng.normal(size=(B, L, H, P)), rng.uniform(0.01, 0.2, (B, L, H)),
        -rng.uniform(0.5, 2, (H,)), rng.normal(size=(B, L, G, N)),
        rng.normal(size=(B, L, G, N)), rng.normal(size=(H,)),
        rng.normal(size=(B, L, H, P)), rng.normal(size=(B, H, P, N)))]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check(got, want, limit):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        err = _rel(g, w)
        assert err <= limit, f"d{name}: {err:.3e} relative (limit {limit})"


@pytest.mark.parametrize("with_dhT", [True, False], ids=["dhT", "no_dhT"])
@pytest.mark.parametrize("oracle", ["chunked", "sequential"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_matches_autograd_in_float64(case, oracle, with_dhT):
    *ins, dy, dhT = (torch.from_numpy(a) for a in _inputs(case, seed=1))
    if not with_dhT:
        dhT = None
    ins = [t.requires_grad_(True) for t in ins]
    fwd = (ssd_sequential_ref if oracle == "sequential"
           else lambda *a: ssd_chunked_ref(*a, chunk=case[-1]))
    y, hT = fwd(*ins)
    assert y.dtype == hT.dtype == torch.float64
    loss = (y * dy).sum() + ((hT * dhT).sum() if with_dhT else 0.0)
    want = torch.autograd.grad(loss, ins)
    got = ssd_chunked_bwd_ref(*(t.detach() for t in ins), dy, dhT,
                              chunk=case[-1])
    assert [g.dtype for g in got] == [torch.float64] * 6
    _check([g.numpy() for g in got], [w.numpy() for w in want], 1e-10)


@functools.lru_cache(maxsize=None)
def _jax_vjp(chunk: int):
    """``(inputs, (dy, dhT)) -> gradients`` of the JAX ``ssd_chunked_ref``,
    jitted (one compile a shape, shared by both cotangents)."""
    return jax.jit(lambda ins, ct: jax.vjp(
        lambda *a: jax_chunked(*a, chunk=chunk), *ins)[1](ct))


@pytest.mark.parametrize("with_dhT", [True, False], ids=["dhT", "no_dhT"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_matches_jax_vjp_in_float32(case, with_dhT):
    *ins, dy, dhT = _inputs(case, seed=2, dtype=np.float32)
    Q = case[-1]
    want = _jax_vjp(Q)(ins, (dy, dhT if with_dhT else np.zeros_like(dhT)))
    got = ssd_chunked_bwd_ref(*(torch.from_numpy(a) for a in ins),
                              torch.from_numpy(dy),
                              torch.from_numpy(dhT) if with_dhT else None,
                              chunk=Q)
    assert [g.dtype for g in got] == [torch.float32] * 6
    _check([g.numpy() for g in got], [np.asarray(w) for w in want], 1e-5)


def test_bf16_inputs_give_bf16_gradients():
    """The gradients come back in the inputs' dtypes: bf16 for x, Bm, Cm,
    float32 for dt, A, D; the math runs in float32, so they are the float32
    run's gradients on the same (bf16) values, rounded once."""
    *ins, dy, dhT = _inputs(CASES[3], seed=3, dtype=np.float32)
    t = [torch.from_numpy(a) for a in ins]
    for i in (0, 3, 4):
        t[i] = t[i].to(torch.bfloat16)
    dy16 = torch.from_numpy(dy).to(torch.bfloat16)
    got = ssd_chunked_bwd_ref(*t, dy16, torch.from_numpy(dhT), chunk=32)
    assert [g.dtype for g in got] == [a.dtype for a in t]
    want = ssd_chunked_bwd_ref(*(a.float() for a in t), dy16.float(),
                               torch.from_numpy(dhT), chunk=32)
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))


def test_cpu_route_passes_gradcheck():
    """``ssd_scan`` on CPU tensors is ``ssd_chunked_ref``, and autograd
    differentiates it: gradcheck in float64 with both outputs used, two
    chunks of 4 and a ragged tail, G = 2."""
    *ins, _, _ = _inputs((1, 10, 2, 3, 4, 2, 4), seed=4)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    before = ssd_kernel.launches, dict(ssd_kernel.bwd_launches)
    assert torch.autograd.gradcheck(
        lambda *a: ssd_kernel.ssd_scan(*a, chunk=4), ins)
    assert (ssd_kernel.launches, ssd_kernel.bwd_launches) == before


def test_backward_wrapper_refuses_cpu_tensors():
    """The backward's raw wrapper launches the kernels or raises: a CPU
    tensor is refused before anything is built, and nothing is counted."""
    *ins, dy, _ = (torch.from_numpy(a) for a in _inputs(
        CASES[0], seed=5, dtype=np.float32))
    before = dict(ssd_kernel.bwd_launches)
    with pytest.raises(ValueError, match="must be on x's card"):
        ssd_kernel.ssd_scan_bwd_cuda(*ins, dy, chunk=16)
    assert ssd_kernel.bwd_launches == before
    assert set(ssd_kernel.bwd_launches) == (set(ssd_kernel.BWD_KERNELS)
                                            | set(ssd_kernel.BWD_TC_KERNELS))
