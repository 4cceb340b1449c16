"""The port's SSD scan twins against the JAX package's, on the CPU.

Inputs come from a numpy seed and go through both packages: the four
``SSD_CASES`` of ``test_kernels.py`` plus L = 77 at chunk 16 (a ragged tail
chunk). The JAX Pallas kernel runs with ``interpret=True``, as
``test_kernels.py`` runs it. Tolerances are that file's: float32
``rtol=2e-4, atol=2e-5`` (XLA and PyTorch sum in different orders), the
float32 state ``hT`` at ``1e-4``; bfloat16 ``2e-2``.

The CUDA kernel runs only on the card (``test_torch_gpu.py``); here the
wrapper must take the plain path for CPU tensors and never launch.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.kernel import ssd_scan_pallas  # noqa: E402
from repro.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked_ref as jax_chunked, ssd_decode_step as jax_decode_step,
    ssd_sequential_ref as jax_sequential)
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked_ref, ssd_decode_step, ssd_sequential_ref)
from torch_threads import one_intra_op_thread  # noqa: E402,F401

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

SSD_CASES = [
    # B, L, H, P, N, G, chunk, dtype
    (2, 67, 4, 8, 16, 1, 16, "float32"),
    (1, 128, 2, 16, 8, 2, 32, "float32"),
    (1, 64, 4, 32, 16, 1, 128, "float32"),     # chunk > L
    (2, 96, 4, 16, 16, 1, 32, "bfloat16"),
    (2, 77, 4, 8, 16, 1, 16, "float32"),       # ragged tail chunk
]


def _tol(dtype: str):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-5)


def _state_tol(dtype: str):
    tol = _tol(dtype)
    return dict(rtol=max(tol["rtol"], 1e-4), atol=max(tol["atol"], 1e-4))


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, JNP[dtype])
    return j, torch.from_numpy(np.array(j, np.float32)).to(TORCH[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _inputs(case, seed=0):
    """(jax args, torch args, chunk, dtype) of one case."""
    B, L, H, P, N, G, Q, dt = case
    rng = np.random.default_rng(seed)
    x = _pair(rng.normal(size=(B, L, H, P)), dt)
    dtv = _pair(rng.uniform(0.01, 0.2, size=(B, L, H)), "float32")
    A = _pair(-rng.uniform(0.5, 2, size=(H,)), "float32")
    Bm = _pair(rng.normal(size=(B, L, G, N)), dt)
    Cm = _pair(rng.normal(size=(B, L, G, N)), dt)
    D = _pair(rng.normal(size=(H,)), "float32")
    args = (x, dtv, A, Bm, Cm, D)
    return [a[0] for a in args], [a[1] for a in args], Q, dt


@pytest.mark.parametrize("case", SSD_CASES)
def test_chunked_twin_matches_pallas_kernel(case):
    ja, ta, Q, dt = _inputs(case)
    yj, hj = ssd_scan_pallas(*ja, chunk=Q, interpret=True)
    yt, ht = ssd_chunked_ref(*ta, chunk=Q)
    assert yt.dtype == TORCH[dt] and ht.dtype == torch.float32
    assert yt.shape == ta[0].shape and ht.shape == tuple(hj.shape)
    assert_allclose(_np(yt), _np(yj), **_tol(dt))
    assert_allclose(_np(ht), _np(hj), **_state_tol(dt))


@pytest.mark.parametrize("case", SSD_CASES)
def test_chunked_twin_matches_jax_sequential(case):
    ja, ta, Q, dt = _inputs(case, seed=1)
    yj, hj = jax_sequential(*ja)
    yt, ht = ssd_chunked_ref(*ta, chunk=Q)
    assert_allclose(_np(yt), _np(yj), **_tol(dt))
    assert_allclose(_np(ht), _np(hj), **_state_tol(dt))


@pytest.mark.parametrize("case", SSD_CASES)
def test_sequential_twin_matches_jax_and_chunked_twin(case):
    ja, ta, Q, dt = _inputs(case, seed=2)
    ys, hs = ssd_sequential_ref(*ta)
    yj, hj = jax_sequential(*ja)
    assert_allclose(_np(ys), _np(yj), **_tol(dt))
    assert_allclose(_np(hs), _np(hj), **_state_tol(dt))
    yc, hc = ssd_chunked_ref(*ta, chunk=Q)
    assert_allclose(_np(yc), _np(ys), **_tol(dt))
    assert_allclose(_np(hc), _np(hs), **_state_tol(dt))


@pytest.mark.parametrize("chunk", [16, 32])
def test_chunked_twin_carries_h0_as_jax(chunk):
    """``h0=`` starts the recurrence from a given state, as the reference."""
    ja, ta, _, _ = _inputs((1, 50, 4, 8, 16, 2, chunk, "float32"), seed=3)
    h0 = np.random.default_rng(4).normal(size=(1, 4, 8, 16)).astype(np.float32)
    yj, hj = jax_chunked(*ja, h0=jnp.asarray(h0), chunk=chunk)
    yt, ht = ssd_chunked_ref(*ta, h0=torch.from_numpy(h0), chunk=chunk)
    assert_allclose(_np(yt), _np(yj), **_tol("float32"))
    assert_allclose(_np(ht), _np(hj), **_state_tol("float32"))
    ys, hs = ssd_sequential_ref(*ta, h0=torch.from_numpy(h0))
    assert_allclose(_np(ys), _np(yt), **_tol("float32"))


@pytest.mark.parametrize("G,dtype", [(1, "float32"), (2, "float32"),
                                     (1, "bfloat16")])
def test_decode_step_twin_matches_jax(G, dtype):
    B, H, P, N = 3, 4, 8, 16
    rng = np.random.default_rng(5)
    x = _pair(rng.normal(size=(B, H, P)), dtype)
    dtv = _pair(rng.uniform(0.01, 0.2, size=(B, H)), "float32")
    A = _pair(-rng.uniform(0.5, 2, size=(H,)), "float32")
    Bm = _pair(rng.normal(size=(B, G, N)), dtype)
    Cm = _pair(rng.normal(size=(B, G, N)), dtype)
    D = _pair(rng.normal(size=(H,)), "float32")
    h = _pair(rng.normal(size=(B, H, P, N)), "float32")
    args = (x, dtv, A, Bm, Cm, D, h)
    yj, hj = jax_decode_step(*[a[0] for a in args])
    yt, ht = ssd_decode_step(*[a[1] for a in args])
    assert yt.dtype == TORCH[dtype] and ht.dtype == torch.float32
    assert_allclose(_np(yt), _np(yj), **_tol(dtype))
    assert_allclose(_np(ht), _np(hj), **_state_tol(dtype))


def test_decode_steps_continue_the_scan():
    """A scan over L steps, then one decode step, equals the scan over
    L + 1 steps: the decode recurrence carries the chunked state on."""
    _, ta, Q, _ = _inputs((2, 40, 4, 8, 16, 2, 16, "float32"), seed=6)
    x, dtv, A, Bm, Cm, D = ta
    y_all, h_all = ssd_chunked_ref(*ta, chunk=Q)
    _, h = ssd_chunked_ref(x[:, :-1], dtv[:, :-1], A, Bm[:, :-1],
                           Cm[:, :-1], D, chunk=Q)
    y1, h1 = ssd_decode_step(x[:, -1], dtv[:, -1], A, Bm[:, -1], Cm[:, -1],
                             D, h)
    assert_allclose(_np(y1), _np(y_all[:, -1]), rtol=1e-4, atol=1e-5)
    assert_allclose(_np(h1), _np(h_all), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", SSD_CASES[:2])
def test_wrapper_takes_plain_path_on_cpu(case):
    _, ta, Q, _ = _inputs(case, seed=7)
    before = ssd_kernel.launches
    y, h = ssd_kernel.ssd_scan(*ta, chunk=Q)
    assert ssd_kernel.launches == before
    yr, hr = ssd_chunked_ref(*ta, chunk=Q)
    assert torch.equal(y, yr) and torch.equal(h, hr)


def test_wrapper_refuses_other_devices():
    """A tensor on neither the CPU nor a card reaches the CUDA wrapper,
    which refuses it: there is no fallback to the plain version."""
    _, ta, Q, _ = _inputs(SSD_CASES[0], seed=8)
    meta = [t.to("meta") for t in ta]
    with pytest.raises(ValueError, match="card"):
        ssd_kernel.ssd_scan(*meta, chunk=Q)


def test_raw_wrapper_refuses_under_grad():
    _, ta, Q, _ = _inputs(SSD_CASES[0], seed=9)
    ta[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="cut the autograd graph"):
        ssd_kernel.ssd_scan_cuda(*ta, chunk=Q)
