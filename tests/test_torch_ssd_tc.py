"""The chunk-parallel form of the SSD scan's tensor-core kernels, on the CPU.

``csrc/ssd_scan.cu`` runs bf16 inputs through three kernels: per chunk the
chunk's own state ``S_c`` (pass 1), the carry of the state over the chunks
(pass 2), and per chunk the outputs from the scores and the entering state
(pass 3). This file holds a plain PyTorch twin of that decomposition,
pass by pass, and checks it here before any card runs:

* in float32, against the port's ``ssd_chunked_ref`` and the JAX
  ``ssd_scan_pallas`` in interpret mode over ``SSD_CASES`` of
  ``test_torch_ssd.py``, at ``rtol=1e-4, atol=1e-5`` (the same arithmetic,
  summed in another order);
* with the kernels' bf16 operand rounding emulated, at the mamba2-370m
  prefill shape, against the plain version within ``chip_smoke.py``'s bf16
  limit on y (``5e-3 + 1e-2 |ref|``) and its ``1e-4`` on the float32 state.
  The kernels' products take bf16 operands with float32 accumulation; x, B
  and C are bf16 already, so their products are exact, and the three
  operands formed in float32 enter as bf16 hi + lo pairs: ``w o x`` in
  ``S_c``, the carried ``h`` in ``C h^T``, and ``W`` in ``W x``. With one
  bf16 rounding of any one of them the result misses its limit (at seed
  9: ``W`` at 5.7x the y limit, ``h`` at 2.3x, ``w o x`` at 23x the limit
  on hT), which ``test_one_bf16_rounding_misses_the_chip_limits`` keeps
  shown.

The kernels themselves run only on the card (``test_torch_gpu.py``).
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.kernel import ssd_scan_pallas  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref  # noqa: E402

from test_torch_ssd import SSD_CASES  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

CHIP_ATOL, CHIP_RTOL = 5e-3, 1e-2   # chip_smoke.py's bf16 limit on y
STATE_TOL = 1e-4                     # and on the float32 state hT


def _same(x):
    return x


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _hilo(x):
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def chunk_parallel(x, dt, A, Bm, Cm, D, chunk=128, pair_wx=_same,
                   pair_h=_same, pair_w=_same):
    """The three passes of the tensor-core kernels in plain PyTorch.
    ``pair_*`` is applied to the operand the kernels form in float32 and
    feed to a product: ``w o x`` in the chunk states, the entering ``h``,
    and ``W`` (``_hilo`` emulates the card's bf16 hi + lo pairs). Returns
    ``(y, hT)`` as ``ssd_chunked_ref`` does."""
    Bn, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, L)
    nc = -(-L // Q)
    xf = x.float()
    Bf = Bm.float().repeat_interleave(H // G, dim=2)
    Cf = Cm.float().repeat_interleave(H // G, dim=2)
    bounds = [(c * Q, min(L, c * Q + Q)) for c in range(nc)]

    # pass 1: per chunk, cs and S_c = sum_j exp(cs_last - cs_j) dt_j x_j B_j^T
    cs, states, totals = [], [], []
    for t0, t1 in bounds:
        c_s = torch.cumsum(dt[:, t0:t1].float() * A.float(), dim=1)
        w = torch.exp(c_s[:, -1:] - c_s) * dt[:, t0:t1].float()
        states.append(torch.einsum("bjhp,bjhn->bhpn",
                                   pair_wx(w[..., None] * xf[:, t0:t1]),
                                   Bf[:, t0:t1]))
        totals.append(c_s[:, -1])
        cs.append(c_s)

    # pass 2: the carry, in float32; the state entering each chunk
    h = torch.zeros(Bn, H, P, N)
    entering = []
    for S_c, tot in zip(states, totals):
        entering.append(h)
        h = h * torch.exp(tot)[..., None, None] + S_c

    # pass 3: y = exp(cs_i) C h^T + W x + D x, W masked before the exp
    y = torch.empty(Bn, L, H, P)
    for (t0, t1), c_s, h_in in zip(bounds, cs, entering):
        Qc = t1 - t0
        csh = c_s.permute(0, 2, 1)                              # (B, H, Qc)
        band = torch.ones(Qc, Qc, dtype=torch.bool).tril()
        decay = torch.exp(torch.where(band, csh[..., :, None]
                                      - csh[..., None, :], -torch.inf))
        W = (torch.einsum("bihn,bjhn->bhij", Cf[:, t0:t1], Bf[:, t0:t1])
             * decay * dt[:, t0:t1].float().permute(0, 2, 1)[:, :, None, :])
        y_off = torch.einsum("bihn,bhpn->bihp", Cf[:, t0:t1], pair_h(h_in))
        y[:, t0:t1] = (y_off * torch.exp(c_s)[..., None]
                       + torch.einsum("bhij,bjhp->bihp", pair_w(W),
                                      xf[:, t0:t1])
                       + xf[:, t0:t1] * D.float()[None, None, :, None])
    return y.to(x.dtype), h


def _inputs(case, seed):
    """float32 inputs of ``case`` (its dtype is ignored), as numpy."""
    B, L, H, P, N, G, Q, _ = case
    rng = np.random.default_rng(seed)
    f = np.float32
    return [rng.normal(size=(B, L, H, P)).astype(f),
            rng.uniform(0.01, 0.2, size=(B, L, H)).astype(f),
            -rng.uniform(0.5, 2, size=(H,)).astype(f),
            rng.normal(size=(B, L, G, N)).astype(f),
            rng.normal(size=(B, L, G, N)).astype(f),
            rng.normal(size=(H,)).astype(f)], Q


@pytest.mark.parametrize("case", SSD_CASES)
def test_chunk_parallel_twin_matches_chunked_ref_and_pallas(case):
    args, Q = _inputs(case, seed=20)
    ta = [torch.from_numpy(a) for a in args]
    y, hT = chunk_parallel(*ta, chunk=Q)
    yr, hr = ssd_chunked_ref(*ta, chunk=Q)
    tol = dict(rtol=1e-4, atol=1e-5)
    assert y.shape == yr.shape and hT.shape == hr.shape
    assert_allclose(y.numpy(), yr.numpy(), **tol)
    assert_allclose(hT.numpy(), hr.numpy(), **tol)
    yj, hj = ssd_scan_pallas(*[jnp.asarray(a) for a in args], chunk=Q,
                             interpret=True)
    assert_allclose(y.numpy(), np.asarray(yj), **tol)
    assert_allclose(hT.numpy(), np.asarray(hj), **tol)


def _prefill_inputs(seed):
    """The mamba2-370m prefill of chip_smoke.py's check_ssd_scan: x (1,
    512, 32, 64), B and C (1, 512, 1, 128) bf16, A = -linspace(1, 16)."""
    B, L, H, P, N = 1, 512, 32, 64, 128
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(torch.bfloat16)
    x, Bm, Cm = bf16(B, L, H, P), bf16(B, L, 1, N), bf16(B, L, 1, N)
    dt = torch.as_tensor(rng.uniform(0.01, 0.2, (B, L, H)),
                         dtype=torch.float32)
    A = -torch.linspace(1.0, 16.0, H)
    D = torch.as_tensor(rng.normal(size=H), dtype=torch.float32)
    return x, dt, A, Bm, Cm, D


@pytest.mark.parametrize("seed", [9, 21])
def test_tensor_core_rounding_within_chip_limits(seed):
    args = _prefill_inputs(seed)
    y, hT = chunk_parallel(*args, chunk=128, pair_wx=_hilo, pair_h=_hilo,
                           pair_w=_hilo)
    assert y.dtype == torch.bfloat16
    f32 = [t.float() for t in args]
    for ref_args in (args, f32):    # the bf16 plain version, float32 copies
        yr, hr = ssd_chunked_ref(*ref_args, chunk=128)
        torch.testing.assert_close(y.float(), yr.float(), atol=CHIP_ATOL,
                                   rtol=CHIP_RTOL)
        torch.testing.assert_close(hT, hr, atol=STATE_TOL, rtol=STATE_TOL)


def _share(got, want, atol, rtol):
    """The worst element's error as a share of its limit."""
    return ((got.float() - want.float()).abs()
            / (atol + rtol * want.float().abs())).max().item()


@pytest.mark.parametrize("single", ["pair_wx", "pair_h", "pair_w"])
def test_one_bf16_rounding_misses_the_chip_limits(single):
    """Why the kernels pair their float32-formed operands: one bf16
    rounding of any one of them, the others paired, takes y or hT past the
    limit chip_smoke.py holds the card to."""
    args = _prefill_inputs(9)
    pairs = dict(pair_wx=_hilo, pair_h=_hilo, pair_w=_hilo)
    pairs[single] = _bf16
    y, hT = chunk_parallel(*args, chunk=128, **pairs)
    yr, hr = ssd_chunked_ref(*[t.float() for t in args], chunk=128)
    worst = max(_share(y, yr, CHIP_ATOL, CHIP_RTOL),
                _share(hT, hr, STATE_TOL, STATE_TOL))
    assert worst > 1, worst
