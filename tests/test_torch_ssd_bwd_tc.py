"""The tensor-core form of the SSD scan's backward, on the CPU.

``csrc/ssd_scan_bwd.cu`` runs a bf16 backward through four kernels: per
chunk the chunk's own state ``S_c`` and the reverse carry's input ``U_c``
(the state pass), the forward and reverse carries over the chunks, per chunk
every gradient at once from the chunk's tiles and its two carried states
(the chunk pass), and the sum of dB and dC over each group's heads with
the dA and dD partials (the reduce). This file holds a plain PyTorch twin
of that decomposition, pass by pass, and checks it here before any card
runs:

* with no rounding, in float64, against ``ssd_chunked_bwd_ref`` and
  autograd through ``ssd_chunked_ref`` over ``test_torch_ssd_bwd.py``'s
  ``CASES`` within 1e-10 relative in norm, and in float32 against
  ``jax.vjp`` of the JAX package's ``ssd_chunked_ref`` within 1e-5 (that
  file's limits);
* with the kernels' bf16 operand rounding emulated, at a cut of mamba2's
  training layer (one batch row, 8 of its 32 heads, L 2048, P 64, N 128,
  chunk 128), against ``ssd_chunked_bwd_ref`` on the same inputs within
  ``chip_smoke.py``'s limits: 1e-2 relative in norm for the bf16 outputs
  dx, dB and dC, 1e-4 for the float32 ones ddt, dA and dD.

The kernels' products take bf16 operands with float32 accumulation. x, dy,
B and C are bf16 already, so ``M = C B^T``, ``dW = dy x^T`` and every
product of two of them is exact in the accumulators; the row scales
``exp(cs_i)`` and ``w_j`` go onto the accumulators, not the operands. The
operands formed in float32, and how each enters:

* ``w o x`` and ``exp(cs) o dy`` in ``S_c`` and ``U_c`` (the state pass):
  bf16 hi + lo pairs, two products each;
* the carried states ``h`` in ``dy h`` and ``g`` in ``x g`` (the chunk
  pass): hi + lo pairs. Those products feed ddt and dA as well as dC and
  dB (``dcs`` through ``exp(cs_i) dy_i h C_i``, ``dw_j = (x g)_j . B_j``);
* ``g`` in ``B g^T`` (dx only), ``dM`` in ``dM B`` and ``dM^T C``, ``W``
  in ``W^T dy``: one bf16 rounding each. These feed only the bf16 outputs,
  where one rounding stays far inside the 1e-2 limit
  (``test_tensor_core_rounding_within_chip_limits``), so the kernel drops
  their lo products, and one staged bf16 copy of the Q x Q matrix (dM,
  then W) serves both a product and its transpose.

``test_one_bf16_rounding_misses_the_chip_limits`` keeps shown, for each
pair the kernel keeps, that one bf16 rounding of that operand alone takes
ddt or dA past its limit (at seed 9 or 21: ``w o x`` up to 10x, ``e o
dy`` 2.0x, ``h`` 3.4x, ``g`` 4.4x). The kernels themselves run only on the card
(``test_torch_gpu.py``).
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked_ref as jax_chunked)
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked_bwd_ref, ssd_chunked_ref)

from test_torch_ssd_bwd import CASES, IDS, NAMES, _inputs, _rel  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

BF16_LIMIT, F32_LIMIT = 1e-2, 1e-4   # chip_smoke.py's SSD_BWD_RTOL_*
#: the operands the kernels form in float32, and the rounding each gets
PAIRS = ("wx", "edy", "h", "g")       # hi + lo pairs
SINGLES = ("gB", "dM", "W")           # one bf16 rounding


def _same(t):
    return t


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _hilo(t):
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _revcumsum(t, dim):
    return torch.flip(torch.cumsum(torch.flip(t, [dim]), dim), [dim])


def tc_backward(x, dt, A, Bm, Cm, D, dy, dhT=None, chunk=128, rnd=None):
    """The four passes of the tensor-core backward in plain PyTorch.
    ``rnd`` maps an operand's name (``PAIRS`` and ``SINGLES``) to the
    rounding it gets before its product (``_hilo``, ``_bf16``; missing
    names: none). Returns ``(dx, ddt, dA, dBm, dCm, dD)`` in the inputs'
    dtypes, as ``ssd_chunked_bwd_ref`` does."""
    rnd = dict.fromkeys(PAIRS + SINGLES, _same) | (rnd or {})
    Bn, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    cdt = torch.promote_types(x.dtype, torch.float32)
    Q = min(chunk, L)
    xf, dyf, dtf = x.to(cdt), dy.to(cdt), dt.to(cdt)
    Bf = Bm.to(cdt).repeat_interleave(H // G, dim=2)
    Cf = Cm.to(cdt).repeat_interleave(H // G, dim=2)
    Af, Df = A.to(cdt), D.to(cdt)
    bounds = [(t0, min(L, t0 + Q)) for t0 in range(0, L, Q)]

    # the state pass: per chunk cs, T, S_c = (w o x)^T B, U_c = (e o dy)^T C
    cs, S, U, T = [], [], [], []
    for t0, t1 in bounds:
        c_s = torch.cumsum(dtf[:, t0:t1] * Af, dim=1)          # (B, Qc, H)
        w = torch.exp(c_s[:, -1:] - c_s) * dtf[:, t0:t1]
        e = torch.exp(c_s)
        S.append(torch.einsum("bjhp,bjhn->bhpn",
                              rnd["wx"](w[..., None] * xf[:, t0:t1]),
                              Bf[:, t0:t1]))
        U.append(torch.einsum("bihp,bihn->bhpn",
                              rnd["edy"](e[..., None] * dyf[:, t0:t1]),
                              Cf[:, t0:t1]))
        cs.append(c_s)
        T.append(c_s[:, -1])

    # the carry: the state entering each chunk, the gradient leaving it
    h = torch.zeros(Bn, H, P, N, dtype=cdt)
    hs = []
    for S_c, T_c in zip(S, T):
        hs.append(h)
        h = h * torch.exp(T_c)[..., None, None] + S_c
    g = torch.zeros(Bn, H, P, N, dtype=cdt) if dhT is None else dhT.to(cdt)
    gs = [None] * len(bounds)
    for c in reversed(range(len(bounds))):
        gs[c] = g
        g = g * torch.exp(T[c])[..., None, None] + U[c]

    # the chunk pass: every gradient of the chunk from its tiles, h_c, g_c
    dx = torch.empty(Bn, L, H, P, dtype=cdt)
    ddt = torch.empty(Bn, L, H, dtype=cdt)
    dBh = torch.empty(Bn, L, H, N, dtype=cdt)
    dCh = torch.empty(Bn, L, H, N, dtype=cdt)
    partA, partD = [], []
    for (t0, t1), c_s, T_c, h_c, g_c in zip(bounds, cs, T, hs, gs):
        Qc = t1 - t0
        xc, dyc = xf[:, t0:t1], dyf[:, t0:t1]                  # (B, Qc, H, P)
        bc, cc = Bf[:, t0:t1], Cf[:, t0:t1]                    # (B, Qc, H, N)
        dtc = dtf[:, t0:t1]
        w = torch.exp(T_c[:, None] - c_s) * dtc                # (B, Qc, H)
        e = torch.exp(c_s)
        csh = c_s.permute(0, 2, 1)                             # (B, H, Qc)
        band = torch.ones(Qc, Qc, dtype=torch.bool).tril()
        E = torch.exp(torch.where(band, csh[..., :, None] - csh[..., None, :],
                                  -torch.inf))                 # masked first
        f = E * dtc.permute(0, 2, 1)[:, :, None, :]
        M = torch.einsum("bihn,bjhn->bhij", cc, bc)
        dW = torch.einsum("bihp,bjhp->bhij", dyc, xc)
        W, dM = M * f, dW * f
        R = dW * W
        rowR, colR = R.sum(-1), R.sum(-2)                      # (B, H, Qc)
        colD = (dW * M * E).sum(-2)

        # dC_i = e_i (dy h)_i + sum_j dM_ij B_j; dcs from its first term
        dC = e[..., None] * torch.einsum("bihp,bhpn->bihn", dyc,
                                         rnd["h"](h_c))
        dcs_h = (dC * cc).sum(-1)                              # (B, Qc, H)
        dC = dC + torch.einsum("bhij,bjhn->bihn", rnd["dM"](dM), bc)
        # dB_j = w_j (x g)_j + sum_i dM_ij C_i; dw_j = (x g)_j . B_j
        xg = torch.einsum("bjhp,bhpn->bjhn", xc, rnd["g"](g_c))
        dw = (xg * bc).sum(-1)
        dB = w[..., None] * xg + torch.einsum("bhij,bihn->bjhn",
                                              rnd["dM"](dM), cc)
        # dx_j = w_j (B g^T)_j + sum_i W_ij dy_i + D dy_j
        dxc = (w[..., None] * torch.einsum("bjhn,bhpn->bjhp", bc,
                                           rnd["gB"](g_c))
               + torch.einsum("bhij,bihp->bjhp", rnd["W"](W), dyc)
               + Df[:, None] * dyc)

        dcs = (rowR - colR).permute(0, 2, 1) + dcs_h - w * dw  # (B, Qc, H)
        dT = (torch.exp(T_c) * (g_c * h_c).sum((-1, -2))
              + (w * dw).sum(1))                               # (B, H)
        da = _revcumsum(dcs, 1) + dT[:, None]
        ddt[:, t0:t1] = (colD.permute(0, 2, 1)
                         + torch.exp(T_c[:, None] - c_s) * dw + Af * da)
        dx[:, t0:t1], dBh[:, t0:t1], dCh[:, t0:t1] = dxc, dB, dC
        partA.append((dtc * da).sum(1))                        # (B, H)
        partD.append((dyc * xc).sum((1, 3)))

    # the reduce: dB, dC over each group's heads; dA, dD over the partials
    dBm = dBh.reshape(Bn, L, G, H // G, N).sum(3)
    dCm = dCh.reshape(Bn, L, G, H // G, N).sum(3)
    dA = torch.stack(partA).sum((0, 1))
    dDv = torch.stack(partD).sum((0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dBm.to(Bm.dtype), dCm.to(Cm.dtype), dDv.to(D.dtype))


def _check(got, want, limit):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        err = _rel(g.float() if g.dtype == torch.bfloat16 else g,
                   w.float() if w.dtype == torch.bfloat16 else w)
        assert err <= limit, f"d{name}: {err:.3e} relative (limit {limit})"


@pytest.mark.parametrize("with_dhT", [True, False], ids=["dhT", "no_dhT"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_twin_matches_plain_backward_and_autograd_in_float64(case,
                                                             with_dhT):
    *ins, dy, dhT = (torch.from_numpy(a) for a in _inputs(case, seed=1))
    if not with_dhT:
        dhT = None
    Q = case[-1]
    got = tc_backward(*ins, dy, dhT, chunk=Q)
    assert [g.dtype for g in got] == [torch.float64] * 6
    _check(got, ssd_chunked_bwd_ref(*ins, dy, dhT, chunk=Q), 1e-10)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    y, hT = ssd_chunked_ref(*leaves, chunk=Q)
    loss = (y * dy).sum() + ((hT * dhT).sum() if with_dhT else 0.0)
    _check(got, torch.autograd.grad(loss, leaves), 1e-10)


@functools.lru_cache(maxsize=None)
def _jax_vjp(chunk: int):
    return jax.jit(lambda ins, ct: jax.vjp(
        lambda *a: jax_chunked(*a, chunk=chunk), *ins)[1](ct))


@pytest.mark.parametrize("with_dhT", [True, False], ids=["dhT", "no_dhT"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_twin_matches_jax_vjp_in_float32(case, with_dhT):
    *ins, dy, dhT = _inputs(case, seed=2, dtype=np.float32)
    Q = case[-1]
    want = _jax_vjp(Q)(ins, (dy, dhT if with_dhT else np.zeros_like(dhT)))
    got = tc_backward(*(torch.from_numpy(a) for a in ins),
                      torch.from_numpy(dy),
                      torch.from_numpy(dhT) if with_dhT else None, chunk=Q)
    assert [g.dtype for g in got] == [torch.float32] * 6
    _check(got, [torch.from_numpy(np.array(w)) for w in want], 1e-5)


def _training_cut(seed):
    """A cut of chip_smoke.py's check_ssd_scan_bwd at mamba2-370m's
    training layer: one batch row of x (2048, 64) and 8 of the 32 heads
    (A = -linspace(1, 16, 32), every fourth), B and C (2048, 1, 128), dy,
    all bf16, dt and D float32, dhT None as in training."""
    B, L, H, P, N = 1, 2048, 8, 64, 128
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(torch.bfloat16)
    x, Bm, Cm = bf16(B, L, H, P), bf16(B, L, 1, N), bf16(B, L, 1, N)
    dt = torch.as_tensor(rng.uniform(0.01, 0.2, (B, L, H)),
                         dtype=torch.float32)
    A = -torch.linspace(1.0, 16.0, 32)[::4].contiguous()
    D = torch.as_tensor(rng.normal(size=H), dtype=torch.float32)
    return (x, dt, A, Bm, Cm, D), bf16(B, L, H, P)


KERNEL = dict.fromkeys(PAIRS, _hilo) | dict.fromkeys(SINGLES, _bf16)


def _shares(got, want):
    """Each gradient's relative error in norm as a share of its limit."""
    return {name: _rel(g.float(), w.float())
            / (BF16_LIMIT if g.dtype == torch.bfloat16 else F32_LIMIT)
            for name, g, w in zip(NAMES, got, want)}


@functools.lru_cache(maxsize=None)
def _cut_and_want(seed):
    args, dy = _training_cut(seed)
    return args, dy, ssd_chunked_bwd_ref(*args, dy, chunk=128)


@pytest.mark.parametrize("seed", [9, 21])
def test_tensor_core_rounding_within_chip_limits(seed):
    args, dy, want = _cut_and_want(seed)
    got = tc_backward(*args, dy, chunk=128, rnd=KERNEL)
    assert [g.dtype for g in got] == [a.dtype for a in args]
    shares = _shares(got, want)
    assert max(shares.values()) <= 1, shares


@pytest.mark.parametrize("single", PAIRS)
def test_one_bf16_rounding_misses_the_chip_limits(single):
    """Why the kernels keep each of their hi + lo pairs: one bf16 rounding
    of that operand alone, everything else as the kernels round it, takes
    a float32 gradient (ddt or dA) past the limit chip_smoke.py holds the
    card to on one of the two seeds of
    ``test_tensor_core_rounding_within_chip_limits`` (``h`` misses at seed
    21 only, by 3.4x on dA; at seed 9 it reaches 0.91 of ddt's limit)."""
    worst = {}
    for seed in (9, 21):
        args, dy, want = _cut_and_want(seed)
        got = tc_backward(*args, dy, chunk=128,
                          rnd=KERNEL | {single: _bf16})
        worst[seed] = max(_shares(got, want).values())
    assert max(worst.values()) > 1, worst


def test_backward_routes_by_dtype():
    """The wrapper's dispatch: bf16 runs the tensor-core route where the
    chunk pass's tiles fit (P <= 64, or P <= 128 with N <= 64), float32 and
    bf16 past those tiles the five CUDA-core kernels; the two share only
    the carry and the reduce, and the tensor-core route's scratch at
    mamba2's training layer is 201 MB (the CUDA-core layout's 236 MB)."""
    from repro_torch.kernels.ssd_scan import kernel as ssd
    bf16, f32 = torch.bfloat16, torch.float32
    for P, N in ((64, 128), (40, 128), (21, 36), (128, 64), (128, 32)):
        assert ssd.bwd_kernels(bf16, P, N) == ssd.BWD_TC_KERNELS
        assert ssd.bwd_kernels(f32, P, N) == ssd.BWD_KERNELS
    for P, N in ((128, 128), (96, 65), (256, 16)):
        assert ssd.bwd_kernels(bf16, P, N) == ssd.BWD_KERNELS
    assert set(ssd.BWD_TC_KERNELS) & set(ssd.BWD_KERNELS) == {
        "ssd_bwd_carry_kernel", "ssd_bwd_reduce_kernel"}
    shape = (2, 2048, 32, 64, 128, 128)
    assert 4 * ssd.bwd_scratch_floats(*shape, tc=True) == 201_338_880
    assert 4 * ssd.bwd_scratch_floats(*shape, tc=False) == 235_945_984
