"""Plain PyTorch twins of the Mamba-2 SSD scan oracles (arXiv:2405.21060).

Line-for-line ports of ``repro/kernels/ssd_scan/ref.py``:

* :func:`ssd_sequential_ref` -- the literal per-step recurrence (the oracle);
* :func:`ssd_chunked_ref` -- the chunked state-space-duality form: a dense
  intra-chunk attention-like term plus a short inter-chunk recurrence. It
  is the port's CPU path and the plain version the CUDA kernel of
  :mod:`repro_torch.kernels.ssd_scan.kernel` is checked against;
* :func:`ssd_decode_step` -- the one-token recurrence of serving;
* :func:`ssd_chunked_bwd_ref` -- the gradient of :func:`ssd_chunked_ref`,
  written out in the decomposition the backward kernels use
  (``csrc/ssd_scan_bwd.cu``). The reference has no counterpart: it
  differentiates ``ssd_chunked_ref`` by autodiff.

Shapes and argument names are the reference's:
  x : (B, L, H, P)    heads x head_dim
  dt: (B, L, H)       positive step sizes (post-softplus)
  A : (H,)            negative decay rates
  Bm: (B, L, G, N)    input projections (G groups; H % G == 0)
  Cm: (B, L, G, N)    output projections
  D : (H,)            skip connection
The math runs in float32 (float64 inputs stay float64, so that the
gradient tests can hold the twins to each other at 1e-10); ``y`` comes back
in x's dtype, the state in the compute dtype.
"""
from __future__ import annotations

import torch


def _compute_dtype(x) -> torch.dtype:
    """float32, or float64 for float64 inputs."""
    return torch.promote_types(x.dtype, torch.float32)


def _expand_groups(Bm, H: int):
    G = Bm.shape[2]
    assert H % G == 0
    return Bm.repeat_interleave(H // G, dim=2)


def ssd_sequential_ref(x, dt, A, Bm, Cm, D, h0=None):
    """The per-step recurrence ``h <- exp(dt A) h + dt x B^T``,
    ``y = C h + D x``. Returns ``(y, hT)``; hT: (B, H, P, N) float32."""
    B_, L, H, P = x.shape
    N = Bm.shape[-1]
    cdt = _compute_dtype(x)
    Bh = _expand_groups(Bm, H).to(cdt)
    Ch = _expand_groups(Cm, H).to(cdt)
    xf = x.to(cdt)
    dtf = dt.to(cdt)
    dA = torch.exp(dtf * A.to(cdt)[None, None, :])             # (B, L, H)
    h = (torch.zeros((B_, H, P, N), dtype=cdt, device=x.device)
         if h0 is None else h0.to(cdt))
    ys = []
    for t in range(L):
        h = h * dA[:, t, :, None, None] + (
            (dtf[:, t, :, None] * xf[:, t])[..., None] * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], h))
    y = torch.stack(ys, dim=1) + xf * D.to(cdt)[None, None, :, None]
    return y.to(x.dtype), h


def _segsum(a):
    """a: (..., Q) -> (..., Q, Q) lower-triangular cumulative sums:
    out[i, j] = sum(a[j+1 .. i]) for i >= j, -inf otherwise."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(Q, device=a.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked_ref(x, dt, A, Bm, Cm, D, h0=None, chunk: int = 128):
    """Chunked SSD over chunks of ``Q = min(chunk, L)`` steps, the tail
    zero-padded (dt = 0 there: padded steps neither decay nor feed the
    state, so ``hT`` is exact). Returns ``(y, hT)``."""
    B_, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        def zf(t):
            shape = (t.shape[0], pad) + tuple(t.shape[2:])
            return torch.cat([t, t.new_zeros(shape)], dim=1)
        x, dt, Bm, Cm = zf(x), zf(dt), zf(Bm), zf(Cm)
    Lp = x.shape[1]
    nc = Lp // Q

    cdt = _compute_dtype(x)
    Bh = _expand_groups(Bm, H).to(cdt)
    Ch = _expand_groups(Cm, H).to(cdt)
    xf = x.to(cdt)
    dtf = dt.to(cdt)
    Af = A.to(cdt)

    # reshape to chunks: (B, nc, Q, ...)
    xc = xf.reshape(B_, nc, Q, H, P)
    dtc = dtf.reshape(B_, nc, Q, H)
    bc = Bh.reshape(B_, nc, Q, H, N)
    cc = Ch.reshape(B_, nc, Q, H, N)
    da_log = dtc * Af[None, None, None, :]                     # (B, nc, Q, H)

    # intra-chunk ("diagonal block") attention-like term
    seg = _segsum(da_log.permute(0, 1, 3, 2))                  # (B, nc, H, Q, Q)
    Lmat = torch.exp(seg)
    scores = torch.einsum("bcqhn,bckhn->bchqk", cc, bc) * Lmat
    y_diag = torch.einsum("bchqk,bckh,bckhp->bcqhp", scores, dtc, xc)

    # per-chunk end states: S_c = sum_j decay(Q-1 -> j) dt_j B_j x_j
    total = da_log.sum(dim=2)                                  # (B, nc, H)
    dec_to_end = torch.exp(da_log.sum(dim=2, keepdim=True)
                           - torch.cumsum(da_log, dim=2))      # (B, nc, Q, H)
    S = torch.einsum("bcqh,bcqh,bcqhn,bcqhp->bchpn",
                     dec_to_end, dtc, bc, xc)                  # (B, nc, H, P, N)

    # inter-chunk recurrence over nc chunks; keep the state BEFORE each chunk
    h = (torch.zeros((B_, H, P, N), dtype=cdt, device=x.device)
         if h0 is None else h0.to(cdt))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * torch.exp(total[:, c])[..., None, None] + S[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                       # (B, nc, H, P, N)

    # off-diagonal: contribution of the carried state to every position
    dec_from_start = torch.exp(torch.cumsum(da_log, dim=2))    # (B, nc, Q, H)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", cc, h_prev,
                         dec_from_start)

    y = (y_diag + y_off).reshape(B_, Lp, H, P)[:, :L]
    y = y + xf[:, :L] * D.to(cdt)[None, None, :, None]
    return y.to(x.dtype), h


def ssd_decode_step(x, dt, A, Bm, Cm, D, h):
    """Single-token recurrence for serving. x: (B, H, P); dt: (B, H);
    Bm, Cm: (B, G, N); h: (B, H, P, N) -> (y, h_next)."""
    H = x.shape[1]
    Bh = _expand_groups(Bm[:, None], H)[:, 0].float()
    Ch = _expand_groups(Cm[:, None], H)[:, 0].float()
    xf, dtf = x.float(), dt.float()
    dA = torch.exp(dtf * A.float()[None, :])
    h = h * dA[..., None, None] + (dtf[..., None] * xf)[..., None] \
        * Bh[:, :, None, :]
    y = torch.einsum("bhn,bhpn->bhp", Ch, h) + xf * D.float()[None, :, None]
    return y.to(x.dtype), h


def ssd_chunked_bwd_ref(x, dt, A, Bm, Cm, D, dy, dhT=None, chunk: int = 128):
    """The gradient of :func:`ssd_chunked_ref`'s ``(y, hT)`` (``h0`` None)
    with respect to ``(x, dt, A, Bm, Cm, D)``, given ``dy`` (B, L, H, P)
    and ``dhT`` (B, H, P, N; None is zero). Returns ``(dx, ddt, dA, dBm,
    dCm, dD)`` in the inputs' dtypes, computed in float32.

    Written out, not through autograd, in the order the backward kernels
    run it. Per (b, h) and chunk c of Q steps, with a = dt A, cs its
    inclusive cumsum in the chunk, T_c = cs_{Q-1}, w_j = exp(T_c - cs_j)
    dt_j:

    1. the chunk states: S_c = sum_j w_j x_j B_j^T and the state entering
       each chunk, h_c (h_0 = 0, h_{c+1} = exp(T_c) h_c + S_c);
    2. the reverse carry: g_c, the gradient of the state leaving chunk c,
       g_{nc-1} = dhT, g_{c-1} = exp(T_c) g_c + sum_i exp(cs_i) dy_i C_i^T;
    3. chunk-parallel gradients: the intra-chunk Q x Q term (scores M =
       C B^T, W = M o exp(cs_i - cs_j) o dt_j on j <= i, dW = dy x^T), the
       carried state h_c into y, and the chunk's S_c into g_c; the
       gradient of cs turned into that of a by a reverse cumsum in the
       chunk (T_c = cs_{Q-1} adds to every step), then ddt += A da and
       dA = sum dt da. The G groups of B and C sum their heads'
       gradients."""
    B_, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    cdt = _compute_dtype(x)
    Q = min(chunk, L)
    pad = (-L) % Q

    def padded(t):
        t = t.to(cdt)
        if not pad:
            return t
        return torch.cat([t, t.new_zeros((t.shape[0], pad)
                                         + tuple(t.shape[2:]))], dim=1)
    xf, dtf, Bf, Cf, dyf = (padded(t) for t in (x, dt, Bm, Cm, dy))
    Af, Df = A.to(cdt), D.to(cdt)
    nc = xf.shape[1] // Q
    xc = xf.reshape(B_, nc, Q, H, P)
    dyc = dyf.reshape(B_, nc, Q, H, P)
    dtc = dtf.reshape(B_, nc, Q, H)
    bc = _expand_groups(Bf, H).reshape(B_, nc, Q, H, N)
    cc = _expand_groups(Cf, H).reshape(B_, nc, Q, H, N)
    cs = torch.cumsum(dtc * Af, dim=2)                         # (B, nc, Q, H)
    T = cs[:, :, -1]                                           # (B, nc, H)
    w = torch.exp(T[:, :, None] - cs) * dtc
    ecs = torch.exp(cs)

    # 1. the chunk states and the state entering each chunk
    S = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", w, bc, xc)
    h = torch.zeros((B_, H, P, N), dtype=cdt, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(T[:, c])[..., None, None] + S[:, c]
    h_prev = torch.stack(h_prev, dim=1)                        # (B, nc, H, P, N)

    # 2. the reverse carry: g_next[c] is the gradient of chunk c's end state
    U = torch.einsum("bcqh,bcqhp,bcqhn->bchpn", ecs, dyc, cc)
    g = (torch.zeros((B_, H, P, N), dtype=cdt, device=x.device)
         if dhT is None else dhT.to(cdt))
    g_next = [None] * nc
    for c in reversed(range(nc)):
        g_next[c] = g
        g = g * torch.exp(T[:, c])[..., None, None] + U[:, c]
    g_next = torch.stack(g_next, dim=1)                        # (B, nc, H, P, N)

    # 3a. the intra-chunk term: rows i, columns j <= i, (B, nc, H, Q, Q)
    csq = cs.permute(0, 1, 3, 2)
    i = torch.arange(Q, device=x.device)
    lower = i[:, None] >= i[None, :]
    E = torch.exp(torch.where(lower, csq[..., :, None] - csq[..., None, :],
                              float("-inf")))
    dt_j = dtc.permute(0, 1, 3, 2)[..., None, :]
    M = torch.einsum("bcihn,bcjhn->bchij", cc, bc)
    dW = torch.einsum("bcihp,bcjhp->bchij", dyc, xc)
    W = M * E * dt_j
    dM = dW * E * dt_j
    R = dW * W                        # the gradient of cs_i - cs_j
    dx = torch.einsum("bchij,bcihp->bcjhp", W, dyc)
    dB = torch.einsum("bchij,bcihn->bcjhn", dM, cc)
    dC = torch.einsum("bchij,bcjhn->bcihn", dM, bc)
    ddt = torch.einsum("bchij->bcjh", dW * M * E)
    dcs = (R.sum(-1) - R.sum(-2)).permute(0, 1, 3, 2)          # (B, nc, Q, H)

    # 3b. the carried state into y, and S_c into the next chunk's state
    dC = dC + ecs[..., None] * torch.einsum("bcqhp,bchpn->bcqhn", dyc,
                                            h_prev)
    dcs = dcs + ecs * torch.einsum("bcqhp,bchpn,bcqhn->bcqh", dyc, h_prev,
                                   cc)
    gB = torch.einsum("bchpn,bcqhn->bcqhp", g_next, bc)        # g_next B_j
    dx = dx + w[..., None] * gB
    dB = dB + w[..., None] * torch.einsum("bcqhp,bchpn->bcqhn", xc, g_next)
    dw = (xc * gB).sum(-1)                                     # (B, nc, Q, H)
    ddt = ddt + torch.exp(T[:, :, None] - cs) * dw
    dcs = dcs - w * dw
    dT = (torch.exp(T) * (g_next * h_prev).sum((-1, -2))
          + (w * dw).sum(2))                                   # (B, nc, H)

    # 3c. cs_i = sum_{k <= i} a_k and T = cs_{Q-1}: a reverse cumsum
    da = torch.flip(torch.cumsum(torch.flip(dcs, [2]), 2), [2]) \
        + dT[:, :, None]
    ddt = ddt + Af * da
    dA = (da * dtc).sum((0, 1, 2))
    dx = dx + Df[:, None] * dyc
    dD = (dyc * xc).sum((0, 1, 2, 4))

    def steps(t):
        return t.reshape((B_, nc * Q) + tuple(t.shape[3:]))[:, :L]

    def groups(t):
        return steps(t).reshape(B_, L, G, H // G, N).sum(3)
    return (steps(dx).to(x.dtype), steps(ddt).to(dt.dtype), dA.to(A.dtype),
            groups(dB).to(Bm.dtype), groups(dC).to(Cm.dtype), dD.to(D.dtype))
