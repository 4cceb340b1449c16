"""Plain PyTorch twins of the Mamba-2 SSD scan oracles (arXiv:2405.21060).

Line-for-line ports of ``repro/kernels/ssd_scan/ref.py``:

* :func:`ssd_sequential_ref` -- the literal per-step recurrence (the oracle);
* :func:`ssd_chunked_ref` -- the chunked state-space-duality form: a dense
  intra-chunk attention-like term plus a short inter-chunk recurrence. It
  is the port's CPU path and the plain version the CUDA kernel of
  :mod:`repro_torch.kernels.ssd_scan.kernel` is checked against;
* :func:`ssd_decode_step` -- the one-token recurrence of serving.

Shapes and argument names are the reference's:
  x : (B, L, H, P)    heads x head_dim
  dt: (B, L, H)       positive step sizes (post-softplus)
  A : (H,)            negative decay rates
  Bm: (B, L, G, N)    input projections (G groups; H % G == 0)
  Cm: (B, L, G, N)    output projections
  D : (H,)            skip connection
The math runs in float32; ``y`` comes back in x's dtype, the state in
float32.
"""
from __future__ import annotations

import torch


def _expand_groups(Bm, H: int):
    G = Bm.shape[2]
    assert H % G == 0
    return Bm.repeat_interleave(H // G, dim=2)


def ssd_sequential_ref(x, dt, A, Bm, Cm, D, h0=None):
    """The per-step recurrence ``h <- exp(dt A) h + dt x B^T``,
    ``y = C h + D x``. Returns ``(y, hT)``; hT: (B, H, P, N) float32."""
    B_, L, H, P = x.shape
    N = Bm.shape[-1]
    Bh = _expand_groups(Bm, H).float()
    Ch = _expand_groups(Cm, H).float()
    xf = x.float()
    dtf = dt.float()
    dA = torch.exp(dtf * A.float()[None, None, :])             # (B, L, H)
    h = (torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(L):
        h = h * dA[:, t, :, None, None] + (
            (dtf[:, t, :, None] * xf[:, t])[..., None] * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], h))
    y = torch.stack(ys, dim=1) + xf * D.float()[None, None, :, None]
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

    Bh = _expand_groups(Bm, H).float()
    Ch = _expand_groups(Cm, H).float()
    xf = x.float()
    dtf = dt.float()
    Af = A.float()

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
    h = (torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
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
    y = y + xf[:, :L] * D.float()[None, None, :, None]
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
