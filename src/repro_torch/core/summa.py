"""2-D SUMMA matmul via multi-dimensional SBP (paper §3.3, Table 3), port
of ``repro/core/summa.py``.

Table 3 row 1:  X:(S(0), B) × W:(B, S(1)) → Y:(S(0), S(1))
Table 3 row 2:  X:(S(0), S(1)) × W:(B, S(0)) → Y:(S(0), P)

:func:`summa_matmul` is the classic 2-D algorithm on a (rows, cols) mesh,
run on every rank inside :func:`repro_torch.core.mesh.spmd`: each step
broadcasts one K-panel of X along the columns and one of W along the rows
and accumulates the local products. Each panel broadcast is a masked psum
(the ``B``-transition on one mesh axis), as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core import mesh as M


def summa_matmul(x_local, w_local, *, row_axis: str, col_axis: str,
                 n_row: int, n_col: int):
    """2-D SUMMA inside spmd.

    x_local: (M/r, K/c) -- X sharded (S(0) over rows, S(1) over cols);
    w_local: (K/r, N/c) -- W sharded (S(0) over rows, S(1) over cols).
    Returns Y (M/r, N/c) sharded (S(0), S(1)).
    """
    if n_col != n_row:
        raise ValueError("summa_matmul needs K split equally on both axes "
                         f"(n_row={n_row}, n_col={n_col})")
    acc = torch.zeros((x_local.shape[0], w_local.shape[1]),
                      dtype=torch.promote_types(x_local.dtype, w_local.dtype),
                      device=x_local.device)

    def bcast(v, axis, src):
        # collective broadcast as a masked psum, as the reference
        keep = v if M.axis_index(axis) == src else torch.zeros_like(v)
        return M.psum(keep, axis)

    for p in range(n_col):
        xp = bcast(x_local, col_axis, p)   # panel p of X: S(1) -> B
        wp = bcast(w_local, row_axis, p)   # panel p of W: S(0) -> B
        acc = acc + xp @ wp
    return acc
