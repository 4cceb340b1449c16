"""AdamW in PyTorch, float32 (port of ``repro/optim/adamw.py``).

The reference's pytrees become ordered dicts of tensors keyed by the
model's ``state_dict`` names. Callers pass them in the reference tree's
leaf order (:func:`repro_torch.models.convert.jax_leaves`), so the global
norm sums its per-tensor terms in the reference's order. The per-stage
entry points (:func:`sqnorm_partials` ... :func:`scale_grad`) are what the
graph pipeline's optimizer actors and its monolithic engine share.

:func:`adamw_math` is the one AdamW recurrence: the same op sequence as the
reference's, out of place, so every update path here runs it. The update
functions write the results back into the params and moments in place (a
2B-parameter model holds 24 GB of them in float32; a functional copy of
each would double that).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, NamedTuple, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor                 # int32 scalar
    mu: Dict[str, torch.Tensor]        # first moment, float32, like params
    nu: Dict[str, torch.Tensor]        # second moment


def init_adamw(params: Dict[str, torch.Tensor]) -> AdamWState:
    """Zero moments (float32) beside each param, step 0."""
    dev = next(iter(params.values())).device
    zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                     for n, p in params.items()}
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      zeros(), zeros())


def global_norm(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed in the
    order given."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        pre_norm=None) -> Tuple[Dict[str, torch.Tensor],
                                                torch.Tensor]:
    norm = global_norm(grads.values()) if pre_norm is None else pre_norm
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return {n: g * scale for n, g in grads.items()}, norm


# ---------------------------------------------------------------------------
# Per-stage entry points for the pipeline optimizer actors (paper §3.3/§4.3).
# ---------------------------------------------------------------------------

def sqnorm_partials(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One float32 squared-norm scalar per gradient tensor -- a pipeline
    stage's partial-value (P) contribution to the global gradient norm."""
    return {n: g.float().square().sum() for n, g in grads.items()}


def sqnorm_partials_sharded(grads: Dict[str, Sequence[torch.Tensor]],
                            distinct: Dict[str, Sequence[int]]
                            ) -> Dict[str, torch.Tensor]:
    """The squared norm of each sharded gradient: its per-rank shards
    (``grads[n][r]``) summed over ``distinct[n]``, the ranks holding
    distinct shards, in that order -- a broadcast replica counted once, not
    once per rank. With one shard it is :func:`sqnorm_partials`' term."""
    out = {}
    for n, shards in grads.items():
        terms = [shards[r].float().square().sum() for r in distinct[n]]
        total = terms[0]
        for t in terms[1:]:
            total = total + t.to(total.device)
        out[n] = total
    return out


def global_norm_from_partials(partials: Dict[str, torch.Tensor],
                              order: Sequence[str]) -> np.float32:
    """The P->B combine: sum the per-tensor partials in the canonical
    ``order`` and take the square root, on the host in numpy float32.
    Float addition is not associative, so one fixed order is what lets the
    pipelined norm match the monolithic one bit for bit."""
    total = np.float32(0.0)
    for n in order:
        if n in partials:
            total = np.float32(total + np.float32(float(partials[n])))
    return np.float32(np.sqrt(total))


def clip_scale(norm, max_norm: float) -> np.float32:
    """Gradient scale factor for global-norm clipping: ``min(1, c/norm)``;
    1.0 when ``max_norm`` is falsy (clipping off)."""
    if not max_norm:
        return np.float32(1.0)
    return np.float32(min(1.0, float(max_norm) / max(float(norm), 1e-12)))


def scale_grad(g: torch.Tensor, scale) -> torch.Tensor:
    """Apply the broadcast clip factor to one gradient tensor (float32)."""
    return g.float() * float(scale)


def adamw_math(p32, g32, m, v, step, lr, beta1, beta2, eps, weight_decay):
    """The AdamW recurrence, float32 in and out; ``step`` is the new
    (1-based) step count as a tensor. Returns ``(new_p32, new_m, new_v)``."""
    step = step.float()
    bc1 = 1.0 - beta1 ** step
    bc2 = 1.0 - beta2 ** step
    m = beta1 * m + (1 - beta1) * g32
    v = beta2 * v + (1 - beta2) * g32 * g32
    new_p = p32 - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                        + weight_decay * p32)
    return new_p, m, v


#: elements one AdamW update takes at a time. :func:`adamw_math` holds
#: several float32 temporaries of its input's size at once: deepseek-v3's
#: embedding (927 M elements, 3.45 GiB in float32) ran its one-layer ZeRO
#: step out of an 80 GB card's memory; a chunk's are 256 MiB each
UPDATE_CHUNK = 1 << 26


@torch.no_grad()
def adamw_param_update(p, g, m, v, step, lr, *, beta1: float = 0.9,
                       beta2: float = 0.95, eps: float = 1e-8,
                       weight_decay: float = 0.1) -> None:
    """One tensor's AdamW update, in place: ``g`` is the already-clipped
    gradient, ``step`` the new step count, ``lr`` the resolved learning
    rate. All math in float32; ``p`` keeps its dtype. A tensor of more
    than :data:`UPDATE_CHUNK` elements is updated a chunk of its flat
    elements at a time: the recurrence is elementwise, so the chunks give
    the whole tensor's values bit for bit."""
    ts = (p, g, m, v)
    n = p.numel()
    if n <= UPDATE_CHUNK or not all(t.numel() == n and t.is_contiguous()
                                    for t in ts):
        chunks = [ts]
    else:
        flat = [t.view(-1) for t in ts]
        chunks = [[t[i:i + UPDATE_CHUNK] for t in flat]
                  for i in range(0, n, UPDATE_CHUNK)]
    for p_, g_, m_, v_ in chunks:
        new_p, new_m, new_v = adamw_math(p_.float(), g_.float(), m_, v_,
                                         step, lr, beta1, beta2, eps,
                                         weight_decay)
        p_.copy_(new_p)
        m_.copy_(new_m)
        v_.copy_(new_v)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: AdamWState,
                 lr_scale: float = 1.0) -> Tuple[AdamWState, torch.Tensor]:
    """One AdamW step over every param, in place, in the order of
    ``params``. Returns the new state and the pre-clip global norm.

    The clip factor is applied one tensor at a time, as each is updated, so
    no second copy of the gradients is held (8 GB at 2B params)."""
    grads = {n: g.float() for n, g in grads.items()}
    norm = global_norm(grads.values())
    scale = (torch.clamp(cfg.grad_clip / torch.clamp_min(norm, 1e-12),
                         max=1.0) if cfg.grad_clip else 1.0)
    step = state.step + 1
    for n, p in params.items():
        adamw_param_update(p, grads[n] * scale, state.mu[n], state.nu[n], step,
                           cfg.lr * lr_scale, beta1=cfg.beta1,
                           beta2=cfg.beta2, eps=cfg.eps,
                           weight_decay=cfg.weight_decay)
    return AdamWState(step, state.mu, state.nu), norm
