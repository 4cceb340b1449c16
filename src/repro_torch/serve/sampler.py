"""Temperature/top-k/top-p sampling as an actor-borne RNG register stream.

Port of ``repro/serve/sampler.py``. The sampler state is ONE
``torch.Generator`` on the last stage's device, carried by the actor that
owns the decode head (the last stage actor under ``backend="actors"``, the
inline engine under ``backend="monolithic"``), seeded from
``SamplingSpec.seed``. Every work item that produces tokens (a prefill, a
decode round, the *final* chunk of a chunked prefill) draws from it exactly
once: a ``(rows, padded_vocab)`` block of uniforms, one row per slot, turned
into Gumbel noise for a Gumbel-max draw (``argmax(z + g)`` samples
``softmax(z)``). Philox draws are deterministic for a fixed generator on the
card and on the CPU, and every backend drives the same items through the
last stage in the same order, so a fixed seed gives the same tokens on the
actors and on the monolithic engine.

The port cannot reproduce ``jax.random``'s streams: a sampled stream is held
to its own reproducibility and to the reference's filter rule, not to the
JAX package's tokens. ``temperature == 0`` delegates to
:func:`greedy_from_logits` and is bitwise the default
(no-sampler) path.
"""
from __future__ import annotations

import dataclasses

import torch


def greedy_from_logits(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Greedy token selection over a padded vocabulary: the padding columns
    (>= ``vocab_size``) are masked to -inf first, so the result is always a
    valid id. Ties go to the lowest id, as ``jnp.argmax``."""
    mask = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
    return torch.where(mask, float("-inf"), logits).argmax(dim=-1).to(
        torch.int32)


@dataclasses.dataclass(frozen=True)
class SamplingSpec:
    """Declarative sampling knobs for ``api.compile(..., sampling=)``.

    ``temperature=0`` is exact greedy; ``top_k=0`` / ``top_p=1.0`` disable
    the respective filters. ``seed`` seeds the actor-borne generator."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(
                f"temperature={self.temperature} must be >= 0 "
                "(0 = greedy)")
        if not isinstance(self.top_k, int) or self.top_k < 0:
            raise ValueError(f"top_k={self.top_k!r} must be an int >= 0 "
                             "(0 = disabled)")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p={self.top_p} must be in (0, 1] "
                             "(1.0 = disabled)")
        if not isinstance(self.seed, int):
            raise ValueError(f"seed={self.seed!r} must be an int")


def filter_logits(logits: torch.Tensor, spec: SamplingSpec,
                  vocab_size: int) -> torch.Tensor:
    """The reference's filter (``sampler.py:51-75``) on ``(rows,
    padded_vocab)`` logits, in float32: mask the padded-vocab columns, apply
    temperature, top-k, then top-p (nucleus, always keeping the most likely
    token). Dropped columns are ``-inf``."""
    vp = logits.shape[-1]
    pad = torch.arange(vp, device=logits.device) >= vocab_size
    z = torch.where(pad, float("-inf"), logits.float()) / spec.temperature
    k, p = spec.top_k, spec.top_p
    if 0 < k < vocab_size:
        kth = torch.topk(z, k, dim=-1).values[..., -1:]
        z = torch.where(z < kth, float("-inf"), z)
    if p < 1.0:
        sz = torch.sort(z, dim=-1, descending=True).values
        probs = torch.softmax(sz, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < p   # top-1 always kept
        thr = torch.where(keep, sz, float("inf")).amin(dim=-1, keepdim=True)
        z = torch.where(z < thr, float("-inf"), z)
    return z


def gumbel_max(z: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from ``softmax(z)``: ``argmax(z + g)`` with Gumbel
    noise ``g = -log(-log(u))`` from uniforms of ``generator``. A ``-inf``
    column is never drawn."""
    u = torch.rand(z.shape, generator=generator, device=z.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp_min(tiny)))
    return (z + g).argmax(dim=-1).to(torch.int32)


class SamplerStream:
    """The persistent sampler register: a generator drawn once per sampled
    work item. Lives in the last stage actor's closure or in the inline
    engine, on ``device``."""

    def __init__(self, spec: SamplingSpec, vocab_size: int, device):
        self.spec = spec
        self.vocab_size = vocab_size
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(spec.seed)

    def sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Draw one token per row of ``(rows, padded_vocab)`` logits,
        advancing the generator. ``temperature == 0`` is exact greedy --
        bitwise the ``greedy_from_logits`` path -- and draws nothing."""
        if self.spec.temperature == 0:
            return greedy_from_logits(logits, self.vocab_size)
        z = filter_logits(logits, self.spec, self.vocab_size)
        return gumbel_max(z, self.generator)
