"""The public entry point of the port: ``compile``.

Port of ``repro/api.py``'s serving path: ``compile(cfg, mode="serve")``
builds a :class:`ServeSession` that runs continuously-batched greedy decode
over the lowered stage programs — on stage actors
(``backend="actors"``, the threaded runtime) or inline
(``backend="monolithic"``, the token-for-token reference). What the
reference offers beyond that raises :class:`NotImplementedError` naming its
ROADMAP item: graph modes, the paged cache, sampling, the process runtime
and the static verifier.

Entry points run on the card: ``device=None`` means ``"cuda"``, and with no
card an entry point raises unless the caller asks for ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lowering import lower_serve_stages
from repro_torch.models.common import MeshPlan, resolve_device
from repro_torch.models.transformer import (Transformer, has_ssm_layers,
                                            stack_layout)
from repro_torch.runtime.pipeline import (InlineServeEngine,
                                          ServePipelineExecutor)

MODES = ("infer", "train", "serve")
BACKENDS = ("actors", "monolithic")
#: options of the reference's ``compile`` that the port does not take yet,
#: with what they are and the ROADMAP item that brings them
NOT_PORTED = {
    "page_len": "paged cache, ROADMAP Queue 1 item 1",
    "num_pages": "paged cache, ROADMAP Queue 1 item 1",
    "prefill_chunk": "chunked prefill, ROADMAP Queue 1 item 1",
    "regs": "explicit register quotas and the 'gpipe'/'serial' policies; "
            "the port keeps the 1F1B rule, ROADMAP Queue 1 item 4",
    "fn_wrap": "stage-body wrappers, ROADMAP Queue 1 item 14",
}


def greedy_from_logits(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Greedy token selection over a padded vocabulary: the padding columns
    (>= ``vocab_size``) are masked to -inf first, so the result is always a
    valid id. Ties go to the lowest id, as ``jnp.argmax``."""
    mask = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
    return torch.where(mask, float("-inf"), logits).argmax(dim=-1).to(
        torch.int32)


@dataclasses.dataclass
class ServeRequest:
    """One generation request: prompt token ids + how many tokens to decode
    (the first generated token, from the prefill logits, counts)."""

    tokens: Any
    max_new_tokens: int


class ServeSession:
    """Pipelined, continuously-batched greedy decode over the actor runtime.

    :meth:`generate` runs a set of :class:`ServeRequest`\\ s to completion:
    requests are packed into ``num_groups * group_size`` decode slots, each
    round advances every live group by one token (one ``DecodeWork`` per
    group streamed down the stage actors), finished requests retire their
    slot and queued ones are admitted mid-flight with a ``PrefillWork``.
    ``history`` accumulates one record per round, ``last_stats`` describes
    the last :meth:`generate`.
    """

    def __init__(self, *, cfg, backend: str, engine, sstaged,
                 num_groups: int, group_size: int, cache_len: int,
                 max_prompt_len: int, max_new_tokens: int,
                 device: torch.device,
                 timeout: float = 300.0, runtime: Optional[str] = None):
        self.cfg = cfg
        self.mode = "serve"
        self.backend = backend
        self.runtime = runtime        # "threads"; None: monolithic
        self.sstaged = sstaged
        self.num_groups = num_groups
        self.group_size = group_size
        self.cache_len = cache_len
        self.max_prompt_len = max_prompt_len
        self.max_new_tokens = max_new_tokens
        # the stage out-register quotas (the 1F1B rule); None: monolithic
        self.regs = getattr(engine, "regs", None)
        self.device = device
        self.timeout = timeout
        self.history: List[Dict[str, Any]] = []
        self.last_stats: Optional[Dict[str, Any]] = None
        self._engine = engine

    @property
    def last_makespan(self) -> Optional[float]:
        return self._engine.last_makespan

    def close(self) -> None:
        """Release the engine's workers (no-op for the inline engine)."""
        close = getattr(self._engine, "close", None)
        if close is not None:
            close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @staticmethod
    def _normalize(requests) -> List[ServeRequest]:
        return [r if isinstance(r, ServeRequest) else
                ServeRequest(r[0], int(r[1])) for r in requests]

    def generate(self, requests) -> List[np.ndarray]:
        """Run ``requests`` (ServeRequests or ``(tokens, max_new_tokens)``
        pairs) to completion with continuous batching; returns one int32
        token array per request, in submission order."""
        from repro_torch.serve.admission import AdmissionScheduler

        reqs = self._normalize(requests)
        V = self.cfg.vocab_size
        # an SSM layer's prefill keeps the last d_conv - 1 rows of its conv
        # inputs as the decode state: a shorter prompt has too few (the
        # reference breaks there with a shape error)
        min_len = min_prompt_len(self.cfg)
        prompts = []
        for i, r in enumerate(reqs):
            toks = np.asarray(r.tokens, dtype=np.int32)
            if toks.ndim != 1 or toks.size == 0:
                raise ValueError(f"request {i}: prompt must be a non-empty "
                                 f"1-d token array, got shape {toks.shape}")
            if toks.size < min_len:
                raise ValueError(
                    f"request {i}: prompt length {toks.size} is below "
                    f"ssm_d_conv - 1 = {min_len}: {self.cfg.name}'s SSM "
                    "layers need that many tokens for their conv state")
            if toks.size > self.max_prompt_len:
                raise ValueError(
                    f"request {i}: prompt length {toks.size} exceeds "
                    f"max_prompt_len={self.max_prompt_len}")
            if (toks < 0).any() or (toks >= V).any():
                raise ValueError(f"request {i}: prompt ids must be in "
                                 f"[0, {V})")
            if not (1 <= r.max_new_tokens <= self.max_new_tokens):
                raise ValueError(
                    f"request {i}: max_new_tokens={r.max_new_tokens} must "
                    f"be in [1, {self.max_new_tokens}]")
            prompts.append(toks)

        sched = AdmissionScheduler(
            prompts, [r.max_new_tokens for r in reqs],
            num_groups=self.num_groups, group_size=self.group_size,
            cache_len=self.cache_len, device=self.device)
        t0 = time.perf_counter()
        while not sched.done():
            work, meta = sched.plan_round()
            results = self._engine.run_round(work, timeout=self.timeout)
            for m, res in zip(meta, results):
                sched.absorb(m, greedy_from_logits(res, V).cpu().numpy())
            self.history.append({"kind": "round", "items": len(work),
                                 "makespan": self._engine.last_makespan})
        wall = time.perf_counter() - t0
        total = sum(len(o) for o in sched.outputs)
        self.last_stats = {
            "requests": len(reqs), "tokens": total,
            "rounds": self._engine.rounds, "wall_s": wall,
            "tok_per_s": total / wall if wall > 0 else float("inf"),
            "admitted_mid_flight": sched.admitted_mid_flight,
            "prefill_items": sched.prefill_items,
            "decode_items": sched.decode_items,
        }
        self.history.append({"kind": "generate", **self.last_stats})
        return [np.asarray(o, np.int32) for o in sched.outputs]

    def describe(self) -> str:
        """Human-readable report of the compiled serving artifact."""
        cfg = self.cfg
        rt = f" runtime={self.runtime}" if self.runtime is not None else ""
        lines = [f"=== repro_torch.api session: mode=serve "
                 f"backend={self.backend}{rt} ===",
                 f"model: {cfg.name} ({cfg.num_layers} layers, "
                 f"d_model={cfg.d_model}, vocab={cfg.vocab_size} "
                 f"padded to {cfg.padded_vocab()}, dtype={cfg.dtype})",
                 f"slots: {self.num_groups} groups x {self.group_size} "
                 f"(cache_len={self.cache_len}, "
                 f"max_prompt_len={self.max_prompt_len}, "
                 f"max_new_tokens={self.max_new_tokens})",
                 "cache: dense (one group block per slot group)",
                 self.sstaged.describe()]
        if self.regs is not None:
            lines.append(f"register quotas: {self.regs}")
        lines.append("static check: not run (check='off'; the plan verifier "
                     "is not ported yet, ROADMAP Queue 1 item 12)")
        return "\n".join(lines)

    def __repr__(self):
        return (f"ServeSession(backend={self.backend!r}, "
                f"stages={self.sstaged.num_stages}, "
                f"groups={self.num_groups}x{self.group_size})")


def min_prompt_len(cfg: ModelConfig) -> int:
    """The shortest prompt ``cfg`` can prefill: ``ssm_d_conv - 1`` tokens
    when it has SSM layers (their conv state), else 0."""
    return cfg.ssm_d_conv - 1 if has_ssm_layers(cfg) else 0


def _serve_options(*, num_groups, group_size, cache_len, max_prompt_len,
                   max_new_tokens, tp: int = 1):
    """Resolve defaults and validate the serve-only compile options at
    compile time. Returns ``(num_groups, group_size, cache_len,
    max_prompt_len, max_new_tokens)``."""
    num_groups = 2 if num_groups is None else num_groups
    group_size = 2 if group_size is None else group_size
    max_prompt_len = 64 if max_prompt_len is None else max_prompt_len
    max_new_tokens = 64 if max_new_tokens is None else max_new_tokens
    if num_groups < 1 or group_size < 1:
        raise ValueError(f"num_groups={num_groups} and "
                         f"group_size={group_size} must be >= 1")
    if max_prompt_len < 1 or max_new_tokens < 1:
        raise ValueError(f"max_prompt_len={max_prompt_len} and "
                         f"max_new_tokens={max_new_tokens} must be >= 1")
    if cache_len is None:
        cache_len = max_prompt_len + max_new_tokens + 9
        cache_len += -cache_len % tp
    elif cache_len <= max_prompt_len + max_new_tokens:
        # the last cache position is the parking slot for retired requests
        raise ValueError(
            f"cache_len={cache_len} must exceed max_prompt_len + "
            f"max_new_tokens = {max_prompt_len + max_new_tokens} "
            "(the final position is reserved for parked slots); lower "
            "max_prompt_len= or max_new_tokens=, or raise cache_len=")
    return num_groups, group_size, cache_len, max_prompt_len, max_new_tokens


def _load_model(cfg: ModelConfig, params, seed: int,
                device: torch.device) -> Transformer:
    """The model to serve: ``params`` as a Transformer or a state_dict
    (e.g. from :func:`repro_torch.models.convert.params_from_jax`), or the
    port's seeded init when ``params`` is None."""
    from repro_torch.models.model_zoo import build_model

    plan = MeshPlan.single_device()
    if params is None:
        return build_model(cfg, plan, seed=seed, device=device)
    if isinstance(params, Transformer):
        return params.to(device)
    if not isinstance(params, Mapping):
        raise ValueError("params= takes a repro_torch Transformer or its "
                         f"state_dict, got {type(params).__name__}")
    with torch.device("meta"):
        model = Transformer(cfg, plan)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()},
                          assign=True)
    return model.to(device)


def compile(model: Union[ModelConfig, str], *, mode: str = "serve",
            backend: str = "actors", runtime: Optional[str] = None,
            stages: Optional[int] = None,
            params: Optional[Union[Transformer, Mapping[str, Any]]] = None,
            device=None, seed: int = 0,
            timeout: float = 300.0, num_groups: Optional[int] = None,
            group_size: Optional[int] = None,
            cache_len: Optional[int] = None,
            max_prompt_len: Optional[int] = None,
            max_new_tokens: Optional[int] = None,
            cache: Optional[str] = None, sampling=None,
            check: str = "off", **graph_options) -> ServeSession:
    """Compile a :class:`~repro_torch.configs.base.ModelConfig` (or an
    ``--arch`` name) into a :class:`ServeSession` (``mode="serve"``).

    * ``backend``: ``"actors"`` cuts the stack into ``stages`` stage
      programs (default ``min(2, units)``) run by stage actors with
      register-quota back-pressure (the 1F1B quotas ``max(1, S - s)``);
      ``"monolithic"`` runs the whole stack as one stage inline — the
      token-for-token reference.
    * ``params``: a :class:`~repro_torch.models.transformer.Transformer`,
      its ``state_dict``, or None for the port's seeded init (``seed``).
    * ``device``: None means ``"cuda"`` (raises without a card); tests pass
      ``"cpu"``.
    * ``num_groups``, ``group_size``, ``cache_len``, ``max_prompt_len``,
      ``max_new_tokens``: the slot geometry, as in the reference.
    * ``check``: only ``"off"`` — the static verifier is not ported yet.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if mode != "serve":
        raise NotImplementedError(
            f"mode={mode!r} (graph compilation) is not ported yet (ROADMAP "
            "Queue 1 items 6 and 7); the port serves mode='serve'")
    later = sorted(set(graph_options) & set(NOT_PORTED))
    if later:
        raise NotImplementedError(f"{later[0]}= ({NOT_PORTED[later[0]]}) is "
                                  "not ported yet")
    if graph_options:
        raise ValueError(f"{sorted(graph_options)[0]}= is not meaningful "
                         "for mode='serve'")
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if check != "off":
        raise NotImplementedError(
            f"check={check!r}: the static plan verifier is not ported yet "
            "(ROADMAP Queue 1 item 12); pass check='off'")
    if cache not in (None, "dense"):
        raise NotImplementedError(
            f"cache={cache!r} is not ported yet (ROADMAP Queue 1 item 1); "
            "the port serves cache='dense'")
    if sampling is not None:
        raise NotImplementedError(
            "sampling= is not ported yet (ROADMAP Queue 1 item 2); the port "
            "decodes greedily")
    if runtime == "processes":
        raise NotImplementedError(
            "runtime='processes' is not ported yet (ROADMAP Queue 1 item 11)")
    if runtime not in (None, "threads"):
        raise ValueError(f"unknown runtime {runtime!r}")
    if backend == "monolithic" and runtime is not None:
        raise ValueError("runtime= requires backend='actors'")
    if isinstance(model, str):
        from repro_torch.configs.registry import get_config
        model = get_config(model)
    if not isinstance(model, ModelConfig):
        raise ValueError("mode='serve' compiles a ModelConfig (or an --arch "
                         f"name), got {type(model).__name__}")
    cfg = model
    dev = resolve_device(device)
    (num_groups, group_size, cache_len, max_prompt_len,
     max_new_tokens) = _serve_options(
        num_groups=num_groups, group_size=group_size, cache_len=cache_len,
        max_prompt_len=max_prompt_len, max_new_tokens=max_new_tokens)

    lay = stack_layout(cfg)
    n_units = len(lay.prologue) + lay.n_periods
    if backend == "monolithic":
        if stages not in (None, 1):
            raise ValueError("backend='monolithic' serves the whole stack "
                             "as one stage; use backend='actors' for "
                             f"stages={stages}")
        stages = 1
    elif stages is None:
        stages = min(2, n_units)

    sstaged = lower_serve_stages(cfg, _load_model(cfg, params, seed, dev),
                                 num_stages=stages, cache_len=cache_len,
                                 max_prompt_len=max_prompt_len,
                                 group_size=group_size)
    if backend == "monolithic":
        engine = InlineServeEngine(sstaged)
    else:
        runtime = "threads"
        engine = ServePipelineExecutor(sstaged, runtime=runtime)
    return ServeSession(cfg=cfg, backend=backend, engine=engine,
                        sstaged=sstaged, num_groups=num_groups,
                        group_size=group_size, cache_len=cache_len,
                        max_prompt_len=max_prompt_len,
                        max_new_tokens=max_new_tokens, device=dev,
                        timeout=timeout, runtime=runtime)
