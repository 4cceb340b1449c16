"""repro_torch.analysis — the static plan verifier (compile-time oracle),
the port of ``repro/analysis/``.

Four passes over the compiled artifacts — LogicalGraph + SBP plan + stage
partition + ActorSpec graph + register quotas — none of which execute a
single stage program:

* :mod:`repro_torch.analysis.deadlock` — abstract token-flow saturation of the
  actor network (actors = transitions, out registers = places with capacity
  = quota, ``emit_every``-aware rates); rejects quota-starved cycles and
  rate-mismatched sideways edges, and reports the minimal feasible quota
  vector.
* :mod:`repro_torch.analysis.sbp_check` — every edge's (producer SBP, consumer
  SBP, mesh shape) must be priced by the Table-2 cost model, split axes must
  divide the logical shape, and partial values must not leak past combiners
  or materialization points.
* :mod:`repro_torch.analysis.membound` — static peak in-flight bytes per device
  from quotas × per-device payload bytes (activations, optimizer state
  streams, serve cache slabs).
* :mod:`repro_torch.analysis.trace` — a vector-clock happens-before sanitizer over
  recorded Req delivery traces (chaos harness integration), certifying the
  per-channel resequencer restores canonical order.

``api.compile(..., check="static")`` (the default) runs the first three and
raises :class:`AnalysisError` on FAIL; ``python -m repro_torch.analysis`` runs
them from the command line over a config-zoo model.  The ``plan="search"``
roadmap item consumes :func:`run_static_checks` as its feasibility oracle.

The passes read the topology and never the state: building a session's
specs again allocates nothing on a device and launches nothing (a serve
stage reserves its cache at its first fire), so the check costs host
milliseconds even at full width.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.analysis import membound
from repro_torch.analysis.deadlock import (DeadlockResult, check_deadlock,
                                           deadlock_violations,
                                           min_feasible_regs,
                                           min_feasible_stage_regs)
from repro_torch.analysis.report import (AnalysisError, StaticReport,
                                         Violation)
from repro_torch.analysis.sbp_check import check_sbp
from repro_torch.analysis.skeleton import (infer_spec_skeleton,
                                           serve_spec_skeleton,
                                           train_spec_skeleton)
from repro_torch.analysis.trace import (TraceRecorder, TraceStats,
                                        check_trace)
from repro_torch.runtime.actor import ActorSpec

__all__ = [
    "AnalysisError", "StaticReport", "Violation", "DeadlockResult",
    "TraceRecorder", "TraceStats", "check_deadlock", "check_sbp",
    "check_trace", "deadlock_violations", "min_feasible_regs",
    "min_feasible_stage_regs", "infer_spec_skeleton", "serve_spec_skeleton",
    "train_spec_skeleton", "run_static_checks", "run_session_checks",
    "membound",
]


def run_static_checks(
    *,
    specs: Optional[Sequence[ActorSpec]] = None,
    fires: Optional[Mapping[str, int]] = None,
    graph: Any = None,
    plan: Any = None,
    partition: Any = None,
    boundary_sbp: Optional[Dict[str, Any]] = None,
    memory: Optional[Dict[str, int]] = None,
    find_min_regs: bool = True,
) -> StaticReport:
    """Run every applicable pass and fold the findings into one report.

    Passes run on whatever artifacts are provided: the deadlock pass needs
    ``specs`` (+ optional ``fires`` overrides), the SBP pass needs ``graph``
    and ``plan`` (+ optional ``partition``/``boundary_sbp``), and ``memory``
    is a precomputed per-device byte bound to surface.  This is the oracle
    ``plan="search"`` will call per candidate plan.
    """
    violations: Tuple[Violation, ...] = ()
    passes: Tuple[str, ...] = ()
    checked_edges = 0
    checked_channels = 0
    min_regs: Optional[Dict[str, int]] = None

    if specs is not None:
        result = check_deadlock(specs, fires=fires)
        violations += tuple(deadlock_violations(result))
        checked_channels += result.channels
        passes += ("deadlock",)
        if not result.ok and find_min_regs:
            min_regs = min_feasible_regs(specs, fires=fires)
    if graph is not None and plan is not None:
        sbp_violations, n_edges = check_sbp(
            graph, plan, partition, boundary_sbp=boundary_sbp)
        violations += tuple(sbp_violations)
        checked_edges += n_edges
        passes += ("sbp",)
    if memory is not None:
        passes += ("memory",)

    verdict = "FAIL" if violations else "PASS"
    return StaticReport(
        verdict=verdict,
        violations=violations,
        checked_edges=checked_edges,
        checked_channels=checked_channels,
        peak_bytes_per_device=dict(memory or {}),
        min_feasible_regs=min_regs,
        passes=passes,
    )


def _default_regs(num_stages: int) -> list:
    return [max(1, num_stages - s) for s in range(num_stages)]


def run_session_checks(sess: Any) -> StaticReport:
    """Run the static passes over a compiled ``api`` session (duck-typed:
    works on :class:`repro_torch.api.Session` and
    :class:`repro_torch.api.ServeSession` across every mode × backend ×
    runtime)."""
    if getattr(sess, "mode", None) == "serve":
        return _serve_session_checks(sess)
    return _graph_session_checks(sess)


def _graph_session_checks(sess: Any) -> StaticReport:
    specs = None
    boundary_sbp = None
    memory: Optional[Dict[str, int]] = None
    if sess.backend == "actors":
        specs, _ = sess._engine._make_builder()()
        staged = getattr(sess._engine, "tstaged",
                         getattr(sess._engine, "staged", None))
        if staged is not None:
            boundary_sbp = staged.boundary_sbp
            num_stages = staged.num_stages
            regs = sess.regs if sess.regs is not None \
                else _default_regs(num_stages)
            if sess.mode == "train":
                memory = membound.train_memory_bound(
                    staged, regs, sess.num_microbatches,
                    optimizer=sess.optimizer)
            else:
                memory = membound.infer_memory_bound(
                    staged, regs, sess.num_microbatches)
    else:
        memory = membound.monolithic_memory_bound(sess.graph, sess.plan)
    return run_static_checks(
        specs=specs, graph=sess.graph, plan=sess.plan,
        partition=sess.partition, boundary_sbp=boundary_sbp, memory=memory)


def _serve_session_checks(sess: Any) -> StaticReport:
    specs = None
    fires = None
    num_stages = sess.sstaged.num_stages
    regs = sess.regs if sess.regs is not None else _default_regs(num_stages)
    if sess.backend == "actors":
        specs, _ = sess._engine._make_builder()()
        # serve specs are open-ended (max_fires=0, bounded per round); the
        # static pass analyzes one representative full round instead
        round_items = max(1, int(sess.num_groups))
        fires = {s.name: round_items for s in specs}
    memory = membound.serve_memory_bound(
        sess.sstaged, regs, sess.num_groups,
        cache=sess.cache, cache_spec=sess.cache_spec)
    return run_static_checks(specs=specs, fires=fires, memory=memory)
