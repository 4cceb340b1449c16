"""Property: the port's static deadlock verdict agrees with its runtime
(the port of ``tests/test_property_analysis.py``).

Both oracle directions, on randomly generated bounded-buffer actor DAGs:

* analyzer says PASS  -> the ThreadedRuntime drives the network to
  completion (every bounded actor exhausts its fire budget);
* analyzer says DEADLOCK -> the same network wedges and the runtime's
  watchdog raises TimeoutError.

Plus the trace-sanitizer property: under random DelayEdge/DuplicateReq
fault plans on a real 1F1B train pipeline, the recorded Req trace still
replays in canonical per-channel order (the resequencer absorbed every
fault) and the vector-clock happens-before check holds. The reference's
settings: 20 and 8 examples, 20 s and 1 s run timeouts.
"""
import numpy as np
import pytest

pytest.importorskip(
    "hypothesis",
    reason="property tests need hypothesis (see requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.analysis.deadlock import check_deadlock  # noqa: E402
from repro_torch.analysis.trace import TraceRecorder, check_trace  # noqa: E402
from repro_torch.core.graph import LogicalGraph  # noqa: E402
from repro_torch.core.lowering import OptimizerSpec  # noqa: E402
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.runtime.actor import ActorSpec  # noqa: E402
from repro_torch.runtime.chaos import (DelayEdge, DuplicateReq,  # noqa: E402
                                       FaultPlan)
from repro_torch.runtime.threaded import ThreadedRuntime  # noqa: E402

FIRES = 4  # fire budget for every generated actor


def _noop(*args):
    return 0


@st.composite
def _dags(draw):
    """A bounded source plus 2..5 actors, each consuming a nonempty subset
    of the actors before it (so the network is a connected-enough DAG).

    Fire budgets are drawn around the *rate-consistent* value (the most the
    actor's slowest input channel can feed it), so the sampler lands on both
    sides of the verdict: exact budgets give live networks (modulo quota
    starvation from shared producers), over-budgets give starvation, and
    tight quotas with fan-out give genuine quota-starved cycles."""
    n = draw(st.integers(2, 5))
    specs = [ActorSpec("a0", fn=_noop, inputs=(),
                       out_regs=draw(st.integers(1, 2)), max_fires=FIRES)]
    emissions = {"a0": FIRES}
    for i in range(1, n + 1):
        k = draw(st.integers(1, min(2, i)))
        inputs = tuple(sorted(draw(st.lists(
            st.sampled_from([f"a{j}" for j in range(i)]),
            min_size=k, max_size=k, unique=True))))
        emit_every = draw(st.sampled_from((1, 1, 1, 2)))
        feasible = min(emissions[p] for p in inputs)
        max_fires = max(1, draw(st.sampled_from(
            (feasible, feasible, feasible, feasible - 1, feasible + 1))))
        specs.append(ActorSpec(
            f"a{i}", fn=_noop, inputs=inputs,
            out_regs=draw(st.integers(1, 2)),
            max_fires=max_fires, emit_every=emit_every))
        emissions[f"a{i}"] = max_fires // emit_every
    return specs


class TestDeadlockOracle:
    @settings(max_examples=20, deadline=None)
    @given(specs=_dags())
    def test_verdict_matches_threaded_runtime(self, specs):
        result = check_deadlock(specs)
        rt = ThreadedRuntime(specs)
        try:
            if result.ok:
                rt.run(timeout=20.0)
                assert rt.last_fired == dict(result.required)
            else:
                with pytest.raises(TimeoutError):
                    rt.run(timeout=1.0)
        finally:
            rt.close()


B, W, S, M = 8, 8, 2, 2

#: real Req edges of the port's 2-stage train pipeline: the forward chain,
#: the stashed activation, the backward chain, each stage's gradients into
#: its accumulator
EDGES = [("f0", "f1"), ("f1", "b1"), ("b1", "b0"),
         ("b0", "acc0"), ("b1", "acc1")]


def _graph():
    g = LogicalGraph(Placement(("d",), (1,)))
    h = g.input("x", (B, W))
    labels = g.input("labels", (B,), dtype="int32")
    for i in range(S):
        w = g.input(f"w{i}", (W, W))
        h = g.matmul(h, w, name=f"mm{i}")
        if i < S - 1:
            h = g.unary(h, "relu", name=f"relu{i}")
    g.softmax_xent(h, labels, name="loss")
    return g


_edges = st.sampled_from(EDGES)

_delays = st.builds(
    lambda e, secs, ver: DelayEdge(e[0], e[1], seconds=secs, version=ver),
    _edges, st.floats(0.005, 0.04),
    st.one_of(st.none(), st.integers(0, M - 1)))

_dups = st.builds(
    lambda e, ver: DuplicateReq(e[0], e[1], version=ver),
    _edges, st.integers(0, M - 1))

_plans = st.lists(st.one_of(_delays, _dups), min_size=1, max_size=3).map(
    lambda fs: FaultPlan(tuple(fs)))


class TestTraceSanitizerProperty:
    @settings(max_examples=8, deadline=None)
    @given(plan=_plans)
    def test_resequencer_certified_under_chaos(self, plan):
        rng = np.random.default_rng(0)
        params = {f"w{i}": (rng.normal(size=(W, W)) * 0.1).astype(np.float32)
                  for i in range(S)}
        data = {"x": rng.normal(size=(B, W)).astype(np.float32),
                "labels": rng.integers(0, W, size=(B,)).astype(np.int32)}
        rec = TraceRecorder()
        sess = api.compile(_graph(), mode="train", stages=S,
                           params=dict(params),
                           optimizer=OptimizerSpec.adamw(lr=1e-3),
                           num_microbatches=M, faults=plan, device="cpu")
        try:
            sess.executor.trace = rec
            sess.step(**data)
            sess.step(**data)
            specs, _ = sess._engine._make_builder()()
            violations, stats = check_trace(rec, specs)
        finally:
            sess.close()
        assert violations == [], (plan, violations)
        assert stats.deliveries > 0
        assert stats.faults == len(plan.faults)
