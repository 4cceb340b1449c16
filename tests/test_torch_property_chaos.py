"""Property: message-level chaos never changes training bits (the port of
``tests/test_property_chaos.py`` on the threads runtime).

The actor protocol's correctness story (§4.2) is that counters -- not
arrival order -- decide when an actor acts: a Req is consumed only when its
version is next for its channel, duplicates are dropped by the per-channel
resequencer, and back-pressure comes from register quotas. So randomly
delaying and duplicating Reqs on real edges of a 1F1B AdamW pipeline must
be invisible in the numbers: same losses, same final params, bit for bit.

(DropAck is deliberately excluded: a dropped ack is a *detected* fault --
the producer's register is never freed, the run wedges and times out --
not a reordering the protocol must absorb;
``tests/test_torch_fault_tolerance.py`` covers it.)
"""
import numpy as np
import pytest
import torch

pytest.importorskip(
    "hypothesis",
    reason="property tests need hypothesis (see requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core.graph import LogicalGraph  # noqa: E402
from repro_torch.core.lowering import OptimizerSpec  # noqa: E402
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.runtime.chaos import (DelayEdge, DuplicateReq,  # noqa: E402
                                       FaultPlan)

B, W, S, M, STEPS = 8, 8, 2, 2, 3

#: real Req edges of the port's 2-stage train pipeline: the forward chain,
#: the stashed tape, the backward chain, the per-microbatch gradients into
#: the accumulators, the norm partials and the clip scale to an optimizer
EDGES = [("f0", "f1"), ("f1", "b1"), ("b1", "b0"), ("f0", "b0"),
         ("b0", "acc0"), ("b1", "acc1"), ("acc0", "norm"), ("norm", "opt1")]


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


_CACHE = {}


def _reference():
    if "ref" not in _CACHE:
        rng = np.random.default_rng(0)
        params = {f"w{i}": (rng.normal(size=(W, W)) * 0.1).astype(np.float32)
                  for i in range(S)}
        data = {"x": rng.normal(size=(B, W)).astype(np.float32),
                "labels": rng.integers(0, W, size=(B,)).astype(np.int32)}
        opt = OptimizerSpec.adamw(lr=1e-3, grad_clip=1.0)
        sess = api.compile(_graph(), mode="train", stages=S,
                           params=dict(params), optimizer=opt,
                           num_microbatches=M, device="cpu")
        losses = [float(sess.step(**data).loss) for _ in range(STEPS)]
        sess.close()
        _CACHE["ref"] = (params, data, opt, losses, sess.params)
    return _CACHE["ref"]


_edges = st.sampled_from(EDGES)

# versions restart every epoch (step): 0 .. M-1 per microbatch stream, M-1
# on an accumulator's output
_delays = st.builds(
    lambda e, secs, ver: DelayEdge(e[0], e[1], seconds=secs, version=ver),
    _edges, st.floats(0.005, 0.04),
    st.one_of(st.none(), st.integers(0, M - 1)))

_dups = st.builds(
    lambda e, ver: DuplicateReq(e[0], e[1], version=ver),
    _edges, st.integers(0, M - 1))

_plans = st.lists(st.one_of(_delays, _dups), min_size=1, max_size=3).map(
    lambda fs: FaultPlan(tuple(fs)))


class TestChaosInvariance:
    @settings(max_examples=8, deadline=None)
    @given(plan=_plans)
    def test_delay_duplicate_never_change_bits(self, plan):
        params, data, opt, ref_losses, ref_params = _reference()
        sess = api.compile(_graph(), mode="train", stages=S,
                           params=dict(params), optimizer=opt,
                           num_microbatches=M, faults=plan, device="cpu")
        try:
            losses = [float(sess.step(**data).loss) for _ in range(STEPS)]
            final = sess.params
            applied = sess.executor.runtime.fault_injector.applied
        finally:
            sess.close()
        assert losses == ref_losses, plan
        for n, v in ref_params.items():
            assert torch.equal(final[n], v), (n, plan)
        # a fault on an edge whose version occurs triggers exactly once
        assert len(applied) <= len(plan.faults)

    def test_faults_on_real_edges_apply_and_change_no_bits(self):
        """One delayed and one duplicated Req on real edges: both trigger
        (the injector's record), and the run is the reference's bit for
        bit."""
        params, data, opt, ref_losses, ref_params = _reference()
        plan = FaultPlan([DelayEdge("f0", "f1", seconds=0.02, version=1),
                          DuplicateReq("b1", "b0", version=0)])
        with api.compile(_graph(), mode="train", stages=S,
                         params=dict(params), optimizer=opt,
                         num_microbatches=M, faults=plan,
                         device="cpu") as sess:
            losses = [float(sess.step(**data).loss) for _ in range(STEPS)]
            final = sess.params
            applied = sess.executor.runtime.fault_injector.applied
        assert losses == ref_losses
        for n, v in ref_params.items():
            assert torch.equal(final[n], v), n
        assert sorted(applied) == [("DelayEdge", "f0", "f1", 1),
                                   ("DuplicateReq", "b1", "b0", 0)]
