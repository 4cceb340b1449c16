"""The port's SBP layer, planner, stage partition and register planning.

Mirrors ``tests/test_sbp.py``, ``tests/test_planner.py``, the simulator
half of ``tests/test_actor_runtime.py``, ``tests/test_property_sbp.py`` and
``tests/test_property_actor.py`` on ``repro_torch``, then holds the port to
the JAX package: for the same graphs, on 1-D and 2-D placements, the port's
``Plan``, stage partition and register quotas must *equal* the reference's
(planning is pure Python and needs no devices). The parity tests import the
JAX package (``importorskip("jax")``); the property tests need hypothesis.
"""
import math

import numpy as np
import pytest

from repro_torch.core import ops as ops_mod
from repro_torch.core.boxing import (boxing_fn, nd_transition_cost,
                                     transition_cost)
from repro_torch.core.graph import LogicalGraph, partition_stages
from repro_torch.core.placement import Placement
from repro_torch.core.planner import plan
from repro_torch.core.sbp import (Broadcast, NdSbp, Partial, Sbp, Split,
                                  ndsbp)
from repro_torch.runtime.actor import ActorSpec
from repro_torch.runtime.pipeline import (analyze, pipeline_specs,
                                          plan_registers)
from repro_torch.runtime.scheduler import CommModel, simulate


def _noop(*a):
    return 0


# ---------------------------------------------------------------------------
# SBP types, Table 2 and the op rules (tests/test_sbp.py)
# ---------------------------------------------------------------------------

class TestSbpTypes:
    def test_parse_components(self):
        assert Sbp.parse("S(0)") == Split(0)
        assert Sbp.parse("S(3)") == Split(3)
        assert Sbp.parse("B") == Broadcast()
        assert Sbp.parse("P") == Partial("sum")
        assert Sbp.parse("P(max)") == Partial("max")

    def test_parse_nd(self):
        assert ndsbp("S(0), B").components == (Split(0), Broadcast())
        assert ndsbp("(S(0), S(1), P(sum))").components == (
            Split(0), Split(1), Partial("sum"))

    def test_invalid(self):
        with pytest.raises(ValueError):
            Sbp.parse("Q(1)")
        with pytest.raises(ValueError):
            Partial("mean")
        with pytest.raises(ValueError):
            Split(-1)

    def test_local_shape(self):
        assert ndsbp("S(0), S(1)").local_shape((8, 16), (2, 4)) == (4, 4)
        assert ndsbp("S(0), S(0)").local_shape((8, 16), (2, 4)) == (1, 16)
        assert ndsbp("B, P").local_shape((8, 16), (2, 4)) == (8, 16)

    def test_validate_rejects_uneven(self):
        with pytest.raises(ValueError):
            ndsbp("S(0), B").validate_for_shape((7, 3), (2, 4))
        with pytest.raises(ValueError):
            ndsbp("S(2), B").validate_for_shape((8, 8), (2, 4))

    def test_num_replicas(self):
        assert ndsbp("B, B").num_replicas((2, 4)) == 8
        assert ndsbp("S(0), B").num_replicas((2, 4)) == 4
        assert ndsbp("S(0), S(1)").num_replicas((2, 4)) == 1


class TestTable2Cost:
    """Table 2 of the paper, entry by entry."""

    T = 1024.0
    p = 4

    def c(self, a, b, disjoint=False, p2=None):
        return transition_cost(Sbp.parse(a), Sbp.parse(b), self.T, self.p,
                               p2=p2, disjoint=disjoint)

    def test_same_set(self):
        p, T = self.p, self.T
        assert self.c("S(0)", "S(0)").volume == 0
        r = self.c("S(0)", "S(1)")
        assert r.volume == (p - 1) / p * T and r.primitive == "all_to_all"
        r = self.c("S(0)", "B")
        assert r.volume == (p - 1) * T and r.primitive == "all_gather"
        for a, b in (("S(0)", "P"), ("B", "S(1)"), ("B", "B"), ("B", "P"),
                     ("P", "P")):
            assert self.c(a, b).volume == 0
        r = self.c("P", "S(0)")
        assert r.volume == (p - 1) * T and r.primitive == "reduce_scatter"
        r = self.c("P", "B")
        assert r.volume == 2 * (p - 1) * T and r.primitive == "all_reduce"

    def test_disjoint_set(self):
        p, T, p2 = self.p, self.T, 8
        want = {("S(0)", "S(0)"): T, ("S(0)", "S(1)"): T,
                ("S(0)", "B"): p2 * T, ("S(0)", "P"): T, ("B", "S(0)"): T,
                ("B", "B"): p2 * T, ("B", "P"): T, ("P", "S(0)"): p * T,
                ("P", "B"): (p + p2 - 1) * T, ("P", "P"): p * T}
        for (a, b), v in want.items():
            assert self.c(a, b, True, p2).volume == v, (a, b)

    def test_nd_costs(self):
        assert nd_transition_cost(ndsbp("S(0),B"), ndsbp("S(0),B"), self.T,
                                  (2, 4)) == 0
        got = nd_transition_cost(ndsbp("S(0),S(1)"), ndsbp("S(0),B"),
                                 self.T, (2, 4))
        assert got == (4 - 1) * self.T / 2


class TestDeduction:
    def test_matmul_table1(self):
        spec = ops_mod.OpSpec(ops_mod.get("matmul"))
        rows = {(repr(r.ins[0]), repr(r.ins[1])): repr(r.out)
                for r in spec.rules()}
        assert rows == {("S(0)", "B"): "S(0)", ("B", "S(1)"): "S(1)",
                        ("S(1)", "S(0)"): "P(sum)", ("P(sum)", "B"): "P(sum)",
                        ("B", "P(sum)"): "P(sum)", ("B", "B"): "B"}

    def test_matmul_table3_2d(self):
        spec = ops_mod.OpSpec(ops_mod.get("matmul"))
        sigs = {(repr(i[0]), repr(i[1])): repr(o)
                for i, o, _ in spec.nd_signatures(2)}
        assert sigs[("(S(0), B)", "(B, S(1))")] == "(S(0), S(1))"
        assert sigs[("(S(0), S(1))", "(B, S(0))")] == "(S(0), P(sum))"

    def test_bias_add_excludes_partial_and_partial_only_through_linear(self):
        spec = ops_mod.OpSpec(ops_mod.get("bias_add"))
        assert not any(r.ins[0].is_partial for r in spec.rules())
        lin = ops_mod.OpSpec(ops_mod.get("ew_unary"),
                             {"ndim": 2, "linear": True})
        non = ops_mod.OpSpec(ops_mod.get("ew_unary"),
                             {"ndim": 2, "linear": False})
        assert any(r.ins[0].is_partial for r in lin.rules())
        assert not any(r.ins[0].is_partial for r in non.rules())


class TestBoxing:
    def test_identity_on_size_one_axes(self):
        x = object()
        for src, dst in (("S(0)", "B"), ("P", "B"), ("B", "S(1)"),
                         ("S(0)", "S(1)"), ("B", "P")):
            f = boxing_fn(src, dst, ("d",), (1,), (4, 4))
            assert f(x) is x

    def test_larger_axes_raise_naming_item_8(self):
        """Boxing on axes larger than 1 runs its collectives inside spmd;
        an unchanged signature is the identity. (The name dates from
        before the mesh substrate, when these axes raised.)"""
        import torch
        from repro_torch.core.mesh import spmd
        assert boxing_fn("S(0),B", "S(0),B", ("a", "b"), (2, 4), (8, 8))(1) == 1
        mesh = Placement(("d",), (4,)).to_mesh("cpu")
        x = torch.arange(64.0).reshape(8, 8)
        out = spmd(boxing_fn("S(0)", "B", ("d",), (4,), (8, 8)), mesh)(
            list(x.chunk(4)))
        assert all(torch.equal(o, x) for o in out)


# ---------------------------------------------------------------------------
# The planner (tests/test_planner.py)
# ---------------------------------------------------------------------------

def _mk2d(data=2, model=4):
    return Placement(("data", "model"), (data, model))


def test_planner_prefers_data_parallel_for_small_weights():
    g = LogicalGraph(_mk2d())
    x = g.input("x", (1024, 32), sbp="S(0),S(0)")
    w = g.input("w", (32, 32))
    g.matmul(x, w)
    p = plan(g)
    assert p.total_cost == 0
    assert repr(p.tensor_sbp["w"]) == "(B, B)"


def test_planner_megatron_mlp_keeps_splits_and_materializes_once():
    g = LogicalGraph(_mk2d())
    x = g.input("x", (256, 512), sbp="S(0),B")
    w1 = g.input("w1", (512, 2048), sbp="B,S(1)")
    w2 = g.input("w2", (2048, 512), sbp="B,S(0)")
    a = g.unary(g.matmul(x, w1, name="mm1"), "relu", name="relu")
    g.matmul(a, w2, name="mm2")
    p = plan(g)
    assert repr(p.tensor_sbp["mm1.out"]) == "(S(0), S(1))"
    assert repr(p.tensor_sbp["relu.out"]) == "(S(0), S(1))"
    assert all(b[0] == "mm2.out" for b in p.boxings)
    assert not p.tensor_sbp["mm2.out"].has_partial


def test_planner_defers_partial_reduction():
    g = LogicalGraph(Placement(("model",), (4,)))
    u = g.input("u", (64, 128), sbp="S(1)")
    v = g.input("v", (128, 256), sbp="S(0)")
    w = g.input("w", (256, 32), sbp="B")
    g.matmul(g.matmul(u, v, name="uv"), w, name="uvw")
    p = plan(g)
    assert repr(p.tensor_sbp["uv.out"]) == "(P(sum))"
    assert all(t != "uv.out" for t, *_ in p.boxings)


def test_planner_pins_respected_and_infeasible_raises():
    g = LogicalGraph(_mk2d())
    y = g.matmul(g.input("x", (64, 64), sbp="S(0),B"),
                 g.input("w", (64, 64), sbp="B,B"))
    y.pin("B,B")
    assert repr(plan(g).tensor_sbp[y.name]) == "(B, B)"
    y.pin("P(max),B")               # matmul only ever emits P(sum)
    with pytest.raises(ValueError):
        plan(g)
    with pytest.raises(ValueError):
        LogicalGraph(_mk2d()).input("x", (64, 64), sbp="S(5),B")


def test_plan_describe_mentions_boxing():
    g = LogicalGraph(_mk2d())
    x = g.input("x", (64, 64), sbp="S(0),B")
    y1 = g.matmul(x, g.input("w1", (64, 64), sbp="B,S(1)"), name="m1")
    g.matmul(y1, g.input("w2", (64, 64), sbp="B,S(1)"), name="m2")
    p = plan(g)
    assert "SBP plan" in p.describe() and p.total_cost > 0


# ---------------------------------------------------------------------------
# The simulator and register planning (tests/test_actor_runtime.py)
# ---------------------------------------------------------------------------

class TestSimulator:
    def test_chain_and_back_pressure(self):
        specs = [
            ActorSpec("src", _noop, (), out_regs=2, max_fires=10, thread=0),
            ActorSpec("mid", lambda x: x + 1, ("src",), out_regs=2, thread=1),
            ActorSpec("sink", lambda x: x, ("mid",), out_regs=2, thread=2)]
        res = simulate(specs)
        assert not res.deadlocked
        assert res.fires == {"src": 10, "mid": 10, "sink": 10}
        for quota in (1, 2, 4):
            res = simulate([
                ActorSpec("fast", _noop, (), out_regs=quota, max_fires=50,
                          duration=0.1, thread=0),
                ActorSpec("slow", _noop, ("fast",), out_regs=1,
                          duration=1.0, thread=1)])
            assert not res.deadlocked and res.peak_regs["fast"] <= quota
            assert res.fires == {"fast": 50, "slow": 50}

    def test_zero_copy_and_multi_consumer_refcount(self):
        big = np.arange(1024)
        seen = []
        res = simulate([
            ActorSpec("p", lambda: big, (), out_regs=2, max_fires=3),
            ActorSpec("c", lambda x: seen.append(x), ("p",), out_regs=1)])
        assert not res.deadlocked and all(x is big for x in seen)
        res = simulate([
            ActorSpec("p", _noop, (), out_regs=1, max_fires=5, duration=0.1),
            ActorSpec("c_fast", _noop, ("p",), out_regs=1, duration=0.1,
                      thread=1),
            ActorSpec("c_slow", _noop, ("p",), out_regs=1, duration=2.0,
                      thread=2)])
        assert res.makespan >= 10.0
        assert res.fires == {"p": 5, "c_fast": 5, "c_slow": 5}

    def test_figure2_no_deadlock_under_contention(self):
        res = simulate([
            ActorSpec("M1", _noop, (), out_regs=1, max_fires=8, duration=0.2),
            ActorSpec("M2", _noop, (), out_regs=1, max_fires=8, duration=0.2),
            ActorSpec("O1", _noop, ("M1",), out_regs=1, duration=1.0,
                      thread=1),
            ActorSpec("O2", _noop, ("M2",), out_regs=2, duration=0.5,
                      thread=1)])
        assert not res.deadlocked
        assert res.fires["O1"] == 8 and res.fires["O2"] == 8
        assert res.peak_regs["O2"] <= 2

    def test_figure6_pipelining_overlap_and_quota_one_serializes(self):
        def mk(q1, q):
            return [ActorSpec("a1", _noop, (), out_regs=q1, max_fires=12,
                              duration=1.0, thread=0),
                    ActorSpec("a2", _noop, ("a1",), out_regs=q, duration=1.0,
                              thread=1),
                    ActorSpec("a3", _noop, ("a2",), out_regs=q, duration=1.0,
                              thread=2)]
        comm = CommModel(same_node=0.0)
        res = simulate(mk(3, 2), comm=comm)
        assert not res.deadlocked and res.makespan <= 15.0 + 1e-6

        def busy_at(name, t):
            return any(s <= t < e for s, e in res.history[name])
        assert any(all(busy_at(a, t) for a in ("a1", "a2", "a3"))
                   for t in np.arange(0, res.makespan, 0.5))
        assert (simulate(mk(2, 2), comm=comm).makespan
                < simulate(mk(1, 1), comm=comm).makespan)


class TestPipelineSchedules:
    def test_1f1b_memory_vs_gpipe(self):
        S, M = 4, 16
        gpipe = analyze(S, M, regs=[M] * S)
        onef1b = analyze(S, M, regs=[S] * S)
        assert onef1b.makespan <= gpipe.makespan * 1.05
        assert max(onef1b.peak_activation_regs.values()) <= S
        assert max(gpipe.peak_activation_regs.values()) >= M - 2

    def test_planner_picks_small_quota_and_more_never_hurts(self):
        p = plan_registers(num_stages=4, num_microbatches=16)
        assert max(p.regs) <= 8 and p.bubble_fraction < 0.35
        spans = [analyze(3, 12, regs=[r] * 3).makespan for r in (1, 2, 3, 6)]
        assert all(a >= b - 1e-9 for a, b in zip(spans, spans[1:]))

    def test_zero_quota_rejected(self):
        with pytest.raises(ValueError, match=r"stage 1 .* got 0"):
            pipeline_specs(3, 8, regs=[2, 0, 1])
        with pytest.raises(ValueError, match=r"stage 0 .* got -1"):
            pipeline_specs(2, 8, regs=[-1, 1])


# ---------------------------------------------------------------------------
# Properties (tests/test_property_sbp.py, tests/test_property_actor.py)
# ---------------------------------------------------------------------------

COMPONENTS = [Split(0), Split(1), Broadcast(), Partial("sum")]
MESHES = [(2,), (4,), (2, 2), (2, 4), (4, 4), (2, 2, 2)]


def _hypothesis():
    hyp = pytest.importorskip(
        "hypothesis",
        reason="property tests need hypothesis (see requirements-dev.txt)")
    st = hyp.strategies

    @st.composite
    def ndsbp_mesh(draw):
        mesh = draw(st.sampled_from(MESHES))
        return NdSbp(tuple(draw(st.sampled_from(COMPONENTS))
                           for _ in mesh)), mesh
    return hyp, st, ndsbp_mesh


def test_property_sbp_costs_and_shapes():
    hyp, st, ndsbp_mesh = _hypothesis()

    @hyp.settings(max_examples=60, deadline=None)
    @hyp.given(ndsbp_mesh())
    def check(sm):
        sig, mesh = sm
        shape = (16, 32)
        local = sig.local_shape(shape, mesh)
        copies = math.prod(s for c, s in zip(sig, mesh) if not c.is_split)
        assert math.prod(local) * math.prod(mesh) == math.prod(shape) * copies
        for dst in COMPONENTS:
            for k in range(len(mesh)):
                c = transition_cost(sig[k], dst, 4096.0, mesh[k])
                assert c.volume >= 0 and (sig[k] != dst or c.volume == 0)
        assert nd_transition_cost(sig, sig, 8192.0, mesh) == 0.0
        b = NdSbp.broadcast(len(mesh))
        c1 = nd_transition_cost(sig, b, 1000.0, mesh)
        assert abs(nd_transition_cost(sig, b, 2000.0, mesh) - 2 * c1) < 1e-6
    check()

    @hyp.given(st.integers(2, 16), st.integers(1, 1 << 20))
    def allreduce(p, nbytes):
        ar = transition_cost(Partial("sum"), Broadcast(), float(nbytes), p)
        rs = transition_cost(Partial("sum"), Split(0), float(nbytes), p)
        ag = transition_cost(Split(0), Broadcast(), float(nbytes), p)
        assert abs(ar.volume - (rs.volume + ag.volume)) < 1e-9
    allreduce()


def test_property_actor_protocol():
    hyp, st, _ = _hypothesis()

    @st.composite
    def layered_dag(draw):
        widths = [draw(st.integers(1, 3))
                  for _ in range(draw(st.integers(2, 4)))]
        batches = draw(st.integers(1, 12))
        specs, prev, tid = [], [], 0
        for li, w in enumerate(widths):
            names = []
            for i in range(w):
                inputs = ()
                if li:
                    k = draw(st.integers(1, len(prev)))
                    inputs = tuple(draw(st.permutations(prev))[:k])
                specs.append(ActorSpec(
                    f"a{li}_{i}", _noop, inputs,
                    out_regs=draw(st.integers(1, 3)),
                    duration=draw(st.sampled_from([0.1, 0.5, 1.0])),
                    thread=tid % 8, max_fires=batches if li == 0 else None))
                names.append(f"a{li}_{i}")
                tid += 1
            prev = names
        return specs, batches

    @hyp.settings(max_examples=40, deadline=None)
    @hyp.given(layered_dag(), st.floats(0.0, 0.01))
    def check(sd, lat):
        specs, batches = sd
        res = simulate(specs)
        assert not res.deadlocked
        for s in specs:
            assert res.fires[s.name] == batches
            assert res.peak_regs[s.name] <= s.out_regs
        slow = simulate(specs, comm=CommModel(same_node=lat))
        fast = simulate(specs, comm=CommModel(same_node=0.0))
        assert slow.makespan >= fast.makespan - 1e-9
    check()


# ---------------------------------------------------------------------------
# Plans, partitions and quotas equal the reference's
# ---------------------------------------------------------------------------

PLACEMENTS = [(("d",), (1,)), (("model",), (4,)),
              (("data", "model"), (2, 4))]


def _graph(G, P, kind, names, sizes):
    """One graph, built the same way from either package's classes, with
    every op named (auto-names count per package)."""
    g = G(P(names, sizes))
    nd = len(sizes)
    if kind == "mlp":
        h = g.input("x", (64, 32), sbp=",".join(["S(0)"] * nd))
        for i in range(3):
            h = g.unary(g.matmul(h, g.input(f"w{i}", (32, 32)), name=f"mm{i}"),
                        "relu", name=f"act{i}")
        g.reduce(h, axis=1, name="red")
    elif kind == "lm":
        ids = g.input("ids", (64,), dtype="int32")
        labels = g.input("labels", (64,), dtype="int32")
        h = g.embedding(g.input("E", (128, 32)), ids, name="emb")
        a = g.unary(g.matmul(h, g.input("w1", (32, 64)), name="up"), "gelu",
                    name="act")
        r = g.add(g.matmul(a, g.input("w2", (64, 32)), name="down"), h,
                  name="res")
        g.softmax_xent(g.matmul(r, g.input("wo", (32, 128)), name="head"),
                       labels, name="loss")
    elif kind == "pinned":
        x = g.input("x", (64, 128), sbp=",".join(["S(0)"] + ["B"] * (nd - 1)))
        w = g.input("w", (128, 64), sbp=",".join(["B"] * (nd - 1) + ["S(1)"]))
        b = g.input("b", (64,))
        y = g.bias_add(g.matmul(x, w, name="mm"), b, name="bias")
        g.softmax(g.unary(y, "tanh", name="th"), name="sm")
    return g


def _plan_view(p):
    return (sorted((k, repr(v)) for k, v in p.tensor_sbp.items()),
            sorted((k, repr(v)) for k, v in p.op_in_sbp.items()),
            sorted((k, repr(v)) for k, v in p.op_out_sbp.items()),
            [(t, o, repr(s), repr(d), c) for t, o, s, d, c in p.boxings],
            p.total_cost)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from repro.core import graph as rgraph, placement as rplace, planner
    from repro.runtime import pipeline as rpipe
    return rgraph, rplace, planner, rpipe


@pytest.mark.parametrize("kind", ["mlp", "lm", "pinned"])
@pytest.mark.parametrize("names,sizes", PLACEMENTS)
def test_plan_equals_reference(ref, kind, names, sizes):
    rgraph, rplace, rplanner, _ = ref
    gt = _graph(LogicalGraph, Placement, kind, names, sizes)
    gr = _graph(rgraph.LogicalGraph, rplace.Placement, kind, names, sizes)
    assert _plan_view(plan(gt)) == _plan_view(rplanner.plan(gr))
    assert plan(gt).describe() == rplanner.plan(gr).describe()


@pytest.mark.parametrize("kind", ["mlp", "lm", "pinned"])
def test_partition_equals_reference(ref, kind):
    rgraph, rplace, _, _ = ref
    gt = _graph(LogicalGraph, Placement, kind, ("d",), (1,))
    gr = _graph(rgraph.LogicalGraph, rplace.Placement, kind, ("d",), (1,))
    for n in range(1, len(gt.ops) + 1):
        pt, pr = partition_stages(gt, n), rgraph.partition_stages(gr, n)
        assert pt.stage_of == pr.stage_of and pt.num_stages == pr.num_stages
        assert pt.describe(gt, [1] * n) == pr.describe(gr, [1] * n)


@pytest.mark.parametrize("S,M", [(1, 1), (2, 4), (3, 6), (4, 8), (4, 16)])
def test_register_planning_equals_reference(ref, S, M):
    rpipe = ref[3]
    for bwd in (2.0, 1e-3):
        a = plan_registers(S, M, fwd_time=1.0, bwd_time=bwd)
        b = rpipe.plan_registers(S, M, fwd_time=1.0, bwd_time=bwd)
        assert (a.regs, a.makespan, a.peak_activation_regs,
                a.bubble_fraction) == (b.regs, b.makespan,
                                       b.peak_activation_regs,
                                       b.bubble_fraction)
    one = [max(1, S - s) for s in range(S)]
    a, b = analyze(S, M, one), rpipe.analyze(S, M, one)
    assert (a.makespan, a.peak_activation_regs) == (
        b.makespan, b.peak_activation_regs)


def test_bad_quota_message_equals_reference(ref):
    rpipe = ref[3]
    msgs = []
    for mod in (rpipe, None):
        fn = rpipe.pipeline_specs if mod else pipeline_specs
        with pytest.raises(ValueError) as e:
            fn(3, 8, regs=[2, 0, 1])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
