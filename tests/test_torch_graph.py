"""Graph mode, inference: staged lowering, the actor pipeline, the
``Session`` frontend, and what is not ported yet.

Mirrors ``tests/test_actor_pipeline.py`` and the graph half of
``tests/test_api.py`` on ``repro_torch`` (``device="cpu"``). Gates:

* actors ≡ monolithic, bitwise, within the port (the monolithic engine
  chunks the batch exactly as the actors do);
* the port's ``compile(graph, mode="infer")`` against the JAX package's on
  the same inputs, ``rtol=1e-5, atol=1e-6`` (float32; importorskip jax);
* serving's ``regs="serial"``, ``"gpipe"`` and explicit quotas give the
  default's tokens;
* ``mesh=`` and ``stage_meshes=`` run on several ranks; every option that
  is not ported raises naming its ROADMAP item.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.graph import LogicalGraph, op_cost, partition_stages
from repro_torch.core.lowering import (OptimizerSpec, PrecisionPolicy,
                                       lower_plan, lower_stages)
from repro_torch.core.placement import Placement
from repro_torch.core.planner import plan
from repro_torch.runtime.actor import ActorSpec
from repro_torch.runtime.pipeline import ActorPipelineExecutor
from repro_torch.runtime.threaded import ThreadedRuntime

CPU = "cpu"
S, M = 4, 4


def _placement():
    return Placement(("d",), (1,))


def _mlp_graph(depth=4, batch=32, width=64):
    g = LogicalGraph(_placement())
    h = g.input("x", (batch, width))
    for i in range(depth):
        h = g.unary(g.matmul(h, g.input(f"w{i}", (width, width)),
                             name=f"mm{i}"), "relu", name=f"relu{i}")
    return g


def _all_ops_graph(G=LogicalGraph, P=Placement, N=16, V=48, D=16):
    """Every op kind the graph layer has, with a residual that crosses the
    stage boundary: embedding, matmul, gelu, add, bias_add, softmax, reduce,
    softmax_xent."""
    g = G(P(("d",), (1,)))
    ids = g.input("ids", (N,), dtype="int32")
    labels = g.input("labels", (N,), dtype="int32")
    E = g.input("E", (V, D))
    w1, b1 = g.input("w1", (D, 2 * D)), g.input("b1", (2 * D,))
    w2, wo = g.input("w2", (2 * D, D)), g.input("wo", (D, V))
    with g.stage(0):
        h = g.embedding(E, ids, name="emb")
        a = g.unary(g.bias_add(g.matmul(h, w1, name="up"), b1, name="bias"),
                    "gelu", name="act")
    with g.stage(1):
        r = g.add(g.matmul(a, w2, name="down"), h, name="res")
        lg = g.matmul(r, wo, name="head")
        g.softmax_xent(lg, labels, name="loss")
        g.reduce(g.softmax(lg, name="probs"), axis=1, op="max", name="pmax")
    return g


def _inputs(g, seed=0, V=48):
    rng = np.random.default_rng(seed)
    out = {}
    for t in g.inputs:
        if t.dtype == "int32":
            out[t.name] = rng.integers(0, V, size=t.shape).astype(np.int32)
        else:
            out[t.name] = (rng.normal(size=t.shape) * 0.3).astype(np.float32)
    return out


def _eq(a, b):
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


# ---------------------------------------------------------------------------
# Stage partition (tests/test_actor_pipeline.py)
# ---------------------------------------------------------------------------

class TestStagePartition:
    def test_balanced_partition_is_contiguous_monotone_and_balanced(self):
        g = _mlp_graph(depth=6)
        part = partition_stages(g, num_stages=3)
        stages = [part.stage_of[op.name] for op in g.topo_ops()]
        assert stages == sorted(stages) and set(stages) == {0, 1, 2}
        g = _mlp_graph(depth=8)
        part = partition_stages(g, num_stages=4)
        costs = [sum(op_cost(op) for op in part.ops_in(g, s))
                 for s in range(4)]
        assert max(costs) <= 2.0 * min(costs)

    def test_backloaded_costs_keep_trailing_stages_non_empty(self):
        g = LogicalGraph(_placement())
        h = g.unary(g.unary(g.input("x", (4, 4)), "relu", name="cheap0"),
                    "relu", name="cheap1")
        g.matmul(h, g.input("w", (4, 4096)), name="huge")
        assert partition_stages(g, num_stages=3).stage_of == {
            "cheap0": 0, "cheap1": 1, "huge": 2}

    def test_annotations_respected_and_bad_ones_rejected(self):
        def build(s0, s1, annotate_second=True):
            g = LogicalGraph(_placement())
            x = g.input("x", (8, 16))
            with g.stage(s0):
                h = g.matmul(x, g.input("w0", (16, 16)), name="a")
            if annotate_second:
                with g.stage(s1):
                    g.matmul(h, g.input("w1", (16, 16)), name="b")
            else:
                g.matmul(h, g.input("w1", (16, 16)), name="b")
            return g
        assert partition_stages(build(0, 1)).stage_of == {"a": 0, "b": 1}
        with pytest.raises(ValueError, match="non-monotone"):
            partition_stages(build(1, 0))
        with pytest.raises(ValueError, match="mixed stage annotation"):
            partition_stages(build(0, 0, annotate_second=False))


# ---------------------------------------------------------------------------
# Staged lowering and the actor executor
# ---------------------------------------------------------------------------

class TestStagedLowering:
    def test_staged_equals_monolithic_bitwise(self):
        g = _mlp_graph()
        p = plan(g)
        mono = lower_plan(g, p, device=CPU)
        staged = lower_stages(g, p, partition_stages(g, 4), device=CPU)
        inputs = _inputs(g)
        args = [inputs[t.name] for t in g.inputs]
        a, b = mono(*args), staged(*args)
        assert isinstance(a, tuple) and len(a) == len(b) == 1
        assert _eq(a[0], b[0])

    def test_every_op_kind_against_plain_torch(self):
        g = _all_ops_graph()
        x = _inputs(g)
        out = dict(zip([t.name for t in g.sinks()],
                       lower_plan(g, plan(g), device=CPU)(
                           *[x[t.name] for t in g.inputs])))
        t = {n: torch.as_tensor(v) for n, v in x.items()}
        h = t["E"][t["ids"].long()]
        a = torch.nn.functional.gelu(h @ t["w1"] + t["b1"], approximate="tanh")
        lg = a @ t["w2"] + h
        lg = lg @ t["wo"]
        want = (torch.logsumexp(lg, 1)
                - lg.gather(1, t["labels"].long()[:, None])[:, 0])
        torch.testing.assert_close(out["loss.out"][:, 0], want,
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(out["pmax.out"][:, 0],
                                   torch.softmax(lg, 1).amax(1),
                                   rtol=1e-5, atol=1e-6)


class TestActorPipelineExecutor:
    def test_actor_execution_bitwise_equals_monolithic_engine(self):
        g = _mlp_graph(batch=32)
        inputs = _inputs(g)
        a = api.compile(g, stages=4, num_microbatches=4,
                        microbatch_inputs=["x"], device=CPU)
        m = api.compile(g, backend="monolithic", num_microbatches=4,
                        microbatch_inputs=["x"], device=CPU)
        api.assert_sessions_match(a, m, inputs)
        assert all(len(h) == 4 for n, h in a.executor.last_history.items()
                   if n.startswith("stage"))

    def test_register_quota_bounds_in_flight_microbatches(self):
        g = _mlp_graph(batch=32)
        staged = lower_stages(g, plan(g), partition_stages(g, 4), device=CPU)
        for quota in (1, 2):
            ex = ActorPipelineExecutor(staged, ["x"], num_microbatches=8,
                                       regs=[quota] * 4)
            ex.run(_inputs(g))
            assert all(ex.last_peak_regs[f"stage{s}"] <= quota
                       for s in range(4))

    @pytest.mark.parametrize("which", ["mid_graph_sink", "weights_only_sink",
                                       "all_ops"])
    def test_sinks_reassemble_as_the_monolithic_engine(self, which):
        g = LogicalGraph(_placement())
        if which == "all_ops":
            g = _all_ops_graph()
            mb = ["ids", "labels"]
        else:
            x, w0 = g.input("x", (16, 32)), g.input("w0", (32, 32))
            mb = ["x"]
            with g.stage(0):
                h = g.matmul(x, w0, name="mm0")
            with g.stage(1):
                g.unary(h, "relu", name="early_sink")
                if which == "weights_only_sink":
                    g.unary(w0, "tanh", name="w_sink")
                else:
                    h2 = g.matmul(h, g.input("w1", (32, 32)), name="mm1")
            if which == "mid_graph_sink":
                with g.stage(2):
                    g.unary(h2, "tanh", name="late_sink")
        inputs = _inputs(g)
        a = api.compile(g, num_microbatches=2, microbatch_inputs=mb,
                        device=CPU)
        m = api.compile(g, backend="monolithic", num_microbatches=2,
                        microbatch_inputs=mb, device=CPU)
        ra, rm = a.run(**inputs), m.run(**inputs)
        assert list(ra) == [t.name for t in g.sinks()]
        for n in ra:
            assert ra[n].shape == rm[n].shape and _eq(ra[n], rm[n]), n
        if which == "weights_only_sink":
            assert ra["w_sink.out"].shape == (32, 32)

    def test_zero_consumer_actor_recycles_immediately(self):
        rt = ThreadedRuntime([ActorSpec("lonely", lambda version: version, (),
                                        out_regs=2, max_fires=5,
                                        wants_version=True)],
                             collect_outputs_of="lonely")
        assert rt.run(timeout=10.0) == [0, 1, 2, 3, 4]
        a = rt.by_name["lonely"]
        assert a.fired == 5 and a.out_counter == 2 and not a.refcount


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["actors", "monolithic"])
def test_infer_matches_jax_session(backend):
    pytest.importorskip("jax")
    from repro import api as japi
    from repro.core.graph import LogicalGraph as JG
    from repro.core.placement import Placement as JP

    gj, gt = _all_ops_graph(JG, JP), _all_ops_graph()
    inputs = _inputs(gt)
    kw = dict(backend=backend, num_microbatches=2,
              microbatch_inputs=["ids", "labels"])
    want = japi.compile(gj, mode="infer", check="off", **kw).run(**inputs)
    got = api.compile(gt, mode="infer", device=CPU, **kw).run(**inputs)
    assert list(got) == list(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


# ---------------------------------------------------------------------------
# The Session frontend (tests/test_api.py, graph half)
# ---------------------------------------------------------------------------

def _train_graph(batch=16, width=32, depth=S, placement=None):
    g = LogicalGraph(placement or _placement())
    h = g.input("x", (batch, width))
    labels = g.input("labels", (batch,), dtype="int32")
    for i in range(depth):
        h = g.matmul(h, g.input(f"w{i}", (width, width)), name=f"mm{i}")
        if i < depth - 1:
            h = g.unary(h, "relu", name=f"relu{i}")
    g.softmax_xent(h, labels, name="loss")
    return g


def _params_and_data(g, seed=0):
    x = _inputs(g, seed, V=32)
    return ({n: v * 0.3 for n, v in x.items() if n.startswith("w")},
            {n: v for n, v in x.items() if not n.startswith("w")})


class TestOptionInference:
    def test_omitted_options_match_explicit(self):
        g = _train_graph()
        params, data = _params_and_data(g)
        auto = api.compile(g, mode="train", stages=S, params=params,
                           num_microbatches=M, device=CPU)
        explicit = api.compile(
            g, mode="train", params=params, num_microbatches=M,
            plan=plan(g), partition=partition_stages(g, S),
            regs=list(auto.regs), microbatch_inputs=["x", "labels"],
            device=CPU)
        assert auto.partition.stage_of == explicit.partition.stage_of
        assert auto.regs == explicit.regs == auto.reg_plan.regs
        assert auto.microbatch_inputs == ["x", "labels"]
        api.assert_sessions_match(auto, explicit, data, steps=2)

    def test_reg_policies(self):
        g = _train_graph()
        params, _ = _params_and_data(g)
        for policy, want in (("1f1b", [S - s for s in range(S)]),
                             ("gpipe", [M] * S), ("serial", [1] * S)):
            sess = api.compile(g, mode="train", stages=S, params=params,
                               num_microbatches=M, regs=policy, device=CPU)
            assert sess.regs == want, policy
        with pytest.raises(ValueError, match="regs policy"):
            api.compile(g, mode="train", stages=S, params=params,
                        num_microbatches=M, regs="zigzag", device=CPU)

    def test_annotations_sugar_and_describe(self):
        g = _all_ops_graph()
        assert api.compile(g, device=CPU).partition.num_stages == 2
        sess = g.compile(mode="infer", backend="monolithic", device=CPU)
        assert set(sess.run(**_inputs(g))) == {"loss.out", "pmax.out"}
        assert "no stage partition" in sess.describe()
        g = _train_graph()
        params, _ = _params_and_data(g)
        rep = api.compile(g, mode="train", stages=S, params=params,
                          num_microbatches=M, regs="1f1b",
                          device=CPU).describe()
        assert "stage partition" in rep and "SBP plan" in rep
        assert "regs=4" in rep and "regs=1" in rep
        assert "optimizer: sgd" in rep and "device=cpu" in rep


class TestCompileValidation:
    @pytest.mark.parametrize("kw,match", [
        (dict(mode="infer", optimizer=OptimizerSpec.sgd()), "optimizer"),
        (dict(mode="infer", params={"w0": 0}), "params"),
        (dict(mode="infer", loss="loss.out"), "loss"),
        (dict(mode="train"), "params"),
        (dict(mode="bogus"), "mode"),
        (dict(mode="infer", backend="xla"), "backend"),
        (dict(mode="infer", num_microbatches=4), "microbatch_inputs"),
        (dict(mode="infer", num_groups=2), "only meaningful for mode='serve'"),
        (dict(mode="train", params={"w_typo": 0}), "w_typo"),
    ])
    def test_bad_options_raise(self, kw, match):
        with pytest.raises(ValueError, match=match):
            api.compile(_train_graph(), device=CPU, **kw)

    def test_partition_contradiction_and_mode_mismatch(self):
        g = _train_graph()
        params, data = _params_and_data(g)
        with pytest.raises(ValueError, match="contradicts"):
            api.compile(g, mode="train", params=params, device=CPU,
                        partition=partition_stages(g, 4), stages=2)
        train = api.compile(g, mode="train", stages=S, params=params,
                            num_microbatches=M, device=CPU)
        infer = api.compile(g, backend="monolithic", stages=S, regs="1f1b",
                            device=CPU)
        assert infer.partition is None and infer.regs is None
        with pytest.raises(RuntimeError, match="step"):
            train.run(**data)
        with pytest.raises(RuntimeError, match="run"):
            infer.step(x=data["x"])

    @pytest.mark.parametrize("backend", ["actors", "monolithic"])
    def test_run_and_step_input_names(self, backend):
        g = _train_graph()
        params, data = _params_and_data(g)
        kw = {"stages": S} if backend == "actors" else {}
        sess = api.compile(g, mode="train", backend=backend, params=params,
                           num_microbatches=M, device=CPU, **kw)
        with pytest.raises(ValueError, match="'junk'"):
            sess.step(**data, junk=data["x"])
        with pytest.raises(ValueError, match="'labels'"):
            sess.step(x=data["x"])
        with pytest.raises(ValueError, match="'w0'.*owned by the executor"):
            sess.step(**data, w0=params["w0"])
        inf = api.compile(g, backend=backend, num_microbatches=M,
                          microbatch_inputs=["x", "labels"], device=CPU, **kw)
        with pytest.raises(ValueError, match="'w9'"):
            inf.run(**params, **data, w9=params["w0"])
        with pytest.raises(ValueError, match="'x'"):
            inf.run(**params)

    def test_entry_points_default_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: device=None runs there")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.compile(_train_graph())


def _two_ranks():
    return Placement(("d",), (2,))


class TestNotPorted:
    """Every option the port does not take yet raises naming its item; the
    meshes of item 8 run (two ranks on the CPU), and so do item 9's ZeRO
    and mixed precision (``tests/test_torch_mixed_precision.py`` holds them
    to the JAX package) and item 10's snapshots, restore and faults, which
    hold the reference's option checks here
    (``tests/test_torch_fault_tolerance.py`` runs them)."""

    #: item 10's options, each with what makes the reference reject it
    ITEM10 = {
        "snapshot_dir": (dict(backend="monolithic"), ValueError,
                         "snapshot_dir= requires backend='actors'"),
        "snapshot_every": ({}, ValueError,
                           "snapshot_every= without snapshot_dir="),
        "restore": ({}, FileNotFoundError, "no completed snapshot"),
        "faults": (dict(backend="monolithic"), ValueError,
                   "faults= requires backend='actors'"),
    }

    @pytest.mark.parametrize("kw,item", [
        (dict(zero=True), "item 9"),
        (dict(precision="bf16"), "item 9"),
        (dict(loss_scale=1024.0), "item 9"),
        (dict(snapshot_dir="snap"), "item 10"),
        (dict(snapshot_every=2), "item 10"),
        (dict(restore="snap"), "item 10"),
        (dict(faults=object()), "item 10"),
        (dict(runtime="processes"), "item 11"),
        (dict(check="static"), "item 12"),
        (dict(fn_wrap=lambda s, f: f), "item 14"),
        (dict(stage_meshes=[_two_ranks().to_mesh(CPU) for _ in range(2)]),
         "item 8"),
        (dict(mesh=_two_ranks().to_mesh(CPU)), "item 8"),
    ])
    def test_graph_options(self, kw, item):
        if item == "item 9":
            self._item9_runs(kw)
            return
        if item == "item 10":
            (name,) = kw
            extra, exc, match = self.ITEM10[name]
            g = _train_graph()
            params, _ = _params_and_data(g)
            with pytest.raises(exc, match=match):
                api.compile(g, mode="train", params=params, stages=2,
                            device=CPU, **kw, **extra)
            return
        if item != "item 8":
            g = _train_graph()
            params, _ = _params_and_data(g)
            with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
                api.compile(g, mode="train", params=params, stages=2,
                            device=CPU, **kw)
            return
        # a mesh given, or one per stage (the relay between them): the same
        # bits as the default mesh of the placement's ranks, and the
        # one-device losses
        g = _train_graph(placement=_two_ranks())
        params, data = _params_and_data(g)
        sess = api.compile(g, mode="train", params=params, stages=2,
                           device=CPU, **kw)
        ref = api.compile(g, mode="train", params=params, stages=2,
                          device=CPU)
        assert sess.meshes[0].size == 2
        api.assert_sessions_match(sess, ref, data, steps=2)
        one = api.compile(_train_graph(), mode="train", params=params,
                          stages=2, device=CPU)
        for r, o in zip(sess.history, (one.step(**data), one.step(**data))):
            assert abs(r["loss"] - float(o.loss)) <= 1e-5 * abs(r["loss"])

    @staticmethod
    def _item9_runs(kw):
        """``zero=True`` runs and equals ``zero=False`` bitwise (AdamW, whose
        state it shards); ``precision="bf16"`` runs, its loss off float32's;
        ``loss_scale=`` alone raises the reference's ValueError."""
        g = _train_graph()
        params, data = _params_and_data(g)
        common = dict(mode="train", params=params, stages=2, device=CPU,
                      optimizer=OptimizerSpec.adamw(lr=1e-3))
        if "loss_scale" in kw:
            with pytest.raises(ValueError, match="without precision="):
                api.compile(g, **common, **kw)
            return
        sess = api.compile(g, **common, **kw)
        ref = api.compile(g, **common)
        if "zero" in kw:
            assert sess.optimizer.zero and sess.optimizer.zero_dp == 1
            api.assert_sessions_match(sess, ref, data, steps=2)
            return
        assert sess.optimizer.compute_dtype == "bfloat16"
        lb, lf = sess.step(**data).loss, ref.step(**data).loss
        assert torch.isfinite(lb) and float(lb) != float(lf)

    def test_defaults_are_accepted_and_unknown_options_are_type_errors(self):
        g = _train_graph()
        api.compile(g, backend="monolithic", zero=False, snapshot_every=1,
                    fn_wrap=None, device=CPU)
        with pytest.raises(TypeError, match="bogus"):
            api.compile(g, bogus=1, device=CPU)

    def test_multi_device_placement(self):
        g = LogicalGraph(Placement(("data",), (4,)))
        g.matmul(g.input("x", (8, 8)), g.input("w", (8, 8)), name="mm")
        assert plan(g).total_cost == 0          # planning takes any mesh
        x = _inputs(g)
        outs = []
        for backend in ("actors", "monolithic"):
            sess = api.compile(g, backend=backend, stages=1, device=CPU)
            assert sess.meshes[0].size == 4
            outs.append(sess.run(**x)["mm.out"])
        assert _eq(outs[0], outs[1])
        torch.testing.assert_close(outs[0], torch.as_tensor(x["x"] @ x["w"]),
                                   rtol=1e-5, atol=1e-6)

    def test_precision_and_zero_fields(self):
        """The reference's validation (``repro/core/lowering.py:504-513``,
        ``:565-579``)."""
        assert PrecisionPolicy("float32").compute_dtype == "float32"
        assert PrecisionPolicy().compute_dtype == "bfloat16"
        for bad in (dict(compute_dtype="float16"), dict(loss_scale=-1.0),
                    dict(loss_scale="sometimes"), dict(growth_interval=0)):
            with pytest.raises(ValueError):
                PrecisionPolicy(**bad)
        with pytest.raises(ValueError, match="kind='adamw'"):
            OptimizerSpec(kind="sgd", zero=True)
        with pytest.raises(ValueError, match="zero_dp"):
            OptimizerSpec(kind="adamw", zero=True, zero_dp=0)
        with pytest.raises(ValueError, match="bfloat16"):
            OptimizerSpec(kind="adamw", precision=PrecisionPolicy(
                "float32", loss_scale="dynamic"))
        spec = OptimizerSpec(kind="adamw", zero=True)
        assert spec.mixed_precision and spec.compute_dtype == "float32"
        assert spec.loss_scaling is None and spec.initial_scale() == 1.0
        with pytest.raises(ValueError, match="zero_shapes"):
            spec.zero_shape_map


# ---------------------------------------------------------------------------
# Serving's register quotas
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_cfg():
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                               vocab_size=1000)


def test_serve_reg_policies_keep_tokens(serve_cfg):
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.common import MeshPlan

    state = build_model(serve_cfg, MeshPlan.single_device(), seed=0,
                        device=CPU).state_dict()
    geo = dict(num_groups=2, group_size=1, max_prompt_len=8,
               max_new_tokens=6, cache_len=24)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 1000, (8,)).astype(np.int32), n)
            for n in (3, 6, 2, 5)]
    toks = {}
    for regs, want in ((None, [2, 1]), ("serial", [1, 1]),
                       ("gpipe", [2, 2]), ("1f1b", [2, 1]), ([3, 1], [3, 1])):
        with api.compile(serve_cfg, mode="serve", stages=2, regs=regs,
                         params=state, device=CPU, **geo) as sess:
            assert sess.regs == want
            toks[str(regs)] = sess.generate(reqs)
            assert all(sess._engine.last_peak_regs[f"stage{s}"] <= want[s]
                       for s in range(2))
    mono = api.compile(serve_cfg, mode="serve", backend="monolithic",
                       params=state, device=CPU, **geo).generate(reqs)
    for k, v in toks.items():
        assert all(np.array_equal(a, b) for a, b in zip(v, mono)), k
    with pytest.raises(ValueError, match="register quotas"):
        api.compile(serve_cfg, mode="serve", stages=2, regs=[1],
                    params=state, device=CPU, **geo)
