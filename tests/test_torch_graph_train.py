"""Graph mode, training: the 1F1B pipeline of fwd/bwd/acc/opt actors.

Mirrors ``tests/test_1f1b_train.py`` and ``tests/test_adamw_pipeline.py`` on
``repro_torch`` (``device="cpu"``). Gates:

* actors ≡ monolithic, bitwise, over three steps, for SGD and for AdamW
  with global-norm clipping -- losses, post-clip gradients, params and
  optimizer state -- also with a residual that crosses a stage boundary;
* peak in-flight forward registers within the quota (1 when serialized,
  ``S - s`` under 1F1B); optimizer actors fire once a step;
* the port against the JAX ``Session`` over three AdamW steps on a graph
  with an embedding, a residual across a stage boundary and
  ``softmax_xent``, at ``tests/test_torch_train.py``'s tolerances: loss
  1e-5 relative, grads ``rtol=1e-4, atol=1e-6``, params ``rtol=1e-4,
  atol=1e-5`` (importorskip jax).
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.graph import LogicalGraph, partition_stages
from repro_torch.core.lowering import (OptimizerSpec, lower_train_stages,
                                       split_microbatches)
from repro_torch.core.placement import Placement
from repro_torch.core.planner import plan
from repro_torch.runtime.actor import ActorSpec
from repro_torch.runtime.pipeline import TrainPipelineExecutor
from repro_torch.runtime.threaded import ThreadedRuntime
from repro_torch.train.steps import (make_graph_train_step,
                                     make_pipeline_train_step)

CPU = "cpu"
B, W, DEPTH = 16, 32, 4
MB = ["x", "labels"]


def _placement(P=Placement):
    return P(("d",), (1,))


def _train_graph(depth=DEPTH, batch=B, width=W):
    g = LogicalGraph(_placement())
    h = g.input("x", (batch, width))
    labels = g.input("labels", (batch,), dtype="int32")
    for i in range(depth):
        h = g.matmul(h, g.input(f"w{i}", (width, width)), name=f"mm{i}")
        if i < depth - 1:
            h = g.unary(h, "relu", name=f"relu{i}")
    g.softmax_xent(h, labels, name="loss")
    return g


def _params_and_data(g, seed=0, w_scale=0.1, n_classes=W):
    rng = np.random.default_rng(seed)
    params, data = {}, {}
    for t in g.inputs:
        if t.name.startswith("w") or t.name in ("E", "b1"):
            params[t.name] = (rng.normal(size=t.shape) * w_scale
                              ).astype(np.float32)
        elif t.dtype == "int32":
            data[t.name] = rng.integers(0, n_classes, t.shape).astype(np.int32)
        else:
            data[t.name] = rng.normal(size=t.shape).astype(np.float32)
    return params, data


def _lm_graph(G=LogicalGraph, P=Placement, N=16, V=64, D=16, F=32):
    """Embedding, a residual straddling the stage boundary (``h`` feeds
    ``res`` in stage 1 and ``up`` in stage 0), and softmax_xent."""
    g = G(_placement(P))
    ids = g.input("ids", (N,), dtype="int32")
    labels = g.input("labels", (N,), dtype="int32")
    E, w1 = g.input("E", (V, D)), g.input("w1", (D, F))
    b1, w2 = g.input("b1", (F,)), g.input("w2", (F, D))
    wo = g.input("wo", (D, V))
    with g.stage(0):
        h = g.embedding(E, ids, name="emb")
        a = g.unary(g.bias_add(g.matmul(h, w1, name="up"), b1, name="bias"),
                    "gelu", name="act")
    with g.stage(1):
        r = g.add(g.matmul(a, w2, name="down"), h, name="res")
        g.softmax_xent(g.matmul(r, wo, name="head"), labels, name="loss")
    return g


def _eq(a, b):
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def _sessions(g, params, opt, stages=4, regs="1f1b", M=4, mb=None):
    kw = dict(mode="train", params=params, num_microbatches=M,
              optimizer=opt, device=CPU, microbatch_inputs=mb)
    return (api.compile(g, backend="actors", stages=stages, regs=regs, **kw),
            api.compile(g, backend="monolithic", **kw))


# ---------------------------------------------------------------------------
# Bit identity within the port
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": OptimizerSpec.sgd(lr=1e-2),
    "sgd_clip": OptimizerSpec.sgd(lr=1e-2, grad_clip=1.0),
    "adamw_clip_schedule": OptimizerSpec.adamw(
        lr=lambda step: 1e-3 * (0.5 ** step), grad_clip=0.5),
    "adamw_unclipped": OptimizerSpec.adamw(lr=1e-3, grad_clip=0.0),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
@pytest.mark.parametrize("regs", ["1f1b", "serial", None])
def test_actors_match_monolithic_over_three_steps(name, regs):
    g = _train_graph()
    params, data = _params_and_data(g, w_scale=0.5)
    opt = OPTIMIZERS[name]
    a, m = _sessions(g, params, opt, regs=regs)
    for step in range(3):
        ra, rm = a.step(**data), m.step(**data)
        assert _eq(ra.loss, rm.loss), step
        for n in params:
            assert ra.grads[n].dtype == torch.float32
            assert _eq(ra.grads[n], rm.grads[n]), (n, step)
            assert _eq(ra.params[n], rm.params[n]), (n, step)
        if opt.grad_clip:
            assert float(a.executor.last_grad_norm) == float(
                m.executor.last_grad_norm)
            assert float(a.executor.last_grad_norm) > opt.grad_clip
        else:
            assert a.executor.last_grad_norm is None
            assert "norm" not in a.executor.last_history
    if opt.stateful:
        sa, sm = a.opt_state, m.opt_state
        assert int(sa.step) == int(sm.step) == 3
        for n in params:
            assert _eq(sa.mu[n], sm.mu[n]) and _eq(sa.nu[n], sm.nu[n])
    else:
        assert a.opt_state is None and m.opt_state is None


@pytest.mark.parametrize("cut", [(0, 0, 0, 0, 1, 1, 1, 1),
                                 (0, 0, 1, 1, 1, 2, 2, 2)],
                         ids=["2_stages", "3_stages"])
def test_residual_across_stages_bitwise(cut):
    """``h`` is produced in stage 0 and consumed there and by the last
    stage (cut into 3, it is carried through the middle one): its cotangent
    sums both contributions in the monolithic engine's order."""
    g = _lm_graph()
    for op, s in zip(g.topo_ops(), cut):
        op.stage = s
    params, data = _params_and_data(g, w_scale=0.3, n_classes=64)
    opt = OptimizerSpec.adamw(lr=1e-2, grad_clip=1.0)
    a, m = _sessions(g, params, opt, stages=None, M=2, mb=["ids", "labels"])
    assert a.partition.num_stages == max(cut) + 1
    api.assert_sessions_match(a, m, data, steps=3)


def test_loss_produced_before_last_stage():
    """The loss sink need not live on the last stage: later stages (here an
    untrained metric head) contribute nothing to the gradients."""
    g = LogicalGraph(_placement())
    x, labels = g.input("x", (8, 16)), g.input("labels", (8,), dtype="int32")
    w0, w_m = g.input("w0", (16, 16)), g.input("w_m", (16, 16))
    with g.stage(0):
        h = g.matmul(x, w0, name="mm0")
        g.softmax_xent(h, labels, name="loss")
    with g.stage(1):
        g.unary(g.matmul(h, w_m, name="mm_m"), "tanh", name="metric")
    rng = np.random.default_rng(0)
    data = {"x": rng.normal(size=(8, 16)).astype(np.float32),
            "labels": rng.integers(0, 16, (8,)).astype(np.int32),
            "w_m": rng.normal(size=(16, 16)).astype(np.float32)}
    params = {"w0": (rng.normal(size=(16, 16)) * 0.1).astype(np.float32)}
    a, m = (api.compile(g, mode="train", backend=b, params=params,
                        num_microbatches=2, microbatch_inputs=MB,
                        loss="loss.out", device=CPU)
            for b in ("actors", "monolithic"))
    api.assert_sessions_match(a, m, data, steps=2)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_bf16_params_accumulate_in_fp32_bitwise(opt):
    g = LogicalGraph(_placement())
    x, labels = g.input("x", (8, 16)), g.input("labels", (8,), dtype="int32")
    w0 = g.input("w0", (16, 16), dtype="bfloat16")
    w1 = g.input("w1", (16, 16), dtype="bfloat16")
    with g.stage(0):
        h = g.unary(g.matmul(x, w0, name="mm0"), "relu", name="relu0")
    with g.stage(1):
        g.softmax_xent(g.matmul(h, w1, name="mm1"), labels, name="loss")
    rng = np.random.default_rng(1)
    params = {n: torch.tensor(rng.normal(size=(16, 16)) * 0.1,
                              dtype=torch.bfloat16) for n in ("w0", "w1")}
    data = {"x": rng.normal(size=(8, 16)).astype(np.float32),
            "labels": rng.integers(0, 16, (8,)).astype(np.int32)}
    spec = (OptimizerSpec.sgd(lr=1e-2, grad_clip=1.0) if opt == "sgd"
            else OptimizerSpec.adamw(lr=1e-3, grad_clip=1.0))
    a, m = _sessions(g, params, spec, stages=None)
    for _ in range(2):
        ra, rm = a.step(**data), m.step(**data)
        assert _eq(ra.loss, rm.loss)
        for n in params:
            assert ra.grads[n].dtype == torch.float32
            assert ra.params[n].dtype == torch.bfloat16
            assert _eq(ra.grads[n], rm.grads[n])
            assert _eq(ra.params[n], rm.params[n])


def test_reference_step_matches_monolithic_and_leaves_inputs():
    g = _train_graph()
    params, data = _params_and_data(g, w_scale=0.5)
    opt = OptimizerSpec.adamw(lr=1e-3, grad_clip=0.5)
    ts = lower_train_stages(g, plan(g), partition_stages(g, 4), list(params),
                            optimizer=opt, device=CPU)
    mono = api.compile(g, mode="train", backend="monolithic", params=params,
                       num_microbatches=4, optimizer=opt, device=CPU)
    state, cur = None, {n: torch.as_tensor(v) for n, v in params.items()}
    for _ in range(2):
        rm = mono.step(**data)
        before = {n: v.clone() for n, v in cur.items()}
        rl, rg, cur, state = ts.reference_step({**cur, **data}, MB,
                                               num_microbatches=4,
                                               opt_state=state)
        assert _eq(rl, rm.loss)
        for n in params:
            assert _eq(rg[n], rm.grads[n]) and _eq(cur[n], rm.params[n])
            assert not _eq(before[n], cur[n])
    assert int(state.step) == 2
    # SGD: the caller's step_index drives the schedule
    sgd = OptimizerSpec.sgd(lr=lambda s: 1e-2 if s == 0 else 0.0)
    ts = lower_train_stages(g, plan(g), partition_stages(g, 4), list(params),
                            optimizer=sgd, device=CPU)
    _, _, after0, _ = ts.reference_step({**params, **data}, MB, 4,
                                        step_index=0)
    _, _, after1, _ = ts.reference_step({**after0, **data}, MB, 4,
                                        step_index=1)
    assert all(_eq(after0[n], after1[n]) for n in params)


# ---------------------------------------------------------------------------
# Register quotas and the optimizer actors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regs", [[1] * 4, [2] * 4, [4, 3, 2, 1]],
                         ids=["serial", "two", "1f1b"])
def test_peak_inflight_within_quota(regs):
    g = _train_graph()
    params, data = _params_and_data(g)
    sess = api.compile(g, mode="train", stages=4, regs=regs, params=params,
                       num_microbatches=8, device=CPU,
                       optimizer=OptimizerSpec.adamw(lr=1e-3, grad_clip=1.0))
    assert sess.executor.peak_inflight_activations == 0
    res = sess.step(**data)
    for s in range(4):
        assert sess.executor.last_peak_regs[f"f{s}"] <= regs[s]
    assert res.metrics["peak_inflight"] <= max(regs)
    if regs == [1] * 4:
        assert res.metrics["peak_inflight"] == 1


def test_optimizer_actors_fire_once_a_step_and_state_persists():
    g = _train_graph()
    params, data = _params_and_data(g, w_scale=0.5)
    M, S = 8, 4
    sess = api.compile(g, mode="train", stages=S, params=params,
                       num_microbatches=M, device=CPU,
                       optimizer=OptimizerSpec.adamw(lr=1e-2, grad_clip=0.5))
    ex = sess.executor
    assert int(sess.opt_state.step) == 0
    losses = []
    for k in (1, 2, 3):
        losses.append(float(sess.step(**data).loss))
        hist = ex.last_history
        assert len(hist["norm"]) == 1
        for s in range(S):
            assert len(hist[f"b{s}"]) == M and len(hist[f"acc{s}"]) == M
            assert len(hist[f"opt{s}"]) == 1 and len(hist[f"state{s}"]) == 1
        st = sess.opt_state
        assert int(st.step) == k == sess.step_count
        assert all(float(st.mu[n].abs().sum()) > 0 for n in params)
    assert losses[-1] < losses[0]
    assert [h["step"] for h in sess.history] == [0, 1, 2]


def test_lr_schedule_is_step_indexed_and_load_params_rewinds():
    g = _train_graph()
    params, data = _params_and_data(g)
    sess = api.compile(g, mode="train", stages=4, params=params,
                       num_microbatches=4, device=CPU,
                       optimizer=OptimizerSpec.sgd(
                           lr=lambda s: 1e-2 if s == 0 else 0.0))
    after0 = {n: v.clone() for n, v in sess.step(**data).params.items()}
    assert any(not _eq(after0[n], params[n]) for n in params)
    after1 = sess.step(**data).params
    assert all(_eq(after0[n], after1[n]) for n in params)
    a = api.compile(g, mode="train", stages=4, params=params,
                    num_microbatches=4, device=CPU)
    b = api.compile(g, mode="train", stages=4, params=params,
                    num_microbatches=4, device=CPU)
    a.step(**data)
    a.load_params(params)                 # rewind to the initial weights
    ra, rb = a.step(**data), b.step(**data)
    assert _eq(ra.loss, rb.loss)
    assert all(_eq(ra.params[n], rb.params[n]) for n in params)


def test_emit_every_and_multi_actor_collection():
    state = {"total": 0}

    def summer(x):
        state["total"] += x
        return state["total"]
    specs = [
        ActorSpec("src", fn=lambda version: version + 1, inputs=(),
                  out_regs=2, max_fires=6, thread=0, wants_version=True),
        ActorSpec("acc", fn=summer, inputs=("src",), out_regs=1,
                  max_fires=6, thread=1, emit_every=3)]
    rt = ThreadedRuntime(specs, collect_outputs_of=["src", "acc"])
    outs = rt.run(timeout=10.0)
    assert outs["acc"] == [6, 21] and outs["src"] == [1, 2, 3, 4, 5, 6]


# ---------------------------------------------------------------------------
# Validation and the deprecated shims
# ---------------------------------------------------------------------------

class TestValidation:
    def test_train_lowering_rejects_bad_params_and_losses(self):
        g = LogicalGraph(_placement())
        x, w = g.input("x", (8, 16)), g.input("w", (16, 16))
        with g.stage(0):
            h = g.matmul(x, w, name="mm0")
        with g.stage(1):
            g.matmul(h, w, name="mm1")
        with pytest.raises(ValueError, match="exactly one stage"):
            lower_train_stages(g, plan(g), partition_stages(g), ["w"])
        g = _train_graph()
        p, part = plan(g), partition_stages(g, num_stages=2)
        with pytest.raises(ValueError, match="not a graph sink"):
            lower_train_stages(g, p, part, ["w0"], loss="mm0.out")
        with pytest.raises(ValueError, match="not a graph input"):
            lower_train_stages(g, p, part, ["nope"])
        with pytest.raises(ValueError, match="non-float"):
            lower_train_stages(g, p, part, ["labels"])
        with pytest.raises(ValueError, match="not divisible"):
            split_microbatches({"x": np.zeros((10, 4))}, ["x"], 3)

    def test_param_not_feeding_loss_rejected(self):
        g = LogicalGraph(_placement())
        x, labels = g.input("x", (8, 16)), g.input("labels", (8,),
                                                   dtype="int32")
        w0, w_dead = g.input("w0", (16, 16)), g.input("w_dead", (16, 16))
        with g.stage(0):
            h = g.matmul(x, w0, name="mm0")
            g.unary(g.matmul(x, w_dead, name="mm_dead"), "tanh",
                    name="metric")
        with g.stage(1):
            g.softmax_xent(h, labels, name="loss")
        with pytest.raises(ValueError, match="does not feed the loss"):
            lower_train_stages(g, plan(g), partition_stages(g),
                               ["w0", "w_dead"], loss="loss.out")

    def test_executor_validates_at_construction_and_run(self):
        g = _train_graph()
        params, data = _params_and_data(g)
        ts = lower_train_stages(g, plan(g), partition_stages(g, 4),
                                list(params), device=CPU)
        for kw, match in ((dict(num_microbatches=0), "num_microbatches"),
                          (dict(num_microbatches=4, regs=[1, 1]),
                           "register quotas"),
                          (dict(num_microbatches=4, regs=[2, 0, 1, 1]),
                           "stage 1 .* got 0")):
            with pytest.raises(ValueError, match=match):
                TrainPipelineExecutor(ts, params, MB, **kw)
        with pytest.raises(ValueError, match="not a graph input"):
            TrainPipelineExecutor(ts, params, ["nope"], 4)
        ex = TrainPipelineExecutor(ts, params, MB, 4)
        with pytest.raises(ValueError, match="'mystery'"):
            ex.step({**data, "mystery": data["x"]})
        with pytest.raises(ValueError, match="'labels'"):
            ex.step({"x": data["x"]})
        with pytest.raises(ValueError, match="optimizer kind"):
            OptimizerSpec(kind="rmsprop")

    def test_annotations_contradicting_num_stages_rejected(self):
        g = LogicalGraph(_placement())
        x, w0 = g.input("x", (8, 16)), g.input("w0", (16, 16))
        with g.stage(0):
            h = g.matmul(x, w0, name="mm0")
        with g.stage(1):
            g.reduce(g.unary(h, "tanh", name="t"), axis=1, name="loss")
        with pytest.warns(DeprecationWarning), \
                pytest.raises(ValueError, match="annotations span"):
            make_pipeline_train_step(g, {"w0": np.zeros((16, 16),
                                                        np.float32)},
                                     ["x"], num_microbatches=2,
                                     num_stages=4, device=CPU)


def test_deprecated_shims_warn_and_match_the_api():
    g = _train_graph()
    params, data = _params_and_data(g)
    with pytest.warns(DeprecationWarning, match="api.compile"):
        mono = make_graph_train_step(g, list(params), MB,
                                     num_microbatches=4, device=CPU)
    with pytest.warns(DeprecationWarning, match="api.compile"):
        pipe = make_pipeline_train_step(g, params, MB, num_microbatches=4,
                                        num_stages=4, device=CPU)
    assert isinstance(pipe, TrainPipelineExecutor)
    assert pipe.regs == [4, 3, 2, 1]
    cur = dict(params)
    for _ in range(2):
        ml, mg, cur = mono.step(cur, data)
        pl, pg, pp = pipe.step(data)
        assert _eq(ml, pl)
        assert all(_eq(mg[n], pg[n]) and _eq(cur[n], pp[n]) for n in params)
    assert mono.step_count == 2


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["actors", "monolithic"])
def test_three_adamw_steps_match_jax_session(backend):
    pytest.importorskip("jax")
    from repro import api as japi
    from repro.core.graph import LogicalGraph as JG
    from repro.core.lowering import OptimizerSpec as JO
    from repro.core.placement import Placement as JP

    gj, gt = _lm_graph(JG, JP), _lm_graph()
    params, data = _params_and_data(gt, w_scale=0.3, n_classes=64)
    kw = dict(mode="train", backend=backend, params=params,
              num_microbatches=4, regs="1f1b")
    sj = japi.compile(gj, optimizer=JO.adamw(lr=1e-2, grad_clip=1.0),
                      check="off", **kw)
    st = api.compile(gt, optimizer=OptimizerSpec.adamw(lr=1e-2,
                                                       grad_clip=1.0),
                     device=CPU, **kw)
    for step in range(3):
        rj, rt = sj.step(**data), st.step(**data)
        np.testing.assert_allclose(float(rt.loss), float(rj.loss),
                                   rtol=1e-5)
        for n in params:
            np.testing.assert_allclose(rt.grads[n].numpy(),
                                       np.asarray(rj.grads[n]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"grad {n} {step}")
            np.testing.assert_allclose(rt.params[n].numpy(),
                                       np.asarray(rj.params[n]), rtol=1e-4,
                                       atol=1e-5, err_msg=f"param {n} {step}")
        np.testing.assert_allclose(float(rt.metrics["grad_norm"]),
                                   float(rj.metrics["grad_norm"]), rtol=1e-5)
