"""Graph inference and training on meshes of several ranks.

Holds ``repro_torch.api.compile(graph, mesh=..., stage_meshes=...)`` to the
JAX package on the same seeded numpy data. As in ``test_torch_mesh.py`` the
JAX side runs once per module in a subprocess with 8 host devices, from the
code below, and writes ``.npz`` results to ``tmp_path``; the graphs are
built by one shared source (:data:`GRAPHS`) in both processes. The port
runs in process on the CPU, every rank a thread.

* the graphs of ``tests/dist/suite_actor_pipeline.py`` on (2, 2) and on
  (4,): monolithic and staged inference, the partial-value stage boundary
  included, and the actor pipeline by microbatch, ``rtol=atol=1e-6``;
* the two parts of ``tests/dist/suite_1f1b_train.py``: 4 stages, each on
  its own 2 ranks (``stage_meshes``), SGD, then AdamW with a global-norm
  clip, 3 steps against the JAX Session: the loss within 1e-5 relative,
  gradients and params within ``rtol=1e-5`` with ``atol=1e-5`` for the
  elements near zero (float32 summation order leaves a few at 7e-5
  relative);
* item 9 on the (2,) data mesh of that graph: ZeRO (fold 2), ZeRO with
  bf16 compute and a static loss scale, and bf16 with dynamic scaling, 3
  AdamW steps, actors ≡ monolithic bitwise and against the JAX Session:
  the loss within 1e-5 relative, the scales equal, params as above (bf16
  within ``atol=4e-4``, see the test);
* ``softmax_xent`` on vocab-split logits on (2,) and (2, 2), and the
  vocab-split embedding, against the one-device JAX values
  (``softmax_xent_ref`` and ``jax.grad`` of it), 1e-6; they train. (The
  JAX package's own multi-device program for this op adds ``log s`` once
  per shard, so it is not the reference here.)
* the port alone: actors ≡ monolithic bitwise on a (2, 2) mesh with the
  card phase's pins (rows over ``data``, vocab over ``model``), in
  float32 and with ZeRO, bf16 and dynamic loss scaling, two runs bitwise, and serving on a (1, 2) mesh (the model half of item 8) giving
  one device's tokens.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.graph import LogicalGraph, partition_stages
from repro_torch.core.lowering import (OptimizerSpec, PrecisionPolicy,
                                       lower_plan, lower_stages)
from repro_torch.core.placement import Placement
from repro_torch.core.planner import plan
from repro_torch.core.sbp import ndsbp

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
CPU = "cpu"

#: graph-building functions shared by both packages: ``G``/``P`` are
#: LogicalGraph and Placement of the one or the other
GRAPHS = r'''
def mlp_graph(G, P):
    """suite_actor_pipeline.py main(): a planner-sharded MLP on (2, 2)."""
    g = G(P(("data", "model"), (2, 2)))
    x = g.input("x", (32, 64), sbp="S(0),B")
    w0, w1 = g.input("w0", (64, 128)), g.input("w1", (128, 64))
    w2 = g.input("w2", (64, 64))
    h = g.unary(g.matmul(x, w0, name="mm0"), "relu", name="relu0")
    h = g.unary(g.matmul(h, w1, name="mm1"), "relu", name="relu1")
    g.matmul(h, w2, name="mm2")
    return g


def partial_graph(G, P):
    """suite_actor_pipeline.py partial_boundary(): a P stage boundary."""
    g = G(P(("model",), (4,)))
    x = g.input("x", (16, 64), sbp="B")
    w0 = g.input("w0", (64, 64), sbp="S(0)")
    w1 = g.input("w1", (64, 32))
    with g.stage(0):
        h = g.matmul(x, w0, name="mm0")
    h.pin("P")
    with g.stage(1):
        g.matmul(h, w1, name="mm1")
    return g


def train_graph(G, P):
    """suite_1f1b_train.py: 4 matmuls and softmax_xent, rows over data."""
    g = G(P(("data",), (2,)))
    h = g.input("x", (16, 32), sbp="S(0)")
    labels = g.input("labels", (16,), dtype="int32", sbp="S(0)")
    for i in range(4):
        h = g.matmul(h, g.input(f"w{i}", (32, 32)), name=f"mm{i}")
        if i < 3:
            h = g.unary(h, "relu", name=f"relu{i}")
    g.softmax_xent(h, labels, name="loss")
    return g


def adamw_lr(step):
    return 1e-3 * (0.5 ** step)


#: item 9's options on the data mesh (a PrecisionPolicy's fields as a dict)
PRECISION_CASES = [
    ("zero", dict(zero=True)),
    ("zero_bf16", dict(zero=True, precision="bf16", loss_scale=1024.0)),
    ("bf16_dynamic", dict(precision=dict(loss_scale="dynamic",
                                         init_scale=16.0,
                                         growth_interval=2))),
]
'''

JAX_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
out_dir = sys.argv[2]
import numpy as np
import jax
import jax.numpy as jnp
from repro import api
from repro.core.graph import LogicalGraph, partition_stages
from repro.core.lowering import (OptimizerSpec, PrecisionPolicy, lower_plan,
                                 lower_stages)
from repro.core.placement import Placement
from repro.core.planner import plan
from repro.kernels.softmax_xent.ref import softmax_xent_ref
exec(open(os.path.join(out_dir, "graphs.py")).read())
inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
res = {}

for name, build, ns in (("mlp", mlp_graph, 2), ("partial", partial_graph,
                                                None)):
    g = build(LogicalGraph, Placement)
    p = plan(g)
    mesh = g.placement.to_mesh()
    args = [inp[f"{name}_{t.name}"] for t in g.inputs]
    res[f"{name}_mono"] = np.asarray(lower_plan(g, p, mesh)(*args)[0])
    part = partition_stages(g, ns)
    res[f"{name}_staged"] = np.asarray(
        lower_stages(g, p, part, mesh=mesh)(*args)[0])
    if name == "mlp":
        mono = lower_plan(g, p, mesh)
        res["mlp_mb"] = np.concatenate(
            [np.asarray(mono(c, *args[1:])[0])
             for c in np.split(args[0], 4, axis=0)])

devs = jax.devices()
for kind in ("sgd", "adamw"):
    g = train_graph(LogicalGraph, Placement)
    opt = (OptimizerSpec.sgd(1e-2) if kind == "sgd" else
           OptimizerSpec.adamw(lr=adamw_lr, grad_clip=0.5))
    params = {f"w{i}": inp[f"train_w{i}"] for i in range(4)}
    data = {"x": inp["train_x"], "labels": inp["train_labels"]}
    sess = api.compile(g, mode="train", backend="monolithic", params=params,
                       num_microbatches=4, optimizer=opt, check="off",
                       mesh=g.placement.to_mesh(devices=devs[:2]))
    for step in range(3):
        r = sess.step(**data)
        res[f"{kind}{step}_loss"] = np.asarray(r.loss)
        if kind == "adamw":
            res[f"{kind}{step}_norm"] = np.asarray(r.metrics["grad_norm"])
        for n in params:
            res[f"{kind}{step}_g_{n}"] = np.asarray(r.grads[n])
            res[f"{kind}{step}_p_{n}"] = np.asarray(r.params[n])

# item 9 on the data mesh: ZeRO (fold 2) and bf16 over float32 masters
for name, extra in PRECISION_CASES:
    if isinstance(extra.get("precision"), dict):
        extra = dict(extra, precision=PrecisionPolicy(**extra["precision"]))
    g = train_graph(LogicalGraph, Placement)
    params = {f"w{i}": inp[f"train_w{i}"] for i in range(4)}
    data = {"x": inp["train_x"], "labels": inp["train_labels"]}
    sess = api.compile(g, mode="train", backend="monolithic", params=params,
                       num_microbatches=4, check="off",
                       optimizer=OptimizerSpec.adamw(lr=adamw_lr,
                                                     grad_clip=0.5),
                       mesh=g.placement.to_mesh(devices=devs[:2]), **extra)
    for step in range(3):
        r = sess.step(**data)
        res[f"{name}{step}_loss"] = np.asarray(r.loss)
        res[f"{name}{step}_scale"] = np.asarray(
            r.metrics.get("loss_scale") or 0.0)
    for n in params:
        res[f"{name}_p_{n}"] = np.asarray(r.params[n])

# one-device values of vocab-split softmax_xent and embedding
logits, labels = inp["xent_logits"], inp["xent_labels"]
res["xent_loss"] = np.asarray(softmax_xent_ref(logits, labels))
res["xent_grad"] = np.asarray(jax.grad(
    lambda l: softmax_xent_ref(l, labels).sum())(logits))
def emb_loss(E, W):
    return softmax_xent_ref(E[inp["emb_ids"]] @ W, inp["emb_labels"]).sum()
res["emb_loss"] = np.asarray(emb_loss(inp["emb_E"], inp["emb_W"]))
gE, gW = jax.grad(emb_loss, argnums=(0, 1))(inp["emb_E"], inp["emb_W"])
res["emb_gE"], res["emb_gW"] = np.asarray(gE), np.asarray(gW)
np.savez(os.path.join(out_dir, "jax.npz"), **res)
print("JAX-OK")
"""

_G = {}
exec(GRAPHS, _G)


def _inputs():
    rng = np.random.default_rng(7)
    f32 = np.float32
    out = {}
    for name, build in (("mlp", _G["mlp_graph"]),
                        ("partial", _G["partial_graph"])):
        for t in build(LogicalGraph, Placement).inputs:
            out[f"{name}_{t.name}"] = rng.normal(size=t.shape).astype(f32)
    for i in range(4):
        out[f"train_w{i}"] = (rng.normal(size=(32, 32)) * 0.5).astype(f32)
    out["train_x"] = rng.normal(size=(16, 32)).astype(f32)
    out["train_labels"] = rng.integers(0, 32, 16).astype(np.int32)
    out["xent_logits"] = (rng.normal(size=(8, 16)) * 3).astype(f32)
    out["xent_labels"] = rng.integers(0, 16, 8).astype(np.int32)
    out["emb_E"] = rng.normal(size=(16, 8)).astype(f32)
    out["emb_W"] = (rng.normal(size=(8, 16)) * 0.5).astype(f32)
    out["emb_ids"] = rng.integers(0, 16, 8).astype(np.int32)
    out["emb_labels"] = rng.integers(0, 16, 8).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_graph_mesh")
    inputs = _inputs()
    (out / "graphs.py").write_text(GRAPHS)
    np.savez(out / "inputs.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", JAX_CODE, SRC, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0 and "JAX-OK" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:])
    return inputs, dict(np.load(out / "jax.npz"))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(), want, rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("name,stages", [("mlp", 2), ("partial", None)])
def test_inference_matches_jax(jax_side, name, stages):
    inp, jx = jax_side
    g = _G[f"{name}_graph"](LogicalGraph, Placement)
    p = plan(g)
    args = [inp[f"{name}_{t.name}"] for t in g.inputs]
    staged = lower_stages(g, p, partition_stages(g, stages), device=CPU)
    assert not any(s.has_partial for s in staged.boundary_sbp.values())
    _close(lower_plan(g, p, device=CPU)(*args)[0], jx[f"{name}_mono"], 1e-6)
    _close(staged(*args)[0], jx[f"{name}_staged"], 1e-6)
    if name == "partial":
        assert p.tensor_sbp["mm0.out"].has_partial
        return
    feeds = {t.name: a for t, a in zip(g.inputs, args)}
    outs = []
    for backend in ("actors", "monolithic"):
        sess = api.compile(g, backend=backend, stages=stages,
                           num_microbatches=4, microbatch_inputs=["x"],
                           device=CPU)
        outs.append(sess.run(**feeds)["mm2.out"])
        sess.close()
    assert torch.equal(outs[0], outs[1])
    _close(outs[0], jx["mlp_mb"], 1e-6)


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_training_on_disjoint_stage_meshes_matches_jax(jax_side, kind):
    inp, jx = jax_side
    g = _G["train_graph"](LogicalGraph, Placement)
    params = {f"w{i}": inp[f"train_w{i}"] for i in range(4)}
    data = {"x": inp["train_x"], "labels": inp["train_labels"]}
    opt = (OptimizerSpec.sgd(1e-2) if kind == "sgd" else
           OptimizerSpec.adamw(lr=_G["adamw_lr"], grad_clip=0.5))
    meshes = [g.placement.to_mesh(CPU) for _ in range(4)]
    sess = api.compile(g, mode="train", params=params, stage_meshes=meshes,
                       stages=4, num_microbatches=4, optimizer=opt,
                       device=CPU)
    assert sess.partition.num_stages == 4
    for step in range(3):
        r = sess.step(**data)
        key = f"{kind}{step}"
        np.testing.assert_allclose(float(r.loss), jx[f"{key}_loss"],
                                   rtol=1e-5)
        for n in params:
            _close(r.grads[n], jx[f"{key}_g_{n}"], 1e-5, f"{key} grad {n}")
            _close(r.params[n], jx[f"{key}_p_{n}"], 1e-5, f"{key} param {n}")
        if kind == "adamw":
            assert float(r.metrics["grad_norm"]) > 0.5      # clip engaged
            np.testing.assert_allclose(float(r.metrics["grad_norm"]),
                                       jx[f"{key}_norm"], rtol=1e-5)
    if kind == "adamw":
        assert int(sess.opt_state.step) == 3
        assert len(sess.executor.last_history["norm"]) == 1
    sess.close()


@pytest.mark.parametrize("case", _G["PRECISION_CASES"],
                         ids=[c[0] for c in _G["PRECISION_CASES"]])
def test_mixed_precision_and_zero_on_the_data_mesh_match_jax(jax_side, case):
    """ZeRO (fold 2 over ``data``), bf16 over float32 masters with static
    and dynamic loss scaling: the actors (4 stages, 1F1B) bitwise the
    monolithic engine on the (2,) mesh, and 3 AdamW steps against the JAX
    Session on two devices -- losses within 1e-5 relative (bf16 included:
    both round the same params to bf16 and accumulate in float32), the
    loss scales equal, params as the float32 training above; in bf16 with
    ``atol=4e-4``, about 10x the measured 3.9e-5 on 6 of 1,024 elements:
    each backend rounds the bf16 cotangents of the two ranks' rows apart
    before their sum, and an element whose gradient is near zero then
    moves by a different share of lr = 1e-3 under AdamW."""
    inp, jx = jax_side
    name, extra = case
    if isinstance(extra.get("precision"), dict):
        extra = dict(extra, precision=PrecisionPolicy(**extra["precision"]))
    g = _G["train_graph"](LogicalGraph, Placement)
    params = {f"w{i}": inp[f"train_w{i}"] for i in range(4)}
    data = {"x": inp["train_x"], "labels": inp["train_labels"]}
    kw = dict(mode="train", params=params, num_microbatches=4, device=CPU,
              optimizer=OptimizerSpec.adamw(lr=_G["adamw_lr"], grad_clip=0.5),
              **extra)
    mono = api.compile(g, backend="monolithic", **kw)
    with api.compile(g, backend="actors", stages=4, regs="1f1b",
                     **kw) as actors:
        api.assert_sessions_match(actors, mono, data, steps=3)
    assert mono.optimizer.zero_dp == (2 if extra.get("zero") else 1)
    for step, rec in enumerate(mono.history):
        np.testing.assert_allclose(rec["loss"], jx[f"{name}{step}_loss"],
                                   rtol=1e-5)
        if "loss_scale" in rec:
            assert rec["loss_scale"] == float(jx[f"{name}{step}_scale"])
    bf16 = extra.get("precision") not in (None, "fp32", "float32")
    for n in params:
        np.testing.assert_allclose(mono.params[n].numpy(),
                                   jx[f"{name}_p_{n}"], rtol=1e-5,
                                   atol=4e-4 if bf16 else 1e-5,
                                   err_msg=f"{name} {n}")


@pytest.mark.parametrize("sizes", [(2,), (2, 2)])
def test_vocab_split_softmax_xent_gives_one_device_values(jax_side, sizes):
    inp, jx = jax_side
    names = ("model",) if len(sizes) == 1 else ("data", "model")
    g = LogicalGraph(Placement(names, sizes))
    rows = "B" if len(sizes) == 1 else "S(0),"
    logits = g.input("logits", (8, 16),
                     sbp="S(1)" if len(sizes) == 1 else "S(0),S(1)")
    labels = g.input("labels", (8,), dtype="int32",
                     sbp="B" if len(sizes) == 1 else rows + "B")
    g.softmax_xent(logits, labels, name="loss")
    p = plan(g)
    assert p.op_in_sbp["loss"][0] == ndsbp(
        "S(1)" if len(sizes) == 1 else "S(0),S(1)")
    x = {"logits": inp["xent_logits"], "labels": inp["xent_labels"]}
    out = api.compile(g, backend="monolithic", device=CPU).run(**x)
    _close(out["loss.out"][:, 0], jx["xent_loss"], 1e-6)
    for backend in ("actors", "monolithic"):
        sess = api.compile(g, mode="train", backend=backend, stages=1,
                           params={"logits": x["logits"]},
                           optimizer=OptimizerSpec.sgd(1.0), device=CPU)
        r = sess.step(labels=x["labels"])
        np.testing.assert_allclose(float(r.loss), jx["xent_loss"].sum(),
                                   rtol=1e-6)
        _close(r.grads["logits"], jx["xent_grad"], 1e-6, backend)
        losses = [float(sess.step(labels=x["labels"]).loss)
                  for _ in range(3)]
        assert losses[-1] < losses[0] < float(r.loss)       # it trains
        sess.close()


def test_vocab_split_embedding_gives_one_device_values(jax_side):
    inp, jx = jax_side
    g = LogicalGraph(Placement(("data", "model"), (2, 2)))
    ids = g.input("ids", (8,), dtype="int32", sbp="S(0),B")
    labels = g.input("labels", (8,), dtype="int32", sbp="S(0),B")
    h = g.embedding(g.input("E", (16, 8), sbp="B,S(0)"), ids, name="emb")
    logits = g.matmul(h, g.input("W", (8, 16), sbp="B,S(1)"), name="head")
    g.softmax_xent(logits, labels, name="loss")
    p = plan(g)
    assert p.op_out_sbp["emb"] == ndsbp("S(0),P")
    params = {"E": inp["emb_E"], "W": inp["emb_W"]}
    data = {"ids": inp["emb_ids"], "labels": inp["emb_labels"]}
    sess = api.compile(g, mode="train", backend="monolithic", params=params,
                       optimizer=OptimizerSpec.sgd(0.5), device=CPU)
    r = sess.step(**data)
    np.testing.assert_allclose(float(r.loss), jx["emb_loss"], rtol=1e-6)
    _close(r.grads["E"], jx["emb_gE"], 1e-6, "E")
    _close(r.grads["W"], jx["emb_gW"], 1e-6, "W")
    losses = [float(sess.step(**data).loss) for _ in range(3)]
    assert losses[-1] < losses[0] < float(r.loss)


# ---------------------------------------------------------------------------
# The port alone.
# ---------------------------------------------------------------------------

def _sharded_lm(N=32, V=64, D=16, F=32, blocks=2):
    """The card phase's graph at small widths on (2, 2): embedding, blocks
    of up/gelu/down/residual, the vocab head and softmax_xent, with rows
    over ``data`` and the vocabulary over ``model``."""
    g = LogicalGraph(Placement(("data", "model"), (2, 2)))
    ids = g.input("ids", (N,), dtype="int32", sbp="S(0),B")
    labels = g.input("labels", (N,), dtype="int32", sbp="S(0),B")
    h = g.embedding(g.input("E", (V, D), sbp="B,S(0)"), ids, name="embed")
    for i in range(blocks):
        a = g.unary(g.matmul(h, g.input(f"w_up{i}", (D, F)), name=f"up{i}"),
                    "gelu", name=f"gelu{i}")
        h = g.add(g.matmul(a, g.input(f"w_down{i}", (F, D)),
                           name=f"down{i}"), h, name=f"res{i}")
    logits = g.matmul(h, g.input("W_out", (D, V), sbp="B,S(1)"),
                      name="head")
    g.softmax_xent(logits, labels, name="loss")
    rng = np.random.default_rng(9)
    params = {t.name: (rng.normal(size=t.shape) * 0.3).astype(np.float32)
              for t in g.inputs if t.dtype == "float32"}
    data = {n: rng.integers(0, V, N).astype(np.int32)
            for n in ("ids", "labels")}
    return g, params, data


def test_actors_equal_monolithic_bitwise_on_a_mesh():
    g, params, data = _sharded_lm()
    assert plan(g).op_in_sbp["loss"][0] == ndsbp("S(0),S(1)")
    kw = dict(mode="train", params=params, num_microbatches=4,
              optimizer=OptimizerSpec.adamw(lr=1e-2, grad_clip=1.0),
              device=CPU)
    actors = api.compile(g, backend="actors", stages=4, regs="1f1b", **kw)
    mono = api.compile(g, backend="monolithic", **kw)
    api.assert_sessions_match(actors, mono, data, steps=3)
    assert actors.meshes[0].size == 4
    # the same 3 steps again from the same params: the same bits
    again = api.compile(g, backend="monolithic", **kw)
    for k in range(3):
        r = again.step(**data)
        assert torch.equal(r.loss, torch.as_tensor(mono.history[k]["loss"],
                                                   dtype=r.loss.dtype))
    for n in params:
        assert torch.equal(again.params[n], mono.params[n])
    # one device: the same losses to float32 summation order
    one = api.compile(_one_device(g), backend="monolithic", **kw)
    for k in range(3):
        np.testing.assert_allclose(float(one.step(**data).loss),
                                   mono.history[k]["loss"], rtol=1e-4)
    actors.close()


def test_mixed_precision_and_zero_on_the_2x2_mesh_actors_equal_monolithic():
    """The card phase's graph shape on (2, 2) with ZeRO (fold 2 over
    ``data``), bf16 compute and dynamic loss scaling: actors ≡ monolithic
    bitwise over 3 steps, the scale trajectory included, each rank's opt
    state flat and float32; and ZeRO ≡ the dense masters at the same
    precision. (The JAX package cannot train this graph: its vocab-split
    ``softmax_xent`` has no backward, ROADMAP Queue 3.)"""
    g, params, data = _sharded_lm()
    kw = dict(mode="train", params=params, num_microbatches=4, device=CPU,
              optimizer=OptimizerSpec.adamw(lr=1e-2, grad_clip=1.0),
              zero=True, precision="bf16", loss_scale="dynamic")
    mono = api.compile(g, backend="monolithic", **kw)
    with api.compile(g, backend="actors", stages=4, regs="1f1b",
                     **kw) as actors:
        api.assert_sessions_match(actors, mono, data, steps=3)
        assert [h["loss_scale"] for h in actors.history] == [2.0 ** 15] * 3
        for states in actors.executor.opt_states.values():
            for st in states:
                for m in st.mu.values():
                    assert m.dtype == torch.float32 and m.shape[0] == 2
    assert mono.optimizer.zero_dp == 2
    dense = api.compile(g, backend="monolithic", **dict(kw, zero=False))
    api.assert_sessions_match(dense, api.compile(g, backend="monolithic",
                                                 **kw), data, steps=2)


def _one_device(g):
    """The same graph on one device (no pins)."""
    g1 = LogicalGraph(Placement(("data", "model"), (1, 1)))
    env = {}
    for t in g.inputs:
        env[t.name] = g1.input(t.name, t.shape, dtype=t.dtype)
    for op in g.topo_ops():
        env[op.output.name] = g1.apply(op.spec.name,
                                       [env[t.name] for t in op.inputs],
                                       attrs=op.spec.attrs, name=op.name)
    return g1


def test_inference_on_a_mesh_actors_equal_monolithic():
    g, params, data = _sharded_lm()
    outs = []
    for backend in ("actors", "monolithic"):
        with api.compile(g, backend=backend, stages=2, num_microbatches=2,
                         microbatch_inputs=["ids", "labels"],
                         device=CPU) as sess:
            outs.append(sess.run(**params, **data)["loss.out"])
    assert torch.equal(outs[0], outs[1]) and outs[0].shape == (32, 1)


def test_serving_on_a_mesh_names_the_model_half():
    """The model half of item 8 serves on a (1, 2) mesh of the graph
    path's ranks: the same greedy tokens as one device, a mesh in the
    description and collectives in the stats
    (``tests/test_torch_serve_mesh.py`` holds it to the JAX package)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              vocab_size=1000)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, 1000, (n,)).astype(np.int32), g)
            for n, g in ((5, 3), (8, 4), (2, 2))]
    geo = dict(num_groups=1, group_size=2, max_prompt_len=8,
               max_new_tokens=4, device=CPU, seed=0)
    mesh = Placement(("data", "model"), (1, 2)).to_mesh(CPU)
    with api.compile(cfg, mode="serve", mesh=mesh, **geo) as sess, \
            api.compile(cfg, mode="serve", **geo) as one:
        got, want = sess.generate(reqs), one.generate(reqs)
        assert "tp=2" in sess.describe()
        assert sess.last_stats["collectives"]["calls"]["pmax"] > 0
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
