"""``api.compile(..., runtime="processes")`` for infer, train and serve: one
worker process per actor node, held bitwise to the threads runtime and the
monolithic engine, and to the JAX package's sessions on the CPU (the port
of ``tests/test_api_runtime.py::TestProcessSessions`` and of the process
cases of ``tests/dist/suite_process_runtime.py``).

* infer: threads ≡ processes ≡ monolithic, bitwise, then the process
  session reused with new inputs (the same workers, a fresh epoch); the
  sinks within 1e-6 relative of the JAX monolithic session's;
* train: three AdamW steps with global-norm clipping and a scheduled lr,
  losses, post-clip gradients, params and optimizer state bitwise across
  the three; each step held to the JAX ``Session`` at
  ``tests/test_torch_graph_train.py``'s tolerances (loss 1e-5 relative,
  grads ``rtol=1e-4, atol=1e-6``, params ``rtol=1e-4, atol=1e-5``);
* serve: reduced qwen3 (vocab 1000, the JAX package's params): the token
  streams of processes ≡ threads ≡ monolithic ≡ the JAX monolithic
  session on the Auto-axes 1x1 mesh (the reference's own processes serve
  is red under jax 0.9's Explicit axes, ROADMAP Queue 3);
* meshes of virtual ranks: serving on a (1, 2) mesh and graph training on
  per-stage 2-rank meshes, processes ≡ threads, bitwise; reduced mamba2
  (SSM stages) served on processes ≡ threads;
* a ZeRO + bf16 + dynamic-scale snapshot written by the port's worker
  processes restores in the JAX package, byte-identical through both
  loaders, and the two next steps agree.

The lr schedule and everything else the workers unpickle come from modules
that import no jax (``torch_process_helpers``), so the workers do not.
"""
import dataclasses
import tempfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core.graph import LogicalGraph as JGraph  # noqa: E402
from repro.core.lowering import OptimizerSpec as JOpt  # noqa: E402
from repro.core.lowering import PrecisionPolicy as JPolicy  # noqa: E402
from repro.core.placement import Placement as JPlacement  # noqa: E402
from repro.models.model_zoo import build_model as jax_build  # noqa: E402
from repro.runtime import snapshot as jsnap  # noqa: E402
from repro.train.steps import plan_from_mesh  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.graph import LogicalGraph  # noqa: E402
from repro_torch.core.lowering import (OptimizerSpec,  # noqa: E402
                                       PrecisionPolicy)
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import snapshot as psnap  # noqa: E402
from torch_process_helpers import lr_schedule  # noqa: E402

B, W, S, M = 16, 32, 4, 4
CPU = "cpu"


def _graph(G=LogicalGraph, P=Placement, with_loss=True, depth=S,
           axes=(("d",), (1,))):
    g = G(P(*axes))
    h = g.input("x", (B, W))
    if with_loss:
        labels = g.input("labels", (B,), dtype="int32")
    for i in range(depth):
        h = g.matmul(h, g.input(f"w{i}", (W, W)), name=f"mm{i}")
        if i < depth - 1:
            h = g.unary(h, "relu", name=f"relu{i}")
    if with_loss:
        g.softmax_xent(h, labels, name="loss")
    return g


def _params_and_data(g, seed=0):
    rng = np.random.default_rng(seed)
    params, data = {}, {}
    for t in g.inputs:
        if t.name.startswith("w"):
            params[t.name] = (rng.normal(size=t.shape) * 0.1).astype(
                np.float32)
        elif t.dtype == "int32":
            data[t.name] = rng.integers(0, W, size=t.shape).astype(np.int32)
        else:
            data[t.name] = rng.normal(size=t.shape).astype(np.float32)
    return params, data


def _eq(a, b) -> bool:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(),
                               np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


class TestGraphSessions:
    def test_infer_three_way_and_reuse(self):
        """threads ≡ processes ≡ monolithic bitwise, twice on the same
        workers, and within 1e-6 of the JAX package."""
        g = _graph(with_loss=False)
        params, data = _params_and_data(g)
        kw = dict(mode="infer", num_microbatches=M, microbatch_inputs=["x"],
                  device=CPU)
        st = api.compile(g, runtime="threads", stages=S, **kw)
        sp = api.compile(g, runtime="processes", stages=S, **kw)
        sm = api.compile(g, backend="monolithic", **kw)
        sj = japi.compile(_graph(JGraph, JPlacement, with_loss=False),
                          mode="infer", backend="monolithic",
                          num_microbatches=M, microbatch_inputs=["x"],
                          check="off")
        try:
            for x in (data["x"], data["x"] + 1.0):
                inputs = dict(params, x=x)
                api.assert_sessions_match(st, sm, inputs)
                api.assert_sessions_match(sp, sm, inputs)
                got = sp.run(**inputs)["mm3.out"]
                want = sj.run(**inputs)["mm3.out"]
                _close(got, want, rtol=1e-6, atol=1e-6)
            pids = {w["pid"] for w in sp.executor.runtime.workers.values()}
            assert len(pids) == S + 1            # data + one per stage
            assert "runtime=processes" in sp.describe()
            assert "runtime=threads" in st.describe()
            assert all(v > 0 for v in sp.executor.last_edge_bytes.values())
        finally:
            sp.close()
            st.close()
            sj.close()

    def test_train_three_way_adamw_and_jax(self):
        """Three AdamW steps (clipping, scheduled lr): losses, post-clip
        gradients, params and moments bitwise across threads, processes
        and monolithic, each step held to the JAX Session."""
        g = _graph()
        params, data = _params_and_data(g)
        kw = dict(mode="train", num_microbatches=M, device=CPU,
                  optimizer=OptimizerSpec.adamw(lr=lr_schedule,
                                                grad_clip=1.0))
        sessions = [
            api.compile(_graph(), runtime="processes", stages=S,
                        params=dict(params), **kw),
            api.compile(_graph(), runtime="threads", stages=S,
                        params=dict(params), **kw),
            api.compile(_graph(), backend="monolithic",
                        params=dict(params), **kw)]
        sj = japi.compile(_graph(JGraph, JPlacement), mode="train",
                          params=dict(params), num_microbatches=M,
                          optimizer=JOpt.adamw(lr=lr_schedule,
                                               grad_clip=1.0),
                          backend="monolithic", check="off")
        try:
            for step in range(3):
                rp, rt, rm = [s.step(**data) for s in sessions]
                rj = sj.step(**data)
                for r in (rt, rm):
                    assert _eq(rp.loss, r.loss), step
                    for n in params:
                        assert _eq(rp.grads[n], r.grads[n]), (step, n)
                        assert _eq(rp.params[n], r.params[n]), (step, n)
                assert float(rp.metrics["grad_norm"]) > 1.0  # clipped
                _close(rp.loss, float(rj.loss), rtol=1e-5)
                for n in params:
                    _close(rp.grads[n], rj.grads[n], 1e-4, 1e-6,
                           f"grad {n} step {step}")
                    _close(rp.params[n], rj.params[n], 1e-4, 1e-5,
                           f"param {n} step {step}")
            want = sessions[2].opt_state
            for sess in sessions[:2]:
                got = sess.opt_state
                assert int(got.step) == int(want.step) == 3
                for n in params:
                    assert _eq(got.mu[n], want.mu[n])
                    assert _eq(got.nu[n], want.nu[n])
        finally:
            for sess in sessions + [sj]:
                sess.close()

    def test_per_stage_meshes_train(self):
        """Graph training with each stage on its own 2 virtual ranks
        (``stage_meshes``): processes ≡ threads, bitwise, three AdamW
        steps; the rank threads run inside each stage's worker."""
        axes = (("data",), (2,))
        g = _graph(axes=axes, depth=2)
        params, data = _params_and_data(g, seed=5)
        out = {}
        for runtime in ("threads", "processes"):
            gr = _graph(axes=axes, depth=2)
            meshes = [gr.placement.to_mesh(CPU, timeout=60.0)
                      for _ in range(2)]
            with api.compile(gr, mode="train", params=dict(params),
                             stage_meshes=meshes, stages=2,
                             num_microbatches=2, runtime=runtime,
                             optimizer=OptimizerSpec.adamw(
                                 lr=lr_schedule, grad_clip=1.0)) as sess:
                losses, ps = [], []
                for _ in range(3):
                    r = sess.step(**data)
                    # read now: on the threads runtime a step's params are
                    # the live shards, which the next step updates
                    losses.append(r.loss)
                    ps.append({n: v.clone() for n, v in r.params.items()})
                out[runtime] = (losses, ps, sess.opt_state)
        (lt, pt, ot), (lp, pp, op) = out["threads"], out["processes"]
        assert all(_eq(a, b) for a, b in zip(lt, lp))
        for a, b in zip(pt, pp):
            assert all(_eq(a[n], b[n]) for n in params)
        assert all(_eq(ot.mu[n], op.mu[n]) and _eq(ot.nu[n], op.nu[n])
                   for n in params)


def _auto_mesh():
    """The reference's 1x1 mesh with Auto axes (its serving path needs
    them under jax 0.9)."""
    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((1, 1), ("data", "model"), **kw)


GENS = [3, 6, 2, 5, 4]
PROMPT_LEN = 8
GEOMETRY = dict(num_groups=2, group_size=1, max_prompt_len=PROMPT_LEN,
                max_new_tokens=max(GENS), cache_len=24)


@pytest.fixture(scope="module")
def serve_env():
    cfg_j = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                                vocab_size=1000)
    cfg_t = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                                vocab_size=1000)
    mesh = _auto_mesh()
    params = jax_build(cfg_j, plan_from_mesh(mesh)).init(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 1000, (PROMPT_LEN,)).astype(np.int32), g)
            for g in GENS]
    return cfg_j, cfg_t, mesh, params, params_from_jax(
        jax.device_get(params), cfg_t), reqs


class TestServeSessions:
    def test_token_streams_match(self, serve_env):
        cfg_j, cfg_t, mesh, params, state, reqs = serve_env
        sj = japi.compile(cfg_j, mode="serve", backend="monolithic",
                          params=params, mesh=mesh, **GEOMETRY)
        want = sj.generate(reqs)
        out = {}
        for runtime in ("processes", "threads", None):
            kw = (dict(backend="monolithic") if runtime is None
                  else dict(stages=2, runtime=runtime))
            with api.compile(cfg_t, mode="serve", params=state, device=CPU,
                             **kw, **GEOMETRY) as sess:
                out[runtime] = sess.generate(reqs)
                if runtime == "processes":
                    assert "runtime=processes" in sess.describe()
                    st = sess.last_stats
                    assert st["admitted_mid_flight"] >= 1
                    rt = sess.executor.runtime
                    assert sorted(rt.workers) == [0, 1, 2]
        for key, got in out.items():
            assert [len(o) for o in got] == GENS, key
            for i, (a, b) in enumerate(zip(got, want)):
                assert np.array_equal(a, b), (key, i, a, b)

    def test_mamba2_stages_on_processes(self):
        """Reduced mamba2 (SSM stages: conv and scan state in each stage
        worker's caches), the port's seeded init: processes ≡ threads,
        token for token."""
        cfg = get_config("mamba2-370m").reduced()
        rng = np.random.default_rng(4)
        reqs = [(rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32), g)
                for n, g in ((8, 3), (5, 4), (6, 2))]
        out = {}
        for runtime in ("threads", "processes"):
            with api.compile(cfg, mode="serve", stages=2, runtime=runtime,
                             device=CPU, seed=0, num_groups=2, group_size=1,
                             max_prompt_len=8, max_new_tokens=4,
                             cache_len=16) as sess:
                out[runtime] = sess.generate(reqs)
        assert all(np.array_equal(a, b)
                   for a, b in zip(out["threads"], out["processes"]))

    def test_mesh_of_two_ranks(self):
        """Reduced qwen3 on a (1, 2) mesh of virtual ranks, the port's
        seeded init: processes ≡ threads, token for token."""
        cfg = get_config("qwen3-1.7b").reduced()
        rng = np.random.default_rng(8)
        reqs = [(rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32), g)
                for n, g in ((8, 3), (5, 6), (7, 2), (3, 5))]
        out = {}
        for runtime in ("threads", "processes"):
            mesh = Placement(("data", "model"), (1, 2)).to_mesh(
                CPU, timeout=60.0)
            with api.compile(cfg, mode="serve", stages=2, runtime=runtime,
                             mesh=mesh, seed=0, num_groups=2, group_size=2,
                             max_prompt_len=8, max_new_tokens=6,
                             cache_len=24) as sess:
                out[runtime] = sess.generate(reqs)
        assert all(np.array_equal(a, b)
                   for a, b in zip(out["threads"], out["processes"]))


class TestSnapshotAcrossPackages:
    def test_jax_restores_a_snapshot_the_workers_wrote(self):
        """Two ZeRO + bf16 + dynamic-scale steps on the port's worker
        processes, each stage's files written from its own worker: both
        packages' loaders read the same bytes, and a JAX session restored
        from it takes the same next step as the port's session, within
        the snapshot parity tolerances."""
        g = _graph(depth=2)
        params, data = _params_and_data(g, seed=2)
        policy = dict(compute_dtype="bfloat16", loss_scale="dynamic",
                      init_scale=2.0 ** 4, growth_interval=2)
        with tempfile.TemporaryDirectory() as d:
            sess = api.compile(_graph(depth=2), mode="train", stages=2,
                               params=dict(params), num_microbatches=2,
                               runtime="processes", snapshot_dir=d,
                               zero=True, precision=PrecisionPolicy(**policy),
                               optimizer=OptimizerSpec.adamw(
                                   lr=lr_schedule, grad_clip=1.0),
                               device=CPU)
            try:
                for _ in range(2):
                    sess.step(**data)
                pids = {w["pid"] for w in
                        sess.executor.runtime.workers.values()}
                jp, jo, jstep, jmeta = jsnap.load_snapshot(d)
                pp, po, pstep, pmeta = psnap.load_snapshot(d)
                assert jstep == pstep == 2 and jmeta == pmeta
                for n in params:
                    assert np.asarray(jp[n]).tobytes() == \
                        np.asarray(pp[n]).tobytes()
                    assert np.asarray(jo.mu[n]).tobytes() == \
                        np.asarray(po.mu[n]).tobytes()
                sj = japi.compile(
                    _graph(JGraph, JPlacement, depth=2), mode="train",
                    params=dict(params), num_microbatches=2, restore=d,
                    backend="monolithic", zero=True,
                    precision=JPolicy(**policy),
                    optimizer=JOpt.adamw(lr=lr_schedule, grad_clip=1.0),
                    check="off")
                assert sj.step_count == 2
                rj, rp = sj.step(**data), sess.step(**data)
                _close(rp.loss, float(rj.loss), rtol=1e-5)
                for n in params:
                    _close(rp.params[n], rj.params[n], 1e-4, 1e-5, n)
                assert rp.metrics["loss_scale"] == rj.metrics["loss_scale"]
                assert len(pids) == 3
            finally:
                sess.close()
