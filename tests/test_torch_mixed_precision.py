"""Mixed precision and ZeRO on the graph path (paper §6.4, Fig 14).

The port of ``tests/test_mixed_precision_zero.py``, one test function per
reference test: ``api.compile(graph, mode="train", zero=True,
precision="bf16", loss_scale=...)`` runs forward and backward in bfloat16
over flat float32 master shards held by the opt actors, bitwise across the
threaded actors and the monolithic engine, and between ``zero=True`` and
``zero=False`` at the same precision. Static and dynamic loss scaling
(growth, skip and backoff) give the same trajectories on both backends.

Each session is also held to the JAX package's session on the same graph
and seeded numpy data (``repro.api.compile``): the losses within 1e-6
relative in float32, and in bf16 within the reference's own bf16
tolerance, ``rtol=2e-2`` (``tests/test_kernels.py:24``; measured 0 on
these graphs: both round the params to bf16 to nearest even and promote
the matmuls with the float32 inputs to float32); the loss-scale trajectory
and the skips equal. A snapshot taken under dynamic scaling restores the
masters, moments and the scale trajectory bitwise. The process runtime
(``runtime="processes"``, and its bf16 wire format) is ROADMAP Queue 1
item 11: its cases check that the option raises naming the item.
"""
import tempfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.core.graph import LogicalGraph as JGraph  # noqa: E402
from repro.core.lowering import OptimizerSpec as JOpt  # noqa: E402
from repro.core.lowering import PrecisionPolicy as JPolicy  # noqa: E402
from repro.core.placement import Placement as JPlacement  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core.graph import LogicalGraph  # noqa: E402
from repro_torch.core.lowering import (OptimizerSpec,  # noqa: E402
                                       PrecisionPolicy)
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.optim.zero import ZeroState  # noqa: E402

B, W, S, M, STEPS = 8, 8, 2, 2, 3
CPU = "cpu"
#: the reference's bf16 tolerance (tests/test_kernels.py:24)
BF16_RTOL = 2e-2


def _graph(G=LogicalGraph, P=Placement, axes=(("d",), (1,))):
    g = G(P(*axes))
    h = g.input("x", (B, W))
    labels = g.input("labels", (B,), dtype="int32")
    for i in range(S):
        w = g.input(f"w{i}", (W, W))
        h = g.matmul(h, w, name=f"mm{i}")
        if i < S - 1:
            h = g.unary(h, "relu", name=f"relu{i}")
    g.softmax_xent(h, labels, name="loss")
    return g


def _params_and_data(seed=0):
    rng = np.random.default_rng(seed)
    params = {f"w{i}": (rng.normal(size=(W, W)) * 0.1).astype(np.float32)
              for i in range(S)}
    data = {"x": rng.normal(size=(B, W)).astype(np.float32),
            "labels": rng.integers(0, W, size=(B,)).astype(np.int32)}
    return params, data


def _lr_schedule(s):
    return 1e-3 * 0.9 ** s


def _mp_kwargs(params, **extra):
    kw = dict(mode="train", params=dict(params), num_microbatches=M,
              zero=True, precision="bf16", loss_scale=1024.0)
    kw.update(extra)
    return kw


def _port(backend="monolithic", **kw):
    if backend == "actors":
        kw.setdefault("stages", S)
    return api.compile(_graph(), backend=backend, device=CPU,
                       optimizer=OptimizerSpec.adamw(lr=_lr_schedule,
                                                     grad_clip=1.0), **kw)


def _jax(**kw):
    """The JAX package's monolithic session on the same graph."""
    p = kw.get("precision")
    if isinstance(p, PrecisionPolicy):
        kw["precision"] = JPolicy(
            compute_dtype=p.compute_dtype, loss_scale=p.loss_scale,
            init_scale=p.init_scale, growth_interval=p.growth_interval,
            growth_factor=p.growth_factor, backoff_factor=p.backoff_factor)
    return japi.compile(_graph(JGraph, JPlacement), backend="monolithic",
                        optimizer=JOpt.adamw(lr=_lr_schedule, grad_clip=1.0),
                        check="off", **kw)


def _bf16(kw) -> bool:
    p = kw.get("precision")
    return p in ("bf16", "bfloat16") or (
        isinstance(p, PrecisionPolicy) and p.compute_dtype == "bfloat16")


def _held_to_jax(sess, kw, batches):
    """Step the JAX session on ``batches`` beside ``sess``'s history: the
    losses (1e-6 relative in float32, BF16_RTOL in bf16), the loss scales
    and the skips."""
    ref = _jax(**kw)
    rtol = BF16_RTOL if _bf16(kw) else 1e-6
    for rec, batch in zip(sess.history, batches):
        r = ref.step(**batch)
        np.testing.assert_allclose(rec["loss"], float(r.loss), rtol=rtol)
        if "loss_scale" in r.metrics:
            assert rec["loss_scale"] == r.metrics["loss_scale"]
            assert rec["skipped"] == r.metrics["skipped"]
    ref.close()


# ---------------------------------------------------------------------------

class TestFourWayBitIdentity:
    """zero=True precision='bf16' loss_scale=1024: losses, float32 masters
    and AdamW moments bitwise across the backends and the layouts over
    STEPS scheduled-lr steps."""

    def test_actors_threads_vs_monolithic(self):
        params, data = _params_and_data()
        mono = _port(**_mp_kwargs(params))
        with _port("actors", runtime="threads", **_mp_kwargs(params)) as thr:
            api.assert_sessions_match(thr, mono, data, steps=STEPS)
        _held_to_jax(mono, _mp_kwargs(params), [data] * STEPS)

    def test_actors_processes_vs_monolithic(self):
        """The process runtime and its bf16 wire format are ROADMAP Queue 1
        item 11."""
        params, _ = _params_and_data()
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            _port("actors", runtime="processes", **_mp_kwargs(params))

    def test_zero_layout_matches_dense_masters(self):
        """The flat shard layout is bookkeeping: zero=True equals zero=False
        at the same compute precision, bit for bit."""
        params, data = _params_and_data()
        z = _port(**_mp_kwargs(params))
        d = _port(**_mp_kwargs(params, zero=False))
        assert z.optimizer.zero and not d.optimizer.zero
        api.assert_sessions_match(z, d, data, steps=STEPS)
        _held_to_jax(d, _mp_kwargs(params, zero=False), [data] * STEPS)

    def test_masters_stay_fp32_params_surface_fp32(self):
        params, data = _params_and_data()
        with _port("actors", **_mp_kwargs(params)) as sess:
            res = sess.step(**data)
            for n, v in res.params.items():
                assert v.dtype == torch.float32, n
            st = sess.opt_state
            for n in st.mu:
                assert st.mu[n].dtype == st.nu[n].dtype == torch.float32
                assert st.mu[n].shape == (W, W)
            # the opt actors' own state: flat (dp, 1, chunk) ZeroStates
            for states in sess.executor.opt_states.values():
                assert isinstance(states[0], ZeroState)
                for m in states[0].mu.values():
                    assert m.shape == (1, 1, W * W)
        _held_to_jax(sess, _mp_kwargs(params), [data])

    def test_bf16_actually_degrades_vs_fp32(self):
        """Anti-placebo: the bf16 path differs from float32 compute, or the
        cast at the stage boundary is not happening."""
        params, data = _params_and_data()
        bf = _port(**_mp_kwargs(params))
        fp = _port(mode="train", params=dict(params), num_microbatches=M)
        lb, lf = float(bf.step(**data).loss), float(fp.step(**data).loss)
        assert lb != lf
        _held_to_jax(bf, _mp_kwargs(params), [data])
        _held_to_jax(fp, dict(mode="train", params=dict(params),
                              num_microbatches=M), [data])


class TestLossScaling:
    def test_static_scale_is_exact_for_powers_of_two(self):
        """Scaled-then-unscaled grads are bitwise the unscaled bf16 ones:
        scaling costs nothing when nothing overflows."""
        params, data = _params_and_data()
        a = _port(**_mp_kwargs(params))
        b = _port(**_mp_kwargs(params, loss_scale=None))
        api.assert_sessions_match(a, b, data, steps=STEPS)
        _held_to_jax(b, _mp_kwargs(params, loss_scale=None), [data] * STEPS)

    def test_metrics_carry_scale_and_skip(self):
        params, data = _params_and_data()
        for backend in ("monolithic", "actors"):
            with _port(backend, **_mp_kwargs(params)) as sess:
                m = sess.step(**data).metrics
                assert m["loss_scale"] == 1024.0
                assert m["skipped"] is False
        plain = _port(mode="train", params=dict(params), num_microbatches=M)
        assert "loss_scale" not in plain.step(**data).metrics

    def _dynamic_policy(self, growth_interval=2):
        return PrecisionPolicy(compute_dtype="bfloat16",
                               loss_scale="dynamic", init_scale=2.0 ** 4,
                               growth_interval=growth_interval)

    def test_dynamic_growth_after_interval(self):
        params, data = _params_and_data()
        kw = _mp_kwargs(params, precision=self._dynamic_policy(),
                        loss_scale=None)
        mono = _port(**kw)
        with _port("actors", **kw) as thr:
            api.assert_sessions_match(thr, mono, data, steps=4)
            # 4 good steps at growth_interval=2: two doublings of 2**4
            assert mono.executor.loss_scale == 2.0 ** 6
            assert thr.executor.loss_scale == 2.0 ** 6
        assert [h["loss_scale"] for h in mono.history] == [16.0, 16.0, 32.0,
                                                           32.0]
        _held_to_jax(mono, kw, [data] * 4)

    @pytest.mark.parametrize("backend,runtime",
                             [("monolithic", None), ("actors", "threads"),
                              ("actors", "processes")])
    def test_nonfinite_step_skips_and_backs_off(self, backend, runtime):
        """An inf batch in bf16 gives a non-finite grad norm: the step is
        skipped -- params, moments and step counter untouched -- and the
        scale halved, the same on every backend (the process runtime is
        ROADMAP Queue 1 item 11)."""
        params, data = _params_and_data()
        bad = dict(data)
        bad["x"] = np.full_like(data["x"], np.inf)
        kw = _mp_kwargs(params, precision=self._dynamic_policy(),
                        loss_scale=None)
        if runtime == "processes":
            with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
                _port(backend, runtime=runtime, **kw)
            return
        if runtime is not None:
            kw["runtime"] = runtime
        with _port(backend, **kw) as sess:
            r0 = sess.step(**data)          # good step
            p_before = {n: v.clone() for n, v in sess.params.items()}
            st_before = sess.opt_state
            mu_before = {n: v.clone() for n, v in st_before.mu.items()}
            r1 = sess.step(**bad)           # skipped step
            assert r1.metrics["skipped"] is True
            assert r1.grads == {}
            assert sess.step_count == 1     # the schedule did not advance
            assert sess.executor.loss_scale == 2.0 ** 3   # backed off
            for n, v in sess.params.items():
                assert torch.equal(v, p_before[n]), n
            st = sess.opt_state
            assert int(st.step) == int(st_before.step)
            for n, v in st.mu.items():
                assert torch.equal(v, mu_before[n]), n
            r2 = sess.step(**data)          # recovers at the lower scale
            assert r2.metrics["skipped"] is False
            assert r2.metrics["loss_scale"] == 2.0 ** 3
            assert r0.metrics["skipped"] is False
        kw.pop("runtime", None)
        _held_to_jax(sess, kw, [data, bad, data])

    def test_skip_trajectories_match_across_backends(self):
        params, data = _params_and_data()
        bad = dict(data)
        bad["x"] = np.full_like(data["x"], np.inf)
        kw = _mp_kwargs(params, precision=self._dynamic_policy(),
                        loss_scale=None)
        mono = _port(**kw)
        batches = (data, bad, data, data)
        with _port("actors", **kw) as thr:
            for batch in batches:
                rm, rt = mono.step(**batch), thr.step(**batch)
                assert rm.metrics["skipped"] == rt.metrics["skipped"]
                assert rm.metrics["loss_scale"] == rt.metrics["loss_scale"]
                if not rm.metrics["skipped"]:
                    assert float(rm.loss) == float(rt.loss)
            for n, v in mono.params.items():
                assert torch.equal(thr.params[n], v), n
        assert [h["skipped"] for h in mono.history] == [False, True, False,
                                                        False]
        _held_to_jax(mono, kw, batches)


class TestOptionValidation:
    def test_rejected_outside_train_mode(self):
        for kw in ({"zero": True}, {"precision": "bf16"},
                   {"loss_scale": 2.0}):
            with pytest.raises(ValueError, match="mode='train'"):
                api.compile(_graph(), mode="infer", device=CPU, **kw)
            with pytest.raises(ValueError, match="mode='train'"):
                japi.compile(_graph(JGraph, JPlacement), mode="infer", **kw)

    def test_zero_requires_adamw(self):
        params, _ = _params_and_data()
        with pytest.raises(ValueError, match="adamw"):
            api.compile(_graph(), mode="train", params=dict(params),
                        zero=True, device=CPU)     # default SGD

    def test_zero_requires_a_data_axis(self):
        def graph(G, P):
            g = G(P(("row", "col"), (1, 1)))
            h = g.input("x", (B, W))
            labels = g.input("labels", (B,), dtype="int32")
            w = g.input("w0", (W, W))
            g.softmax_xent(g.matmul(h, w, name="mm0"), labels, name="loss")
            return g
        params = {"w0": np.zeros((W, W), np.float32)}
        with pytest.raises(ValueError, match="data axis"):
            api.compile(graph(LogicalGraph, Placement), mode="train",
                        params=params, device=CPU, zero=True,
                        optimizer=OptimizerSpec.adamw())
        # a "data" axis, or a sole axis, gives the fold
        g = _graph(axes=(("data", "model"), (1, 1)))
        params, _ = _params_and_data()
        sess = api.compile(g, mode="train", backend="monolithic",
                           params=params, device=CPU, zero=True,
                           optimizer=OptimizerSpec.adamw())
        assert sess.optimizer.zero_dp == 1
        assert dict(sess.optimizer.zero_shapes) == {"w0": (W, W),
                                                    "w1": (W, W)}

    def test_loss_scale_requires_bf16(self):
        params, _ = _params_and_data()
        with pytest.raises(ValueError, match="precision"):
            api.compile(_graph(), mode="train", params=dict(params),
                        optimizer=OptimizerSpec.adamw(), loss_scale=2.0,
                        device=CPU)
        with pytest.raises(ValueError, match="bfloat16"):
            api.compile(_graph(), mode="train", params=dict(params),
                        optimizer=OptimizerSpec.adamw(), precision="fp32",
                        loss_scale=2.0, device=CPU)

    def test_unknown_precision_string(self):
        params, _ = _params_and_data()
        with pytest.raises(ValueError, match="precision"):
            api.compile(_graph(), mode="train", params=dict(params),
                        optimizer=OptimizerSpec.adamw(), precision="fp8",
                        device=CPU)

    def test_bad_policy_values(self):
        for bad in (dict(compute_dtype="float16"), dict(loss_scale=-1.0),
                    dict(loss_scale="sometimes")):
            with pytest.raises(ValueError):
                PrecisionPolicy(**bad)
            with pytest.raises(ValueError):
                JPolicy(**bad)


class TestSurfacing:
    def test_describe_reports_precision_zero_and_bytes(self):
        params, data = _params_and_data()
        with _port("actors", **_mp_kwargs(params)) as sess:
            sess.step(**data)
            text = sess.describe()
        assert "precision: compute=bfloat16 masters=float32" in text
        assert "loss_scale=1024.0" in text
        assert "zero: dp=1" in text
        assert "optimizer-state bytes/device:" in text

    def test_opt_state_bytes_accounting(self):
        """Mixed precision holds masters + mu + nu in float32 (3 floats an
        element), plain AdamW mu + nu (2), as the reference counts them."""
        params, data = _params_and_data()
        n_elems = S * W * W
        with _port("actors", **_mp_kwargs(params)) as mp_sess:
            mp_sess.step(**data)
            mp_bytes = sum(mp_sess.executor.opt_state_bytes().values())
        with _port("actors", mode="train", params=dict(params),
                   num_microbatches=M) as dense:
            dense.step(**data)
            dense_bytes = sum(dense.executor.opt_state_bytes().values())
        assert mp_bytes == 3 * 4 * n_elems
        assert dense_bytes == 2 * 4 * n_elems
        mono = _port(**_mp_kwargs(params))
        mono.step(**data)
        assert sum(mono.executor.opt_state_bytes().values()) == mp_bytes
        ref = _jax(**_mp_kwargs(params))
        ref.step(**data)
        assert sum(ref.executor.opt_state_bytes().values()) == mp_bytes

    def test_last_edge_bytes_surface(self):
        params, data = _params_and_data()
        with _port("actors", **_mp_kwargs(params)) as sess:
            sess.step(**data)
            eb = sess.last_edge_bytes
            assert eb and all(isinstance(v, int) for v in eb.values())
        assert _port(**_mp_kwargs(params)).last_edge_bytes == {}


class TestSnapshotCarriesScale:
    def test_restore_resumes_scale_trajectory(self):
        """A snapshot taken under dynamic scaling records the scale to
        resume with; restore must continue the interrupted trajectory
        bitwise -- the flat ZeRO masters and moments, and the scale the
        next step runs under -- and the whole trajectory is the JAX
        session's."""
        params, data = _params_and_data()
        pol = PrecisionPolicy(compute_dtype="bfloat16", loss_scale="dynamic",
                              init_scale=2.0 ** 4, growth_interval=2)
        kw = _mp_kwargs(params, precision=pol, loss_scale=None)
        ref = _port(**kw)
        ref_steps = [ref.step(**data) for _ in range(4)]
        with tempfile.TemporaryDirectory() as d:
            with _port("actors", snapshot_dir=d, **kw) as sess:
                losses = [float(sess.step(**data).loss) for _ in range(2)]
            with _port("actors", restore=d, **kw) as res:
                # two good steps at growth_interval=2 -> scale grew once
                assert res.executor.loss_scale == 2.0 ** 5
                assert res.executor.scale_good_steps == 0
                assert res.step_count == 2
                tail = [res.step(**data) for _ in range(2)]
                losses += [float(r.loss) for r in tail]
                final, final_opt = res.params, res.opt_state
        assert losses == [float(r.loss) for r in ref_steps]
        assert ([r.metrics["loss_scale"] for r in tail]
                == [r.metrics["loss_scale"] for r in ref_steps[2:]])
        for n, v in ref.params.items():
            assert torch.equal(final[n], v), n
            assert torch.equal(final_opt.mu[n], ref.opt_state.mu[n]), n
            assert torch.equal(final_opt.nu[n], ref.opt_state.nu[n]), n
        _held_to_jax(ref, kw, [data] * 4)


# ---------------------------------------------------------------------------
# the port beyond the reference's file: a data mesh of two ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    dict(zero=True), dict(zero=True, precision="bf16", loss_scale=1024.0),
    dict(precision="bf16")], ids=["zero", "zero-bf16-scaled", "bf16"])
def test_on_a_data_mesh_actors_equal_monolithic_and_zero_folds(extra):
    """On ``("data",) (2,)`` ZeRO's fold is 2 (each rank holds its shard's
    flat (2, 1, chunk) rows: the accounting halves), and the actors are
    bitwise the monolithic engine and, at the same precision, the dense
    masters; ``tests/test_torch_graph_mesh.py`` holds these sessions to
    the JAX package's on two devices."""
    g = _graph(axes=(("data",), (2,)))
    params, data = _params_and_data(3)
    kw = dict(mode="train", params=params, num_microbatches=M, device=CPU,
              optimizer=OptimizerSpec.adamw(lr=_lr_schedule, grad_clip=1.0),
              **extra)
    mono = api.compile(g, backend="monolithic", **kw)
    with api.compile(g, backend="actors", stages=S, **kw) as thr:
        assert thr.meshes[0].size == 2
        api.assert_sessions_match(thr, mono, data, steps=STEPS)
        if extra.get("zero"):
            assert thr.optimizer.zero_dp == 2
            per = thr.executor.opt_state_bytes()
            assert sum(per.values()) == 3 * 4 * S * W * W // 2
    dense = dict(kw, zero=False)
    if extra.get("zero"):
        d = api.compile(g, backend="monolithic", **dense)
        for k in range(STEPS):
            assert float(d.step(**data).loss) == mono.history[k]["loss"]
        for n, v in d.params.items():
            assert torch.equal(v, mono.params[n]), n
