"""Kill-and-resume bit-identity on the port's threads and process runtimes
(the port of ``tests/test_fault_tolerance.py``; the elastic-training
acceptance test).

The contract under test, end to end, on ``device="cpu"``:

* ``compile(snapshot_dir=...)`` makes every training step emit an async
  per-stage snapshot (``snap{s}`` actors on their stage's thread 1),
  finalized by a MANIFEST the executor writes after every stage's receipt
  -- so ``latest_snapshot(dir)`` always equals the number of *completed*
  steps, even when a fault kills the run mid-step.
* ``compile(faults=FaultPlan([KillWorker(actor, fire=k)]))`` kills the
  named actor's worker at its k-th cumulative fire: a ``WorkerKilled``
  (a ``WorkerError``) out of ``step`` on the threads runtime; under
  ``runtime="processes"`` a real ``os._exit(57)`` of the stage's worker
  process, which the driver sees as a ``WorkerError`` naming the node and
  the exit code, with no worker process left alive.
* ``compile(restore=dir)`` resumes from the newest completed snapshot --
  params, Adam moments, the step counter the lr schedule indexes and the
  loss-scale trajectory.

Acceptance: for every (actor, fire) of a 3-step AdamW run with a scheduled
lr and clipping, plain and with ZeRO + bf16 + dynamic loss scaling, kill
the run there, resume from the last completed snapshot, and the combined
loss history and the final params and optimizer state are bitwise those of
an uninterrupted run of the monolithic engine (itself bitwise the actors,
``tests/test_torch_graph_train.py``). Also onto another partition, onto
the monolithic engine and on a ``("data",) (2,)`` ZeRO mesh of two CPU
ranks. On the process runtime (each stage's snapshot files written from
its worker process) the reference's cases ``f0-fire3``, ``b1-fire4`` and
``opt1-fire2``, and ZeRO cases, resume bitwise on processes too.
"""
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.graph import LogicalGraph
from repro_torch.core.lowering import OptimizerSpec, PrecisionPolicy
from repro_torch.core.placement import Placement
from repro_torch.runtime.base import WorkerError
from repro_torch.runtime.chaos import (KILL_EXIT_CODE, DropAck,
                                       FaultInjector, FaultPlan,
                                       KillWorker, WorkerKilled)
from repro_torch.runtime.snapshot import (latest_snapshot, list_snapshots,
                                          load_snapshot, stage_dir)
from repro_torch.runtime.threaded import ThreadedRuntime

B, W, S, M, STEPS = 8, 8, 2, 2, 3
CPU = "cpu"


def _graph(axes=(("d",), (1,))):
    g = LogicalGraph(Placement(*axes))
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


def _opt():
    # schedule + clipping: restore must also bring back the step counter
    # (lr schedule index) and the Adam moments for bits to match
    return OptimizerSpec.adamw(lr=_lr_schedule, grad_clip=1.0)


#: ZeRO over bf16 compute with a dynamic scale that grows within the run
#: (growth_interval 2), so a resume must also bring the trajectory back
ZERO_MP = dict(zero=True, precision=PrecisionPolicy(
    compute_dtype="bfloat16", loss_scale="dynamic", init_scale=2.0 ** 4,
    growth_interval=2))


def _kw(params, **extra):
    kw = dict(mode="train", params=dict(params), optimizer=_opt(),
              num_microbatches=M, device=CPU)
    kw.update(extra)
    return kw


def _uninterrupted(extra, axes=(("d",), (1,)), seed=0):
    params, data = _params_and_data(seed)
    sess = api.compile(_graph(axes), backend="monolithic",
                       **_kw(params, **extra))
    losses, scales = [], []
    for _ in range(STEPS):
        r = sess.step(**data)
        losses.append(float(r.loss))
        scales.append(r.metrics.get("loss_scale"))
    return {"params0": params, "data": data, "losses": losses,
            "scales": scales, "final_params": sess.params,
            "opt_state": sess.opt_state, "extra": extra, "axes": axes}


@pytest.fixture(scope="module")
def ref():
    """The uninterrupted STEPS-step run: losses, final params, opt state."""
    return _uninterrupted({})


@pytest.fixture(scope="module")
def zref():
    return _uninterrupted(ZERO_MP)


def _assert_matches_ref(ref, losses, params, opt_state, scales=None):
    assert losses == ref["losses"]
    if scales is not None:
        assert scales == ref["scales"]
    for n, v in ref["final_params"].items():
        assert params[n].dtype == torch.float32
        assert torch.equal(params[n], v), n
    rs = ref["opt_state"]
    assert int(opt_state.step) == int(rs.step)
    for n in rs.mu:
        assert torch.equal(opt_state.mu[n], rs.mu[n]), n
        assert torch.equal(opt_state.nu[n], rs.nu[n]), n


def _run_killed(ref, d, actor, fire, stages=S, runtime="threads"):
    """Step a snapshotting session that KillWorker stops at ``actor``'s
    ``fire``: the completed steps' losses and scales, and the newest
    completed snapshot, which must count exactly those steps. Under
    processes the kill is the worker's ``os._exit(57)``, and no worker
    outlives the failed step."""
    sess = api.compile(_graph(ref["axes"]), backend="actors", stages=stages,
                       snapshot_dir=d, runtime=runtime,
                       faults=FaultPlan([KillWorker(actor, fire=fire)]),
                       **_kw(ref["params0"], **ref["extra"]))
    losses, scales, killed, rt = [], [], None, None
    try:
        for _ in range(STEPS):
            r = sess.step(**ref["data"])
            losses.append(float(r.loss))
            scales.append(r.metrics.get("loss_scale"))
    except WorkerError as exc:
        killed, rt = exc, sess.executor._rt
    finally:
        sess.close()
    assert killed is not None, f"kill at {actor} fire {fire} never triggered"
    if runtime == "processes":
        assert f"exit code {KILL_EXIT_CODE}" in str(killed)
        assert killed.node == rt._spec_by_name[actor].node
        assert all(not p.is_alive() for p in rt._procs.values())
        with pytest.raises(RuntimeError, match="died with its workers"):
            sess.params
    # the core snapshot invariant: completed snapshots == completed steps
    n = latest_snapshot(d) or 0
    assert n == len(losses) < STEPS
    return losses, scales, n


def _resume(ref, d, n, losses, scales, **where):
    """Compile from the snapshot (or afresh when none landed), finish the
    run and hold it to the uninterrupted one."""
    kw = _kw(ref["params0"], **ref["extra"])
    kw.update(where)
    res = (api.compile(_graph(ref["axes"]), restore=d, **kw) if n
           else api.compile(_graph(ref["axes"]), **kw))
    try:
        assert res.step_count == n
        for _ in range(STEPS - n):
            r = res.step(**ref["data"])
            losses.append(float(r.loss))
            scales.append(r.metrics.get("loss_scale"))
        _assert_matches_ref(ref, losses, res.params, res.opt_state, scales)
    finally:
        res.close()


def _kill_and_resume(ref, actor, fire, runtime="threads"):
    with tempfile.TemporaryDirectory() as d:
        losses, scales, n = _run_killed(ref, d, actor, fire, runtime=runtime)
        _resume(ref, d, n, losses, scales, backend="actors", stages=S,
                runtime=runtime)


# every fire index of the stage actors over a 3-step run: f{s} and b{s}
# each fire M*STEPS times, opt{s} once per step, and snap0 in step 2
_THREAD_CASES = (
    [(f"f{s}", k) for s in range(S) for k in range(1, M * STEPS + 1)]
    + [(f"b{s}", k) for s in range(S) for k in range(1, M * STEPS + 1)]
    + [(f"opt{s}", k) for s in range(S) for k in range(1, STEPS + 1)]
    + [("snap0", 2)]
)
_IDS = [f"{a}-fire{k}" for a, k in _THREAD_CASES]


class TestKillAndResumeThreads:
    @pytest.mark.parametrize("actor,fire", _THREAD_CASES, ids=_IDS)
    def test_bit_identical(self, ref, actor, fire):
        _kill_and_resume(ref, actor, fire)

    def test_worker_killed_is_a_worker_error(self):
        assert issubclass(WorkerKilled, WorkerError)

    def test_dropped_ack_is_detected_as_a_timeout(self, ref):
        """A swallowed Ack never recycles the producer's register: the
        epoch times out naming the stuck actor instead of finishing with
        wrong bits."""
        sess = api.compile(_graph(), backend="actors", stages=S,
                           regs="serial",
                           faults=FaultPlan([DropAck("b1", "f1", version=0)]),
                           timeout=1.0, **_kw(ref["params0"]))
        try:
            with pytest.raises(TimeoutError, match="did not complete"):
                sess.step(**ref["data"])
        finally:
            sess.close()

    def test_process_mode_and_trace_are_later_items(self, ref):
        """Process mode is ported (a KillWorker there is the worker's
        ``os._exit``, :class:`TestKillAndResumeProcesses`); so is delivery
        tracing (item 12): a traced kill records the deliveries before it
        and the kill itself, which ``check_trace`` certifies."""
        from repro_torch.analysis.trace import TraceRecorder, check_trace
        inj = FaultInjector(FaultPlan([DropAck("b1", "f1")]),
                            process_mode=True)
        assert inj.process_mode and inj.applied == [] and inj.recorder is None
        rec = TraceRecorder()
        sess = api.compile(_graph(), backend="actors", stages=S,
                           faults=FaultPlan([KillWorker("b0", fire=2)]),
                           **_kw(ref["params0"]))
        try:
            sess.executor.trace = rec
            with pytest.raises(WorkerKilled):
                sess.step(**ref["data"])
            specs, _ = sess.executor._make_builder()()
            violations, stats = check_trace(rec, specs)
        finally:
            sess.close()
        assert violations == [] and stats.deliveries > 0
        assert [(f.kind, f.src, f.version) for f in rec.faults] \
            == [("KillWorker", "b0", 2)]


class TestKillAndResumeProcesses:
    """The same contract when the kill is a real ``os._exit`` of a worker
    process: the driver sees the death by its exit code, not an
    exception; the killed session's stage files were written by the stage
    workers, and a processes session restored from them finishes the run
    bitwise."""

    @pytest.mark.parametrize("actor,fire",
                             [("f0", 3), ("b1", 4), ("opt1", 2)],
                             ids=["f0-fire3", "b1-fire4", "opt1-fire2"])
    def test_bit_identical(self, ref, actor, fire):
        _kill_and_resume(ref, actor, fire, runtime="processes")


class TestSnapshotRestoreSurface:
    def test_snapshot_every(self, ref):
        with tempfile.TemporaryDirectory() as d:
            with api.compile(_graph(), stages=S, snapshot_dir=d,
                             snapshot_every=2,
                             **_kw(ref["params0"])) as sess:
                for _ in range(STEPS):
                    sess.step(**ref["data"])
            assert list_snapshots(d) == [2]

    @pytest.mark.parametrize("where", [dict(backend="monolithic"),
                                       dict(backend="actors", stages=1)],
                             ids=["monolithic", "one-stage"])
    def test_restore_onto_another_partition(self, ref, where):
        """Partition-agnostic restore: a snapshot from a 2-stage actor run
        resumes the monolithic engine and a 1-stage pipeline
        bit-identically."""
        with tempfile.TemporaryDirectory() as d:
            with api.compile(_graph(), stages=S, snapshot_dir=d,
                             **_kw(ref["params0"])) as sess:
                losses = [float(sess.step(**ref["data"]).loss)]
            _resume(ref, d, 1, losses, [None], **where)

    def test_load_snapshot_roundtrip(self, ref):
        with tempfile.TemporaryDirectory() as d:
            with api.compile(_graph(), stages=S, snapshot_dir=d,
                             **_kw(ref["params0"])) as sess:
                for _ in range(STEPS):
                    sess.step(**ref["data"])
                want_params, want_opt = sess.params, sess.opt_state
            got_params, got_opt, step, meta = load_snapshot(d)
            assert step == STEPS
            assert meta["num_stages"] == S and meta["stateful"]
            for n, v in want_params.items():
                assert got_params[n].dtype == np.float32
                assert np.array_equal(got_params[n], v.numpy()), n
                assert np.array_equal(got_opt.mu[n], want_opt.mu[n].numpy())
                assert np.array_equal(got_opt.nu[n], want_opt.nu[n].numpy())
            assert int(got_opt.step) == int(want_opt.step) == STEPS
            assert got_opt.step.dtype == np.int32

    def test_restore_empty_dir_raises(self, ref):
        with tempfile.TemporaryDirectory() as d:
            with pytest.raises(FileNotFoundError, match="no completed"):
                api.compile(_graph(), stages=S, restore=d,
                            **_kw(ref["params0"]))
            with pytest.raises(FileNotFoundError, match="no completed"):
                load_snapshot(d)

    def test_train_only_options_rejected(self):
        g = _graph()
        for kw in ({"snapshot_dir": "x"}, {"faults": FaultPlan([])},
                   {"snapshot_every": 2}, {"restore": "x"}):
            with pytest.raises(ValueError, match="mode='train'"):
                api.compile(g, mode="infer", device=CPU, **kw)

    def test_actors_only_options_rejected(self, ref):
        for kw in ({"snapshot_dir": "x"}, {"faults": FaultPlan([])}):
            with pytest.raises(ValueError, match="backend='actors'"):
                api.compile(_graph(), backend="monolithic",
                            **_kw(ref["params0"]), **kw)

    def test_snapshot_every_checked(self, ref):
        with pytest.raises(ValueError, match="snapshot_every= without"):
            api.compile(_graph(), snapshot_every=2, **_kw(ref["params0"]))
        with pytest.raises(ValueError, match="snapshot_every must be >= 1"):
            api.compile(_graph(), snapshot_dir="x", snapshot_every=0,
                        **_kw(ref["params0"]))

    def test_processes_runtime_still_raises(self, ref):
        """runtime='processes' takes snapshot_dir= and faults= (the kill
        cases above); it still raises without stage actors to run."""
        with pytest.raises(ValueError, match="backend='actors'"):
            api.compile(_graph(), backend="monolithic", runtime="processes",
                        snapshot_dir="x", **_kw(ref["params0"]))


class TestZeroKillAndResume:
    """zero=True, bf16 compute, dynamic loss scaling: kill mid-step and
    resume from the flat-row snapshot -- onto the same cut, onto one stage
    and onto the monolithic engine -- bitwise, the scale trajectory
    included."""

    @pytest.mark.parametrize("actor,fire", _THREAD_CASES, ids=_IDS)
    def test_resume_same_partition(self, zref, actor, fire):
        _kill_and_resume(zref, actor, fire)

    @pytest.mark.parametrize("actor,fire", [("f1", 3), ("snap1", 2)],
                             ids=["f1-fire3-proc", "snap1-fire2-proc"])
    def test_resume_same_partition_processes(self, zref, actor, fire):
        """The worker processes' ZeRO snapshots (flat masters read from
        the ``__zero__`` key inside the stage's worker) resume a processes
        session bitwise; ``snap1`` killed in step 2 leaves that step's
        stage-0 files without a MANIFEST."""
        _kill_and_resume(zref, actor, fire, runtime="processes")

    @pytest.mark.parametrize("actor,fire,where", [
        ("opt1", 2, dict(backend="actors", stages=1)),
        ("b0", 5, dict(backend="actors", stages=1)),
        ("f1", 4, dict(backend="monolithic")),
        ("snap0", 3, dict(backend="monolithic"))],
        ids=["opt1-fire2-one-stage", "b0-fire5-one-stage",
             "f1-fire4-monolithic", "snap0-fire3-monolithic"])
    def test_resume_onto_another_partition(self, zref, actor, fire, where):
        with tempfile.TemporaryDirectory() as d:
            losses, scales, n = _run_killed(zref, d, actor, fire)
            _resume(zref, d, n, losses, scales, **where)

    def test_snapshot_holds_flat_rows_and_the_scale(self, zref):
        """The stage files hold the reference's ZeRO layout (flat float32
        ``(1, 1, chunk)`` masters and moments, ``zero_shapes``), the
        MANIFEST the scale to resume with, and ``load_snapshot`` gives full
        tensors back."""
        params = zref["params0"]
        with tempfile.TemporaryDirectory() as d:
            with api.compile(_graph(), backend="actors", stages=S,
                             snapshot_dir=d,
                             **_kw(params, **ZERO_MP)) as sess:
                for _ in range(2):
                    sess.step(**zref["data"])
                scale, good = (sess.executor.loss_scale,
                               sess.executor.scale_good_steps)
            assert scale == 2.0 ** 5 and good == 0
            got_params, got_opt, step, meta = load_snapshot(d)
            assert step == 2 and meta["zero"] is True
            assert meta["loss_scale"] == scale
            assert meta["scale_good_steps"] == good
            w = np.load(stage_dir(d, 2, 0) / "params.w0.npy")
            assert w.shape == (1, 1, W * W) and w.dtype == np.float32
            for n, v in params.items():
                assert got_params[n].shape == v.shape
                assert got_params[n].dtype == np.float32
                assert got_opt.mu[n].shape == v.shape


class TestMeshKillAndResume:
    """A ``("data",) (2,)`` ZeRO mesh of two CPU ranks: the snapshot holds
    the global tensors in the flat ``(2, 1, chunk)`` layout, and a killed
    run resumes bitwise on the mesh and on its monolithic engine."""

    AXES = (("data",), (2,))

    @pytest.fixture(scope="class")
    def mref(self):
        return _uninterrupted(ZERO_MP, axes=self.AXES, seed=3)

    @pytest.mark.parametrize("actor,fire,where", [
        ("b1", 4, dict(backend="actors", stages=S)),
        ("opt0", 3, dict(backend="actors", stages=S)),
        ("f0", 5, dict(backend="monolithic"))],
        ids=["b1-fire4", "opt0-fire3", "f0-fire5-monolithic"])
    def test_bit_identical(self, mref, actor, fire, where):
        with tempfile.TemporaryDirectory() as d:
            losses, scales, n = _run_killed(mref, d, actor, fire)
            for s in range(S):
                w = np.load(stage_dir(d, n, s) / f"params.w{s}.npy")
                assert w.shape == (2, 1, W * W // 2), w.shape
            _resume(mref, d, n, losses, scales, **where)

    def test_restores_onto_one_device(self, mref):
        """The mesh's snapshot restores onto the graph on one device: the
        session's params and moments are the snapshot's global tensors."""
        with tempfile.TemporaryDirectory() as d:
            with api.compile(_graph(self.AXES), backend="actors", stages=S,
                             snapshot_dir=d,
                             **_kw(mref["params0"], **ZERO_MP)) as sess:
                sess.step(**mref["data"])
                want, want_opt = sess.params, sess.opt_state
            with api.compile(_graph(), backend="actors", stages=S,
                             restore=d,
                             **_kw(mref["params0"], **ZERO_MP)) as res:
                assert res.step_count == 1
                for n, v in want.items():
                    assert torch.equal(res.params[n], v), n
                got = res.opt_state
                for n in want_opt.mu:
                    assert torch.equal(got.mu[n], want_opt.mu[n]), n
                    assert torch.equal(got.nu[n], want_opt.nu[n]), n
                assert np.isfinite(float(res.step(**mref["data"]).loss))


class TestSnapshotAliasing:
    """The port updates masters, moments and params in place (the JAX
    package's arrays are immutable, so this hazard is the port's alone):
    the files a step wrote must not change when the session's tensors do
    afterwards, and a restored session must not write into the arrays it
    was restored from."""

    @pytest.mark.parametrize("extra", [{}, ZERO_MP], ids=["adamw", "zero"])
    def test_files_do_not_follow_later_updates(self, ref, extra):
        with tempfile.TemporaryDirectory() as d:
            with api.compile(_graph(), backend="actors", stages=S,
                             snapshot_dir=d, snapshot_every=1,
                             **_kw(ref["params0"], **extra)) as sess:
                sess.step(**ref["data"])
                want = {n: v.clone() for n, v in sess.params.items()}
                st = sess.opt_state
                want_mu = {n: v.clone() for n, v in st.mu.items()}
                ex = sess.executor
                with torch.no_grad():
                    for shards in ex.shards.values():
                        for x in shards:
                            x.add_(1.0)
                    for ranks in ex.opt_states.values():
                        for rs in ranks:
                            for x in list(rs.mu.values()) + list(
                                    rs.nu.values()):
                                x.mul_(3.0)
                sess.step(**ref["data"])
                assert not torch.equal(sess.params["w0"], want["w0"])
            params, opt_state, _, _ = load_snapshot(d, step=1)
            for n, v in want.items():
                assert np.array_equal(params[n], v.numpy()), n
                assert np.array_equal(opt_state.mu[n], want_mu[n].numpy())

    def test_restore_does_not_write_into_its_source(self, ref):
        with tempfile.TemporaryDirectory() as d:
            with api.compile(_graph(), stages=S, snapshot_dir=d,
                             **_kw(ref["params0"])) as sess:
                sess.step(**ref["data"])
            params, opt_state, step, _ = load_snapshot(d)
        before = ({n: v.copy() for n, v in params.items()},
                  {n: v.copy() for n, v in opt_state.mu.items()})
        with api.compile(_graph(), stages=S, **_kw(ref["params0"])) as res:
            res.load_state(params=params, opt_state=opt_state, step=step)
            res.step(**ref["data"])
        for n in params:
            assert np.array_equal(params[n], before[0][n]), n
            assert np.array_equal(opt_state.mu[n], before[1][n]), n
