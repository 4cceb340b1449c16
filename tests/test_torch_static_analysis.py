"""The port's static plan verifier (``repro_torch.analysis``).

The counterparts of ``tests/test_static_analysis.py`` on ``repro_torch``
(``device="cpu"``; no jax is imported). Oracle soundness in both
directions: every plan the real compile paths produce must PASS, and
hand-built bad plans -- a quota-starved cycle, an illegal split signature,
a partial value leaking through a sink -- must be rejected at compile time
with the offending cycle or edge named, before any actor fires. The
skeletons are pinned field by field against the port's own builders
(infer, train with every optional actor, serve), and the check runs in
every mode, backend and runtime without building a runtime.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import analysis, api
from repro_torch.analysis import membound
from repro_torch.analysis.__main__ import main as analysis_cli
from repro_torch.analysis.deadlock import (check_deadlock, min_feasible_regs,
                                           min_feasible_stage_regs)
from repro_torch.analysis.sbp_check import check_sbp
from repro_torch.analysis.skeleton import (infer_spec_skeleton,
                                           serve_spec_skeleton,
                                           train_spec_skeleton)
from repro_torch.analysis.trace import TraceRecorder, check_trace
from repro_torch.configs.registry import get_config
from repro_torch.core.graph import LogicalGraph, partition_stages
from repro_torch.core.lowering import OptimizerSpec
from repro_torch.core.placement import Placement
from repro_torch.core.planner import plan as plan_sbp
from repro_torch.core.sbp import NdSbp
from repro_torch.runtime.actor import ActorSpec
from repro_torch.runtime.chaos import DelayEdge, DuplicateReq, FaultPlan
from repro_torch.runtime.pipeline import _validate_regs
from repro_torch.runtime.threaded import ThreadedRuntime, _LocalEngine
from repro_torch.serve.paged_cache import dense_bytes, slab_bytes

CPU = "cpu"
B, W, S, M = 8, 8, 2, 2
SERVE_GEOMETRY = dict(num_groups=2, group_size=1, max_prompt_len=8,
                      max_new_tokens=4, cache_len=16)


def _noop(*args):
    return 0


def _train_graph(placement=None):
    g = LogicalGraph(placement or Placement(("d",), (1,)))
    h = g.input("x", (B, W))
    labels = g.input("labels", (B,), dtype="int32")
    for i in range(S):
        w = g.input(f"w{i}", (W, W))
        h = g.matmul(h, w, name=f"mm{i}")
        if i < S - 1:
            h = g.unary(h, "relu", name=f"relu{i}")
    g.softmax_xent(h, labels, name="loss")
    return g


def _train_params(rng=None):
    rng = rng or np.random.default_rng(0)
    return {f"w{i}": (rng.normal(size=(W, W)) * 0.1).astype(np.float32)
            for i in range(S)}


def _train_data(rng=None):
    rng = rng or np.random.default_rng(1)
    return {"x": rng.normal(size=(B, W)).astype(np.float32),
            "labels": rng.integers(0, W, size=(B,)).astype(np.int32)}


def _compile_train(**kw):
    kw.setdefault("stages", S)
    kw.setdefault("num_microbatches", M)
    return api.compile(kw.pop("graph", None) or _train_graph(), mode="train",
                       params=dict(_train_params()), device=CPU, **kw)


def _starved_cycle_specs(a_regs=1):
    """The canonical quota-starved cycle: C needs a second token from A, but
    A's sole register is parked waiting for X's ack, and X cannot fire its
    second time until C releases A's register -- a three-way wait cycle
    fixed by giving A a second register."""
    return [
        ActorSpec("A", fn=_noop, inputs=(), out_regs=a_regs, max_fires=2),
        ActorSpec("X", fn=_noop, inputs=("A",), out_regs=1, max_fires=2,
                  emit_every=2),
        ActorSpec("C", fn=_noop, inputs=("A", "X"), out_regs=1, max_fires=1),
    ]


def _leaky_plan(g):
    """The planned signatures of ``g`` with its sink made a partial value
    and its epilogue materialization dropped."""
    plan = plan_sbp(g)
    sink = g.sinks()[0].name
    return sink, dataclasses.replace(
        plan, tensor_sbp={**plan.tensor_sbp, sink: NdSbp.parse("P")},
        boxings=[b for b in plan.boxings if b[1] != "__epilogue__"])


class TestDeadlockPass:
    def test_1f1b_train_skeleton_is_live(self):
        for stages, mb in [(2, 4), (4, 8), (3, 3)]:
            specs = train_spec_skeleton(stages, mb, clip=True, dynamic=True,
                                        stateful=True, snapshot=True)
            result = check_deadlock(specs)
            assert result.ok, (stages, mb, result)
            assert all(result.fired[n] == result.required[n]
                       for n in result.fired)

    def test_serial_quotas_are_live(self):
        specs = train_spec_skeleton(4, 8, [1, 1, 1, 1])
        assert check_deadlock(specs).ok

    def test_infer_and_serve_skeletons_are_live(self):
        assert check_deadlock(infer_spec_skeleton(3, 5)).ok
        assert check_deadlock(serve_spec_skeleton(2, round_items=4)).ok

    def test_quota_starved_cycle_is_rejected_with_cycle_named(self):
        result = check_deadlock(_starved_cycle_specs())
        assert not result.ok
        assert set(result.cycle) == {"A", "X", "C"}
        (violation,) = analysis.deadlock_violations(result)
        assert violation.pass_name == "deadlock"
        assert "quota-starved cycle" in violation.message
        assert " -> ".join(result.cycle + (result.cycle[0],)) \
            == violation.subject

    def test_min_feasible_regs_fixes_the_cycle(self):
        feasible = min_feasible_regs(_starved_cycle_specs())
        assert feasible == {"A": 2, "X": 1}
        fixed = _starved_cycle_specs(a_regs=feasible["A"])
        assert check_deadlock(fixed).ok

    def test_pure_starvation_has_no_cycle(self):
        specs = [
            ActorSpec("A", fn=_noop, inputs=(), out_regs=2, max_fires=1),
            ActorSpec("C", fn=_noop, inputs=("A",), out_regs=1, max_fires=3),
        ]
        result = check_deadlock(specs)
        assert not result.ok and result.cycle == ()
        (violation,) = analysis.deadlock_violations(result)
        assert "starvation" in violation.message
        assert min_feasible_regs(specs) is None  # no quota fixes a rate gap

    def test_unbounded_source_needs_fires(self):
        specs = [ActorSpec("src", fn=_noop, inputs=(), out_regs=1),
                 ActorSpec("sink", fn=_noop, inputs=("src",), out_regs=1,
                           max_fires=2)]
        with pytest.raises(ValueError, match="unbounded source"):
            check_deadlock(specs)
        assert check_deadlock(specs, fires={"src": 2}).ok

    def test_unknown_producer_is_rejected(self):
        specs = [ActorSpec("sink", fn=_noop, inputs=("ghost",), out_regs=1,
                           max_fires=1)]
        with pytest.raises(ValueError, match="unknown producer"):
            check_deadlock(specs)

    def test_min_feasible_stage_regs(self):
        regs = min_feasible_stage_regs(4, 8)
        assert len(regs) == 4 and all(r >= 1 for r in regs)
        specs = train_spec_skeleton(4, 8, regs)
        assert check_deadlock(specs).ok


class TestSbpPass:
    def test_real_plans_pass(self):
        g = _train_graph()
        plan = plan_sbp(g)
        violations, checked = check_sbp(g, plan, partition_stages(g, S))
        assert violations == [] and checked > 0

    def test_split_indivisibility_names_the_tensor(self):
        g = LogicalGraph(Placement(("d",), (2,)))
        x = g.input("x", (3, 8))
        w = g.input("w", (8, 8))
        g.matmul(x, w, name="y")
        plan = plan_sbp(g)
        bad = dataclasses.replace(
            plan, tensor_sbp={**plan.tensor_sbp, "x": NdSbp.parse("S(0)")})
        violations, _ = check_sbp(g, bad)
        assert any(v.subject == "x" and "illegal for shape" in v.message
                   for v in violations)

    def test_partial_leaking_through_sink_is_named(self):
        g = _train_graph()
        sink, bad = _leaky_plan(g)
        violations, _ = check_sbp(g, bad)
        assert any(v.subject == sink and "leaks through a graph sink"
                   in v.message for v in violations)

    def test_partial_crossing_stage_boundary_is_named(self):
        g = _train_graph()
        plan = plan_sbp(g)
        part = partition_stages(g, S)
        # relu0.out is the stage-0 -> stage-1 boundary tensor
        bad = dataclasses.replace(
            plan, tensor_sbp={**plan.tensor_sbp,
                              "relu0.out": NdSbp.parse("P")})
        violations, _ = check_sbp(g, bad, part)
        assert any("crosses the stage" in v.message for v in violations)
        # with the lowering's materialized boundary signatures the same plan
        # is fine: no partial actually crosses
        materialized = {"relu0.out": NdSbp.parse("B")}
        violations, _ = check_sbp(g, bad, part, boundary_sbp=materialized)
        assert not any("crosses the stage" in v.message for v in violations)


class TestCompileCheck:
    def test_every_mode_backend_passes_by_default(self):
        for backend in ("actors", "monolithic"):
            kw = {} if backend == "monolithic" else dict(stages=S)
            with _compile_train(backend=backend, **kw) as sess:
                assert sess.static_report.verdict == "PASS"
                assert "static analysis: PASS" in sess.describe()
                assert "static peak bytes" in sess.describe()

    def test_bad_plan_is_rejected_before_any_fire(self, monkeypatch):
        """No actor engine starts an epoch (the compile-time register
        planner's simulated fires are not the runtime's)."""
        epochs = []
        monkeypatch.setattr(_LocalEngine, "start_epoch",
                            lambda self, *a, **k: epochs.append(self))
        g = _train_graph()
        _, bad = _leaky_plan(g)
        with pytest.raises(analysis.AnalysisError,
                           match="leaks through a graph sink"):
            _compile_train(graph=g, plan=bad)
        assert epochs == []

    def test_check_off_skips(self):
        sess = _compile_train(backend="monolithic", check="off")
        assert sess.static_report.verdict == "SKIPPED"
        assert "static analysis: skipped" in sess.describe()

    def test_unknown_check_value_is_rejected(self):
        with pytest.raises(ValueError, match="unknown check"):
            _compile_train(backend="monolithic", check="sometimes")

    def test_run_session_checks_is_rerunnable(self):
        with _compile_train() as sess:
            report = analysis.run_session_checks(sess)
            assert report.verdict == "PASS"
            assert report.checked_channels > 0
            assert all(v > 0 for v in report.peak_bytes_per_device.values())

    @pytest.mark.parametrize("mode", ["infer", "train"])
    @pytest.mark.parametrize("runtime", ["threads", "processes"])
    def test_graph_modes_and_runtimes_pass(self, mode, runtime):
        """The check reads the driver's lowered program: no runtime (and
        under processes no worker) exists after compile."""
        if mode == "train":
            sess = _compile_train(runtime=runtime)
            passes = ("deadlock", "sbp", "memory")
        else:
            sess = api.compile(_train_graph(), mode="infer", stages=S,
                               num_microbatches=M, microbatch_inputs=["x"],
                               runtime=runtime, device=CPU)
            passes = ("deadlock", "sbp", "memory")
        with sess:
            assert sess.static_report.verdict == "PASS"
            assert sess.static_report.passes == passes
            assert sess.executor._rt is None

    @pytest.mark.parametrize("backend,cache", [
        ("actors", "dense"), ("actors", "paged"), ("monolithic", "dense")])
    def test_serve_sessions_pass(self, backend, cache):
        cfg = get_config("qwen3-1.7b").reduced()
        kw = dict(stages=2) if backend == "actors" else {}
        with api.compile(cfg, mode="serve", backend=backend, cache=cache,
                         device=CPU, **kw, **SERVE_GEOMETRY) as sess:
            rep = sess.static_report
            assert rep.verdict == "PASS"
            assert rep.passes == (("deadlock", "memory")
                                  if backend == "actors" else ("memory",))
            assert set(rep.peak_bytes_per_device) == {
                f"stage{s}" for s in range(sess.sstaged.num_stages)}
            assert "static analysis: PASS" in sess.describe()
            if backend == "actors":
                # the check built no runtime, and the specs it builds hold
                # stage caches that reserve nothing until a first fire
                assert sess.executor._rt is None
                specs, _ = sess.executor._make_builder()()
                caches = [sp.fn.cache for sp in specs
                          if sp.name.startswith("stage")]
                assert len(caches) == 2 and all(
                    c.caches == {} if cache == "dense" else c.slabs is None
                    for c in caches)


class TestSkeletonParity:
    """The dummy-fn skeletons must mirror the port's executor topologies
    field by field, or the CLI/min-regs search analyzes a different network
    than the one that runs."""

    @staticmethod
    def _key(s):
        return (s.name, tuple(s.inputs), s.out_regs, s.max_fires,
                s.emit_every, s.node, s.thread)

    def test_infer_topology_matches(self):
        sess = api.compile(_train_graph(), mode="infer", backend="actors",
                           stages=S, num_microbatches=4,
                           microbatch_inputs=["x"], device=CPU)
        with sess:
            real, _ = sess._engine._make_builder()()
            skel = infer_spec_skeleton(S, 4, sess.regs)
            assert sorted(map(self._key, real)) \
                == sorted(map(self._key, skel))

    def test_train_topology_matches(self):
        opt = OptimizerSpec.adamw(lr=1e-3, grad_clip=1.0)
        with _compile_train(optimizer=opt) as sess:
            real, _ = sess._engine._make_builder()()
            skel = train_spec_skeleton(S, M, sess.regs, clip=True,
                                       stateful=True)
            assert sorted(map(self._key, real)) \
                == sorted(map(self._key, skel))

    def test_train_topology_with_every_optional_actor_matches(self,
                                                              tmp_path):
        """Dynamic loss scaling (``norm`` + ``scale``), AdamW state streams
        and ``snap{s}`` writers on thread 1."""
        with _compile_train(optimizer=OptimizerSpec.adamw(lr=1e-3),
                            precision="bf16", loss_scale="dynamic",
                            snapshot_dir=str(tmp_path)) as sess:
            real, _ = sess._engine._make_builder()()
            skel = train_spec_skeleton(S, M, sess.regs, dynamic=True,
                                       stateful=True, snapshot=True)
            assert sorted(map(self._key, real)) \
                == sorted(map(self._key, skel))

    def test_serve_topology_matches(self):
        cfg = get_config("qwen3-1.7b").reduced()
        with api.compile(cfg, mode="serve", stages=2, regs=[1, 2],
                         device=CPU, **SERVE_GEOMETRY) as sess:
            real, _ = sess._engine._make_builder()()
            n = sess.num_groups
            real = [dataclasses.replace(s, max_fires=n) for s in real]
            skel = serve_spec_skeleton(2, [1, 2], round_items=n)
            assert sorted(map(self._key, real)) \
                == sorted(map(self._key, skel))


class TestQuotaValidation:
    def test_zero_quota_error_reports_feasible_vector(self):
        with pytest.raises(ValueError) as err:
            _validate_regs([2, 0, 1], 3, 4)
        assert "minimal feasible quotas" in str(err.value)
        assert "stage 1" in str(err.value)
        assert "[1, 1, 1]" in str(err.value)

    def test_compile_rejects_zero_quota_with_feasible_vector(self):
        with pytest.raises(ValueError, match="minimal feasible quotas"):
            _compile_train(regs=[1, 0])


class TestMemoryBound:
    def test_train_bound_covers_measured_peak(self):
        with _compile_train() as sess:
            sess.step(**_train_data())
            bound = sum(sess.static_report.peak_bytes_per_device.values())
            measured = sess._engine.peak_inflight_activations
            assert bound >= measured > 0

    def test_optimizer_state_streams_are_counted(self):
        with _compile_train(optimizer=OptimizerSpec.adamw(lr=1e-3)) as sess, \
                _compile_train() as sgd:
            adamw_bytes = sum(
                sess.static_report.peak_bytes_per_device.values())
            sgd_bytes = sum(sgd.static_report.peak_bytes_per_device.values())
            # AdamW adds the m/v moment streams on top of the same pipeline
            assert adamw_bytes > sgd_bytes

    def test_zero_bound_covers_held_state(self):
        """ZeRO + bf16 over float32 masters, as the card's 4-stage graph
        runs it (one data rank): per stage, the bound is at least what the
        masters, the moments and the float32 accumulator hold after a
        step. (On a data mesh each rank still holds its whole flat state
        while the bound counts 1 / dp of it: ROADMAP Queue 1 item 19.)"""
        with _compile_train(optimizer=OptimizerSpec.adamw(lr=1e-3),
                            zero=True, precision="bf16") as sess:
            sess.step(**_train_data())
            bound = sess.static_report.peak_bytes_per_device
            eng = sess.executor
            for st in eng.tstaged.stages:
                (rs,) = eng.opt_states[st.index]
                moments = sum(t.nbytes for t in (*rs.mu.values(),
                                                 *rs.nu.values()))
                masters = sum(eng.shards[n][0].nbytes
                              for n in st.param_names)
                accumulator = 4 * sum(eng.shards[n][0].numel()
                                      for n in st.param_names)
                held = moments + masters + accumulator
                assert bound[f"stage{st.index}"] >= held > 0

    def test_serve_bound_is_the_cache_reservation_plus_payload(self):
        cfg = get_config("qwen3-1.7b").reduced()
        for cache in ("dense", "paged"):
            with api.compile(cfg, mode="serve", stages=2, cache=cache,
                             device=CPU, **SERVE_GEOMETRY) as sess:
                bound = sess.static_report.peak_bytes_per_device
                regs = sess.regs
                hidden = sess.group_size * cfg.d_model * 4
                logits = sess.group_size * cfg.padded_vocab() * 4
                total = 0
                for st in sess.sstaged.stages:
                    t = st.init_caches(sess.group_size, device="meta")
                    cache_b = (slab_bytes(t, sess.cache_spec)
                               if cache == "paged"
                               else dense_bytes(t, sess.num_groups))
                    total += cache_b
                    payload = logits if st.last else hidden
                    assert bound[f"stage{st.index}"] \
                        == regs[st.index] * payload + cache_b
                assert total == sess.cache_bytes()


    @pytest.mark.parametrize("cache", ["dense", "paged"])
    def test_serve_cache_term_is_what_the_stages_hold(self, cache):
        """After a run that reaches every slot group, each stage's cache
        term is what its actor's cache holds: the dense group blocks, or
        the pages plus the page table and cursors the reference counts
        (the slabs' two sentinel rows a leaf are outside the count)."""
        cfg = get_config("qwen3-1.7b").reduced()
        rng = np.random.default_rng(0)
        reqs = [(rng.integers(0, cfg.vocab_size, 8).astype(np.int32), 4)
                for _ in range(3)]
        with api.compile(cfg, mode="serve", stages=2, cache=cache,
                         device=CPU, **SERVE_GEOMETRY) as sess:
            sess.generate(reqs)
            terms = membound.serve_cache_bound(
                sess.sstaged, sess.num_groups, cache, sess.cache_spec)
            for s, c in enumerate(sess.executor.stage_caches):
                if cache == "dense":
                    held = sum(t.nbytes for group in c.caches.values()
                               for layer in group for t in layer.values())
                    assert len(c.caches) == sess.num_groups
                    assert held == terms[f"stage{s}"]
                    continue
                spec = sess.cache_spec
                index = spec.max_requests * (spec.pages_per_req + 2) * 4
                pages = sum(t.nbytes for layer in c.pages()
                            for t in layer.values())
                slabs = sum(t.nbytes for layer in c.slabs
                            for t in layer.values())
                assert pages == terms[f"stage{s}"] - index
                row = cfg.num_kv_heads * cfg.head_dim * 4
                assert slabs - pages == 2 * row * sum(
                    len(layer) for layer in c.slabs)


class TestTraceSanitizer:
    def test_clean_run_has_canonical_trace(self):
        rec = TraceRecorder()
        with _compile_train() as sess:
            sess.executor.trace = rec
            data = _train_data()
            sess.step(**data)
            sess.step(**data)
            specs, _ = sess._engine._make_builder()()
            violations, stats = check_trace(rec, specs)
            assert violations == []
            assert stats.deliveries > 0 and stats.duplicates_dropped == 0
            assert {ev.epoch for ev in rec.deliveries} == {1, 2}

    def test_chaos_faults_are_absorbed_and_certified(self):
        plan = FaultPlan((DuplicateReq("f0", "f1", version=0),
                          DelayEdge("f1", "b1", seconds=0.02, version=1)))
        rec = TraceRecorder()
        with _compile_train(faults=plan) as sess:
            sess.executor.trace = rec
            sess.step(**_train_data())
            specs, _ = sess._engine._make_builder()()
            violations, stats = check_trace(rec, specs)
            assert violations == []
            assert stats.duplicates_dropped == 1
            assert stats.faults == 2
            assert [f.kind for f in rec.faults] \
                == [k for k, *_ in sess.executor.runtime.fault_injector
                    .applied]

    def test_corrupted_trace_is_flagged(self):
        specs = [ActorSpec("p", fn=_noop, inputs=(), out_regs=2, max_fires=2),
                 ActorSpec("c", fn=_noop, inputs=("p",), out_regs=1,
                           max_fires=2)]
        rec = TraceRecorder()
        rec.record_delivery("c", "p", 1, (1,), 1)  # released out of order
        rec.record_delivery("c", "p", 0, (0,), 1)
        violations, _ = check_trace(rec, specs)
        assert any("canonical stride-1 order" in v.message
                   for v in violations)

    def test_trace_requires_threads_runtime(self):
        from repro_torch.runtime.base import make_runtime
        with pytest.raises(ValueError, match="requires runtime='threads'"):
            make_runtime("processes", lambda: ([], None),
                         trace=TraceRecorder())

    def test_threaded_runtime_records_strided_deliveries(self):
        """An ``emit_every=2`` producer's channel releases versions 1, 3
        in order, and ``make_runtime`` hands the recorder through."""
        from repro_torch.runtime.base import make_runtime
        specs = [ActorSpec("p", fn=_noop, inputs=(), out_regs=1, max_fires=4,
                           emit_every=2),
                 ActorSpec("c", fn=_noop, inputs=("p",), out_regs=1,
                           max_fires=2)]
        rec = TraceRecorder()
        with make_runtime("threads", lambda: (specs, "c"), trace=rec) as rt:
            assert isinstance(rt, ThreadedRuntime)
            rt.run(timeout=10.0)
        assert [ev.released for ev in rec.deliveries] == [(1,), (3,)]
        assert check_trace(rec, specs)[0] == []


class TestCLI:
    def test_cli_passes_on_zoo_config(self, capsys):
        rc = analysis_cli(["qwen3-1.7b", "--stages", "2", "--regs", "1f1b",
                           "--microbatches", "4"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "static analysis: PASS" in out
        assert "analyzer wall time" in out

    def test_cli_infer_mode_and_explicit_regs(self, capsys):
        rc = analysis_cli(["qwen3-1.7b", "--stages", "2", "--regs", "1,1",
                           "--mode", "infer"])
        assert rc == 0

    def test_cli_rejects_wrong_quota_count(self, capsys):
        rc = analysis_cli(["qwen3-1.7b", "--stages", "2", "--regs", "1,2,3"])
        assert rc == 2


class TestStageBoundaryBound:
    def test_plan_level_bound_without_lowering(self):
        g = _train_graph()
        plan = plan_sbp(g)
        part = partition_stages(g, S)
        bound = membound.stage_boundary_bound(g, plan, part, [2, 1], M)
        assert set(bound) == {"stage0", "stage1"}
        assert all(v >= 0 for v in bound.values())


def test_analysis_imports_no_jax():
    """The subpackage and its CLI run with jax and the reference package
    blocked from import."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from repro_torch.analysis.__main__ import main\n"
        "sys.exit(main(['qwen3-1.7b', '--stages', '4']))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "static analysis: PASS" in res.stdout
