"""The port's threaded actor runtime, and the rule that it stands alone.

Cases from ``tests/test_actor_runtime.py`` run on
:class:`repro_torch.runtime.ThreadedRuntime`. The import guard runs every
module of ``repro_torch`` in a fresh interpreter and checks that jax never
loads; an AST scan checks that no module of the port, nor ``chip_smoke.py``,
imports ``jax`` or the JAX package ``repro``.
"""
import ast
import os
import pkgutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import api
from repro_torch.runtime import (ActorSpec, ThreadedRuntime, make_actor_id,
                                 make_runtime, parse_actor_id)
from repro_torch.runtime.pipeline import (ServePipelineExecutor, serve_regs,
                                          serve_stage_actor_specs)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _noop(*a):
    return 0


# ---------------------------------------------------------------------------
# addressing and the threaded runtime (cases of test_actor_runtime.py)
# ---------------------------------------------------------------------------

def test_actor_id_roundtrip_at_field_maxima():
    fields = ((1 << 12) - 1, (1 << 12) - 1, (1 << 8) - 1, (1 << 32) - 1)
    assert parse_actor_id(make_actor_id(*fields)) == fields
    assert parse_actor_id(make_actor_id(3, 7, 2, 12345)) == (3, 7, 2, 12345)


@pytest.mark.parametrize("field,bad", [
    ("node", (1 << 12, 0, 0, 0)), ("thread", (0, 1 << 12, 0, 0)),
    ("queue", (0, 0, 1 << 8, 0)), ("actor", (0, 0, 0, 1 << 32))])
def test_actor_id_field_rejected_past_its_width(field, bad):
    with pytest.raises(ValueError, match=field):
        make_actor_id(*bad)


def test_real_threads_compute():
    acc = []
    specs = [
        ActorSpec("src", lambda: len(acc), (), out_regs=2, max_fires=20,
                  node=0, thread=0),
        ActorSpec("sq", lambda x: x * x, ("src",), out_regs=2, node=0,
                  thread=1),
        ActorSpec("sink", lambda x: acc.append(x), ("sq",), out_regs=1,
                  node=0, thread=2),
    ]
    outs = ThreadedRuntime(specs, collect_outputs_of="sq").run(timeout=30.0)
    assert len(outs) == 20 and len(acc) == 20


def test_worker_exception_propagates():
    def boom(x):
        raise RuntimeError("kaboom")
    specs = [ActorSpec("src", _noop, (), out_regs=1, max_fires=3, thread=0),
             ActorSpec("bad", boom, ("src",), out_regs=1, thread=1)]
    with pytest.raises(RuntimeError, match="kaboom"):
        ThreadedRuntime(specs).run(timeout=10.0)


def test_run_is_reusable_with_fires_and_ctx():
    """One runtime, many epochs: per-epoch ``fires`` and ``ctx`` (a serve
    round's work count and items), counters inspectable between runs."""
    base = [10]

    def set_base(v):
        if v is not None:
            base[0] = v

    specs = [
        ActorSpec("src", lambda version: base[0] + version, (), out_regs=2,
                  max_fires=0, thread=0, wants_version=True,
                  on_epoch=set_base),
        ActorSpec("sink", lambda x: x, ("src",), out_regs=1, thread=1),
    ]
    rt = make_runtime("threads", lambda: (specs, "sink"))
    assert rt.run(fires={"src": 2}, timeout=30.0) == [10, 11]
    assert rt.last_fired == {"src": 2, "sink": 2}
    assert rt.run(ctx={"src": 100}, fires={"src": 3},
                  timeout=30.0) == [100, 101, 102]
    with pytest.raises(ValueError, match="unknown actor"):
        rt.run(ctx={"nope": 1}, fires={"src": 1})


def test_back_pressure_bounds_registers():
    """A producer never holds more out-registers than its quota, however
    slow its consumer (credit-based flow control, paper section 4.3)."""
    gate = threading.Semaphore(0)
    specs = [
        ActorSpec("fast", lambda version: version, (), out_regs=2,
                  max_fires=12, thread=0, wants_version=True),
        ActorSpec("slow", lambda x: gate.acquire(timeout=5.0) and x,
                  ("fast",), out_regs=1, thread=1),
    ]
    rt = ThreadedRuntime(specs, collect_outputs_of="slow")
    for _ in range(12):
        gate.release()
    assert rt.run(timeout=30.0) == list(range(12))
    assert rt.last_peak_regs["fast"] <= 2


def test_timeout_names_unfired_actors():
    gate = threading.Event()
    specs = [ActorSpec("src", lambda: gate.wait(timeout=30.0), (),
                       out_regs=1, max_fires=3, thread=0),
             ActorSpec("sink", lambda x: x, ("src",), out_regs=1, thread=1)]
    try:
        with pytest.raises(TimeoutError, match=r"src=\d/3"):
            ThreadedRuntime(specs).run(timeout=0.3)
    finally:
        gate.set()


def test_unported_options_raise_naming_roadmap():
    """The unported option (``fn_wrap``, item 14) raises naming its item;
    the process runtime is ported (item 11) and refuses only what cannot
    reach a worker: a builder that does not pickle, an executor without a
    recipe, a processes serve compiled with no card. The static verifier
    and delivery tracing are ported (item 12): ``trace=`` is taken by the
    threads runtime and refused by the process runtime, and ``check=``
    takes ``"static"`` or ``"off"`` only."""
    from repro_torch.analysis.trace import TraceRecorder
    rec = TraceRecorder()
    assert ThreadedRuntime([], trace=rec)._engine.trace_recorder is rec
    with pytest.raises(ValueError, match="requires runtime='threads'"):
        make_runtime("processes", lambda: ([], None), trace=rec)
    with pytest.raises(ValueError, match="picklable spec builder"):
        make_runtime("processes", lambda: ([], None))
    with pytest.raises(ValueError, match="recipe"):
        ServePipelineExecutor(None, runtime="processes")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.compile("qwen3-1.7b", runtime="processes")
    with pytest.raises(ValueError, match="unknown check"):
        api.compile("qwen3-1.7b", device="cpu", check="static-ish")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 14"):
        api.compile("qwen3-1.7b", device="cpu", fn_wrap=lambda s, fn: fn)


def test_serve_actors_take_the_1f1b_quotas():
    """Stage s of S serve actors holds ``max(1, S - s)`` out-registers, and
    the admit source 2, whatever the stage count."""
    from types import SimpleNamespace
    for S, want in ((1, [1]), (2, [2, 1]), (4, [4, 3, 2, 1])):
        staged = SimpleNamespace(
            num_stages=S, group_size=1, cache_len=4,
            stages=[SimpleNamespace(last=s == S - 1) for s in range(S)])
        specs, final = serve_stage_actor_specs(staged)
        assert final == f"stage{S - 1}"
        assert {sp.name: sp.out_regs for sp in specs} == {
            "admit": 2, **{f"stage{s}": r for s, r in enumerate(want)}}
        assert serve_regs(S) == want


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_port_imports_without_jax():
    """Every module of the port imports in a fresh interpreter, and jax is
    not among the loaded modules afterwards."""
    mods = _port_modules()
    assert {"repro_torch.api", "repro_torch.launch.serve",
            "repro_torch.launch.train", "repro_torch.train.steps",
            "repro_torch.models.mamba", "repro_torch.kernels.ssd_scan.kernel",
            "repro_torch.kernels.ssd_scan.ref"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' "
            "or k.startswith('jax.') or k == 'repro' "
            "or k.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_repro(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_port_entry_point_raises_without_card(monkeypatch):
    """``device=None`` means the card; with none present the entry point
    raises instead of falling back to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.resolve_device(None)
    from repro_torch.configs.registry import get_config
    from repro_torch.models.common import MeshPlan
    from repro_torch.models.model_zoo import build_model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config("qwen3-1.7b").reduced(),
                    MeshPlan.single_device())
    assert api.resolve_device("cpu").type == "cpu"
    assert np.array_equal(
        api.greedy_from_logits(torch.tensor([[0.0, 5.0, 9.0]]), 2).numpy(),
        [1])
