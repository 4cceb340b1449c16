"""The port's static plan verifier against the JAX package's, report for
report.

The same graph, plan, partition, quotas and microbatches are compiled in
both packages, and the two ``StaticReport``s must agree field for field:
verdict, violation texts, ``checked_edges``, ``checked_channels``,
``peak_bytes_per_device``, ``min_feasible_regs`` and ``passes``. The cases
(:data:`CASES`, one source executed in both processes):

* infer and train x actors and monolithic, 4 stages, 1F1B quotas, AdamW
  with a global-norm clip;
* ZeRO + bf16 compute on a 2-rank data mesh (actors and monolithic);
* reduced qwen3 served in float32: actors dense, actors paged, monolithic;
* one bad plan of each kind: a P sink leak (raised by ``compile``), an
  indivisible split, a P across a stage boundary, a quota-starved cycle.

Both CLIs must also print the same lines on the same arguments, the wall
time aside. The JAX side runs once per module in a subprocess with 8 host
devices (the 2-rank mesh) and writes its reports as JSON; the port runs in
process on the CPU.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("jax")

from repro_torch import analysis, api  # noqa: E402
from repro_torch.analysis.__main__ import main as port_cli  # noqa: E402
from repro_torch.core.graph import LogicalGraph, partition_stages  # noqa: E402
from repro_torch.core.lowering import OptimizerSpec  # noqa: E402
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.core.planner import plan  # noqa: E402
from repro_torch.core.sbp import NdSbp  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.runtime.actor import ActorSpec  # noqa: E402

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")

#: the report-building code both packages run; ``ns`` holds the package's
#: api, analysis, graph and config names, and ``KW`` / ``SERVE_KW`` the
#: compile options only one package takes (the port's device, the
#: reference's Auto-axes serving mesh)
CASES = r'''
import dataclasses
import numpy as np

B, W, STAGES, M = 16, 16, 4, 4
SERVE_GEOMETRY = dict(num_groups=2, group_size=1, max_prompt_len=8,
                      max_new_tokens=4, cache_len=16)
CLI_ARGS = [
    ["qwen3-1.7b", "--stages", "4"],
    ["deepseek-v3-671b", "--stages", "8"],
    ["qwen3-1.7b", "--stages", "2", "--regs", "1,1", "--mode", "infer"],
    ["qwen3-1.7b", "--stages", "4", "--regs", "gpipe",
     "--microbatches", "4"],
    ["qwen3-1.7b", "--stages", "2", "--regs", "0,1"],
]


def _noop(*args):
    return 0


def as_dict(report):
    return {"verdict": report.verdict,
            "violations": [[v.pass_name, v.subject, v.message]
                           for v in report.violations],
            "checked_edges": report.checked_edges,
            "checked_channels": report.checked_channels,
            "peak_bytes_per_device": dict(report.peak_bytes_per_device),
            "min_feasible_regs": report.min_feasible_regs,
            "passes": list(report.passes)}


def train_graph(ns, placement, rows="B"):
    g = ns["LogicalGraph"](placement)
    h = g.input("x", (B, W), sbp=rows)
    labels = g.input("labels", (B,), dtype="int32", sbp=rows)
    for i in range(STAGES):
        h = g.matmul(h, g.input(f"w{i}", (W, W)), name=f"mm{i}")
        if i < STAGES - 1:
            h = g.unary(h, "relu", name=f"relu{i}")
    g.softmax_xent(h, labels, name="loss")
    return g


def train_params():
    rng = np.random.default_rng(0)
    return {f"w{i}": (rng.normal(size=(W, W)) * 0.1).astype(np.float32)
            for i in range(STAGES)}


def reports(ns):
    api, an, P = ns["api"], ns["analysis"], ns["Placement"]
    O, Sbp, kw = ns["OptimizerSpec"], ns["NdSbp"], ns["KW"]
    one = lambda: P(("d",), (1,))                      # noqa: E731
    out = {}

    def schedule(backend):
        return (dict(stages=STAGES, regs="1f1b") if backend == "actors"
                else {})

    for backend in ("actors", "monolithic"):
        sess = api.compile(train_graph(ns, one()), mode="infer",
                           backend=backend, num_microbatches=M,
                           microbatch_inputs=["x", "labels"],
                           **schedule(backend), **kw)
        out[f"infer {backend}"] = as_dict(sess.static_report)
        sess.close()
        sess = api.compile(train_graph(ns, one()), mode="train",
                           backend=backend, params=train_params(),
                           optimizer=O.adamw(lr=1e-3, grad_clip=1.0),
                           num_microbatches=M, **schedule(backend), **kw)
        out[f"train {backend}"] = as_dict(sess.static_report)
        sess.close()
        sess = api.compile(train_graph(ns, P(("data",), (2,)), rows="S(0)"),
                           mode="train", backend=backend,
                           params=train_params(),
                           optimizer=O.adamw(lr=1e-3, grad_clip=1.0),
                           num_microbatches=M, zero=True, precision="bf16",
                           **schedule(backend), **kw)
        out[f"zero bf16 dp=2 {backend}"] = as_dict(sess.static_report)
        sess.close()

    cfg = ns["get_config"]("qwen3-1.7b").reduced()
    for backend, cache in (("actors", "dense"), ("actors", "paged"),
                           ("monolithic", "dense")):
        stages = dict(stages=2) if backend == "actors" else {}
        sess = api.compile(cfg, mode="serve", backend=backend, cache=cache,
                           **stages, **SERVE_GEOMETRY, **ns["SERVE_KW"])
        out[f"serve {backend} {cache}"] = as_dict(sess.static_report)
        sess.close()

    # a partial value leaking through the sink: compile raises
    g = train_graph(ns, one())
    p = ns["plan"](g)
    sink = g.sinks()[0].name
    leaky = dataclasses.replace(
        p, tensor_sbp={**p.tensor_sbp, sink: Sbp.parse("P")},
        boxings=[b for b in p.boxings if b[1] != "__epilogue__"])
    try:
        api.compile(g, mode="train", stages=STAGES, params=train_params(),
                    num_microbatches=M, plan=leaky, **kw)
        raise AssertionError("the leaky plan compiled")
    except an.AnalysisError as e:
        out["bad: P sink leak"] = as_dict(e.report)
    # an indivisible split of x on a 2-device placement
    g = ns["LogicalGraph"](P(("d",), (2,)))
    g.matmul(g.input("x", (3, 8)), g.input("w", (8, 8)), name="y")
    p = ns["plan"](g)
    bad = dataclasses.replace(
        p, tensor_sbp={**p.tensor_sbp, "x": Sbp.parse("S(0)")})
    out["bad: indivisible split"] = as_dict(
        an.run_static_checks(graph=g, plan=bad))
    # a partial value across the stage 0 -> 1 boundary
    g = train_graph(ns, one())
    p = ns["plan"](g)
    part = ns["partition_stages"](g, 2)
    bad = dataclasses.replace(
        p, tensor_sbp={**p.tensor_sbp, "relu1.out": Sbp.parse("P")})
    out["bad: P across a stage boundary"] = as_dict(
        an.run_static_checks(graph=g, plan=bad, partition=part))
    # the quota-starved cycle A -> X -> C -> A
    A = ns["ActorSpec"]
    starved = [A("A", fn=_noop, inputs=(), out_regs=1, max_fires=2),
               A("X", fn=_noop, inputs=("A",), out_regs=1, max_fires=2,
                 emit_every=2),
               A("C", fn=_noop, inputs=("A", "X"), out_regs=1, max_fires=1)]
    out["bad: quota-starved cycle"] = as_dict(
        an.run_static_checks(specs=starved))
    return out


def cli_lines(main):
    """Each CLI_ARGS run's exit code and printed lines, the wall time
    dropped."""
    import contextlib
    import io
    runs = []
    for args in CLI_ARGS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(list(args))
        lines = [ln for ln in buf.getvalue().splitlines()
                 if not ln.startswith("analyzer wall time")]
        runs.append([rc, lines])
    return runs
'''

JAX_CODE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
import jax
from repro import analysis, api
from repro.analysis.__main__ import main
from repro.configs.registry import get_config
from repro.core.graph import LogicalGraph, partition_stages
from repro.core.lowering import OptimizerSpec
from repro.core.placement import Placement
from repro.core.planner import plan
from repro.core.sbp import NdSbp
from repro.runtime.actor import ActorSpec
ns = {}
exec(sys.argv[3], ns)
kw = {}
if hasattr(jax.sharding, "AxisType"):
    kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
mesh = jax.make_mesh((1, 1), ("data", "model"), **kw)
names = dict(api=api, analysis=analysis, LogicalGraph=LogicalGraph,
             Placement=lambda *a: Placement(*a, device_kind="cpu"),
             OptimizerSpec=OptimizerSpec, NdSbp=NdSbp, plan=plan,
             partition_stages=partition_stages, ActorSpec=ActorSpec,
             get_config=get_config, KW={}, SERVE_KW=dict(mesh=mesh))
out = {"reports": ns["reports"](names), "cli": ns["cli_lines"](main)}
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
print("JAX-OK")
"""

_C = {}
exec(CASES, _C)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_analysis") / "reports.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", JAX_CODE, SRC, str(out), CASES], env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "JAX-OK" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:])
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def port_side():
    names = dict(api=api, analysis=analysis, LogicalGraph=LogicalGraph,
                 Placement=Placement, OptimizerSpec=OptimizerSpec,
                 NdSbp=NdSbp, plan=plan, partition_stages=partition_stages,
                 ActorSpec=ActorSpec, get_config=get_config,
                 KW=dict(device="cpu"), SERVE_KW=dict(device="cpu"))
    # through JSON, as the JAX side's reports come
    return json.loads(json.dumps(_C["reports"](names)))


CASE_NAMES = [
    *(f"{m} {b}" for m in ("infer", "train", "zero bf16 dp=2")
      for b in ("actors", "monolithic")),
    "serve actors dense", "serve actors paged", "serve monolithic dense",
    "bad: P sink leak", "bad: indivisible split",
    "bad: P across a stage boundary", "bad: quota-starved cycle"]


@pytest.mark.parametrize("case", CASE_NAMES)
def test_reports_agree_field_for_field(jax_side, port_side, case):
    want, got = jax_side["reports"][case], port_side[case]
    for field in want:
        assert got[field] == want[field], (case, field)
    assert got.keys() == want.keys()
    if case.startswith("bad"):
        assert got["verdict"] == "FAIL" and got["violations"]
    else:
        assert got["verdict"] == "PASS"
        assert got["passes"] == (["memory"] if "monolithic" in case and
                                 "serve" in case else
                                 ["sbp", "memory"] if "monolithic" in case
                                 else ["deadlock", "memory"]
                                 if "serve" in case
                                 else ["deadlock", "sbp", "memory"])


def test_both_clis_print_the_same_lines(jax_side):
    got = _C["cli_lines"](port_cli)
    assert got == jax_side["cli"]
    assert [rc for rc, _ in got] == [0, 0, 0, 0, 1]
