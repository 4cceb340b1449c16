"""Snapshots across the two packages: the port writes the JAX package's
on-disk format and reads it back, in both directions.

* a snapshot the JAX package writes on the CPU (``repro.api.compile(...,
  snapshot_dir=)``) loads in the port (``repro_torch.runtime.snapshot
  .load_snapshot``) with every array byte-identical to what the JAX
  package's own loader gives, and the reverse;
* the stage directories of both packages hold the same leaves (keys,
  shapes, dtypes) and metadata, and their MANIFESTs the same fields;
* a port session restored from the JAX snapshot and stepped once matches
  the JAX session's next step within ``tests/test_torch_graph_train.py``'s
  tolerances: loss ``rtol=1e-5``, params ``rtol=1e-4, atol=1e-5``.

Each case runs for a plain AdamW snapshot and for a ZeRO + bf16 +
dynamic-loss-scale one (flat ``(dp, 1, chunk)`` rows, ``zero_shapes``,
``loss_scale``, ``scale_good_steps``).
"""
import json
import tempfile

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.core.graph import LogicalGraph as JGraph  # noqa: E402
from repro.core.lowering import OptimizerSpec as JOpt  # noqa: E402
from repro.core.lowering import PrecisionPolicy as JPolicy  # noqa: E402
from repro.core.placement import Placement as JPlacement  # noqa: E402
from repro.runtime import snapshot as jsnap  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core.graph import LogicalGraph  # noqa: E402
from repro_torch.core.lowering import (OptimizerSpec,  # noqa: E402
                                       PrecisionPolicy)
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.runtime import snapshot as psnap  # noqa: E402

B, W, S, M = 8, 8, 2, 2
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5

ZERO = "zero-dynamic"
CASES = ("adamw", ZERO)


def _graph(G, P):
    g = G(P(("d",), (1,)))
    h = g.input("x", (B, W))
    labels = g.input("labels", (B,), dtype="int32")
    for i in range(S):
        h = g.matmul(h, g.input(f"w{i}", (W, W)), name=f"mm{i}")
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


def _lr(s):
    return 1e-3 * 0.9 ** s


def _jax_session(case, **kw):
    extra = {}
    if case == ZERO:
        extra = dict(zero=True, precision=JPolicy(
            compute_dtype="bfloat16", loss_scale="dynamic",
            init_scale=2.0 ** 4, growth_interval=2))
    params, _ = _params_and_data()
    return japi.compile(_graph(JGraph, JPlacement), mode="train",
                        params=dict(params), num_microbatches=M,
                        optimizer=JOpt.adamw(lr=_lr, grad_clip=1.0),
                        check="off", **extra, **kw)


def _port_session(case, **kw):
    extra = {}
    if case == ZERO:
        extra = dict(zero=True, precision=PrecisionPolicy(
            compute_dtype="bfloat16", loss_scale="dynamic",
            init_scale=2.0 ** 4, growth_interval=2))
    params, _ = _params_and_data()
    return api.compile(_graph(LogicalGraph, Placement), mode="train",
                       params=dict(params), num_microbatches=M,
                       optimizer=OptimizerSpec.adamw(lr=_lr, grad_clip=1.0),
                       device="cpu", **extra, **kw)


def _write(make, case, d, steps=2, every=1):
    """``steps`` snapshotting steps of ``make``'s actor session into ``d``
    (every ``every``-th); returns the session, still open, for its next
    step."""
    _, data = _params_and_data()
    sess = make(case, backend="actors", stages=S, snapshot_dir=d,
                snapshot_every=every)
    for _ in range(steps):
        sess.step(**data)
    return sess


def _same_bytes(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _assert_loads_identical(d):
    """Both packages' loaders give byte-identical arrays from ``d``."""
    jp, jo, jstep, jmeta = jsnap.load_snapshot(d)
    pp, po, pstep, pmeta = psnap.load_snapshot(d)
    assert jstep == pstep and jmeta == pmeta
    assert sorted(jp) == sorted(pp)
    for n in jp:
        _same_bytes(jp[n], pp[n], f"params {n}")
        _same_bytes(jo.mu[n], po.mu[n], f"mu {n}")
        _same_bytes(jo.nu[n], po.nu[n], f"nu {n}")
    _same_bytes(jo.step, po.step, "step")
    return pmeta


def _layout(d, step):
    """Each stage's leaves ``{key: (shape, dtype)}`` and metadata, and the
    MANIFEST's stages and metadata keys."""
    out = {}
    for s in range(S):
        m = json.loads((psnap.stage_dir(d, step, s) / "manifest.json")
                       .read_text())
        out[s] = ({k: (v["shape"], v["dtype"])
                   for k, v in m["leaves"].items()}, m["meta"], m["step"])
    top = json.loads((psnap.step_dir(d, step) / psnap.MANIFEST_NAME)
                     .read_text())
    return out, top["stages"], sorted(top["meta"])


@pytest.mark.parametrize("case", CASES)
def test_jax_snapshot_loads_in_the_port(case):
    with tempfile.TemporaryDirectory() as d:
        _write(_jax_session, case, d).close()
        meta = _assert_loads_identical(d)
        if case == ZERO:
            assert meta["zero"] and "loss_scale" in meta
            assert "scale_good_steps" in meta


@pytest.mark.parametrize("case", CASES)
def test_port_snapshot_loads_in_jax_in_the_same_layout(case):
    with tempfile.TemporaryDirectory() as dp, \
            tempfile.TemporaryDirectory() as dj:
        _write(_port_session, case, dp).close()
        _write(_jax_session, case, dj).close()
        _assert_loads_identical(dp)
        assert _layout(dp, 2) == _layout(dj, 2)
        assert psnap.list_snapshots(dp) == jsnap.list_snapshots(dj) == [1, 2]
        if case == ZERO:
            stage = _layout(dp, 2)[0][0][1]
            assert stage["zero"] and stage["zero_shapes"] == {"w0": [W, W]}
            pm = psnap.load_snapshot(dp)[3]
            jm = jsnap.load_snapshot(dj)[3]
            assert (pm["loss_scale"], pm["scale_good_steps"]) == \
                (jm["loss_scale"], jm["scale_good_steps"]) == (2.0 ** 5, 0)


@pytest.mark.parametrize("case", CASES)
def test_port_resumes_a_jax_snapshot(case):
    """The JAX session writes step 2's snapshot and takes a third step; a
    port session restored from the snapshot takes the same third step."""
    _, data = _params_and_data()
    with tempfile.TemporaryDirectory() as d:
        jsess = _write(_jax_session, case, d, every=2)
        want = jsess.step(**data)
        want_params = {n: np.asarray(v) for n, v in jsess.params.items()}
        jsess.close()
        with _port_session(case, backend="actors", stages=S,
                           restore=d) as sess:
            assert sess.step_count == 2
            got = sess.step(**data)
            np.testing.assert_allclose(float(got.loss), float(want.loss),
                                       rtol=LOSS_RTOL)
            if case == ZERO:
                assert got.metrics["loss_scale"] == want.metrics["loss_scale"]
            for n, v in want_params.items():
                np.testing.assert_allclose(got.params[n].numpy(), v,
                                           rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                           err_msg=n)
