"""Training Mamba-2: ``make_train_step`` on one device and on meshes.

Holds ``make_train_step`` to the JAX package's on reduced mamba2 (2 SSM
layers, d_model 256, 16 heads of 32, d_state 32, chunk 32, vocab 1024,
float32), from the JAX init carried over by ``params_from_jax``, on the same
``SyntheticLM`` batches of 4 x 32 (seed 0), AdamW at lr 3e-4. The JAX side
runs once per module in a subprocess with 8 host devices and Auto mesh
axes, from the code below, and writes ``.npz`` results; the port runs in
process on the CPU, every rank a thread. The reference trains by autodiff
through its jnp ``ssd_chunked_ref``; on the CPU the port's scan is the
plain ``ssd_chunked_ref`` under autograd (on the card, the SSD kernels'
``SsdScan``).

* One device, ``zero=False`` and ``zero=True``, 3 steps: each step's loss
  and ``grad_norm`` within 1e-5 relative of the JAX step's, and the params
  after each step within 1e-5 relative in norm, leaf by leaf (measured at
  most 2.6e-6: float32 sums in another order; AdamW's first steps move an
  element whose gradient is rounding noise by an arbitrary share of lr,
  which a norm over the leaf absorbs).
* (1, 2), (2, 1) and (2, 2), ``zero=True`` and ``zero=False``, 3 steps:
  losses and grad norms within 1e-5 relative of the JAX ``zero=True`` step
  on the same mesh (the reference's plain path reports dp times the true
  norm, ROADMAP Queue 3, so it is no target).
* The gated norm before ``out_proj`` runs over each rank's local channels
  (a GroupNorm with tp groups, in the reference as in the port), so (1, 2)
  does not give one device's loss: the port's gap between them is the
  reference's, within 1e-5 of the loss.
* ZeRO gathers every master in the compute dtype, ``A_log``, ``D`` and
  ``dt_bias`` included, as the reference's ``gather_master_local`` casts
  each one (``repro/optim/zero.py:134-140``): pinned on a bf16 config.
* The launcher trains reduced mamba2 on one device and on a 1x2 mesh.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.common import MeshPlan as JaxMeshPlan  # noqa: E402
from repro.optim import zero as jax_zero  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.common import (MODEL_GRAD_SUM_LEAVES,  # noqa: E402
                                       MeshPlan)
from repro_torch.optim import zero as port_zero  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
CPU = "cpu"
RTOL = 1e-5

#: constants both processes read
SHARED = r'''
LR, STEPS, B, S = 3e-4, 3, 4, 32
MESHES = [(1, 2), (2, 1), (2, 2)]


def tag(shape):
    return f"{shape[0]}x{shape[1]}"
'''
exec(SHARED)

JAX_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
out_dir = sys.argv[2]
import numpy as np
import jax
import jax.numpy as jnp
from repro.configs.registry import get_config
from repro.data.pipeline import SyntheticLM
from repro.models.model_zoo import build_model
from repro.optim.adamw import AdamWConfig
from repro.train.steps import make_train_step, plan_from_mesh
from repro_torch.configs.registry import get_config as port_config
from repro_torch.models.convert import params_from_jax
exec(open(os.path.join(out_dir, "shared.py")).read())
cfg = get_config("mamba2-370m").reduced()
cfg_t = port_config("mamba2-370m").reduced()
res = {}


def put(prefix, tree):
    for n, v in params_from_jax(jax.device_get(tree), cfg_t).items():
        res[f"{prefix}/{n}"] = v.numpy()


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


np0 = jax.device_get(build_model(cfg, plan_from_mesh(mesh_of((1, 1)))).init(
    jax.random.PRNGKey(0)))
fresh = lambda: jax.tree.map(jnp.array, np0)
put("p0", np0)
src = SyntheticLM(cfg.vocab_size, B, S)
batches = [src(i) for i in range(STEPS)]
res["batches"] = np.stack(batches)
for shape in [(1, 1)] + MESHES:
    for zero in ((False, True) if shape == (1, 1) else (True,)):
        ts = make_train_step(cfg, mesh_of(shape),
                             optimizer=AdamWConfig(lr=LR), zero=zero)
        p = ts.shard_params_fn(fresh()) if zero else fresh()
        opt = ts.init_opt(p)
        losses, norms = [], []
        kind = ("zero" if zero else "plain") + "_" + tag(shape)
        for k, b in enumerate(batches):
            p, opt, m = ts.step_fn(p, opt, {"tokens": b})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if shape == (1, 1):
                put(f"params_{kind}_{k}",
                    ts.gather_params_fn(p) if zero else p)
        res[f"loss_{kind}"] = np.array(losses)
        res[f"norm_{kind}"] = np.array(norms)
np.savez(os.path.join(out_dir, "jax.npz"), **res)
print("JAX-OK")
"""


def _cfg():
    return get_config("mamba2-370m").reduced()


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_mamba_train")
    (out / "shared.py").write_text(SHARED)
    run_env = dict(os.environ, JAX_PLATFORMS="cpu")
    run_env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", JAX_CODE, SRC, str(out)],
                          env=run_env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0 and "JAX-OK" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:])
    jx = dict(np.load(out / "jax.npz"))

    def tree(prefix):
        return {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in jx.items()
                if k.startswith(prefix + "/")}
    return SimpleNamespace(jx=jx, tree=tree)


@pytest.fixture(scope="module")
def port_runs(jax_side):
    """Three AdamW steps on one device and on every mesh, plain and ZeRO,
    from the JAX init; on one device the params after each step."""
    out = {}
    for shape in [(1, 1)] + MESHES:
        for zero in (False, True):
            ts = make_train_step(_cfg(), MeshPlan(("data", "model"), shape),
                                 optimizer=AdamWConfig(lr=LR), zero=zero,
                                 device=CPU)
            params = ts.init_params(0)
            params.load_state_dict(jax_side.tree("p0"))
            if zero:
                assert ts.zero
            opt = ts.init_opt(params)
            metrics, states = [], []
            for b in jax_side.jx["batches"]:
                params, opt, m = ts.step_fn(params, opt, {"tokens": b})
                metrics.append({k: float(v) for k, v in m.items()})
                if shape == (1, 1):
                    states.append({n: t.detach().clone() for n, t in
                                   params.state_dict().items()})
            out[(shape, zero)] = SimpleNamespace(metrics=metrics,
                                                 states=states)
    return out


def _series(run, key):
    return np.array([m[key] for m in run.metrics])


@pytest.mark.parametrize("zero", [False, True], ids=["plain", "zero"])
def test_one_device_steps_match_jax(jax_side, port_runs, zero):
    run, kind = port_runs[((1, 1), zero)], ("zero" if zero else "plain")
    assert set(run.metrics[0]) == {"lm_loss", "aux_loss", "loss",
                                   "grad_norm"}
    np.testing.assert_allclose(_series(run, "loss"),
                               jax_side.jx[f"loss_{kind}_1x1"], rtol=RTOL)
    np.testing.assert_allclose(_series(run, "grad_norm"),
                               jax_side.jx[f"norm_{kind}_1x1"], rtol=RTOL)
    for k, got in enumerate(run.states):
        want = jax_side.tree(f"params_{kind}_1x1_{k}")
        assert set(got) == set(want)
        for name, w in want.items():
            err = float((got[name] - w).norm() / w.norm())
            assert err <= RTOL, f"step {k} {name}: {err:.3e} relative"


@pytest.mark.parametrize("zero", [False, True], ids=["plain", "zero"])
@pytest.mark.parametrize("shape", MESHES, ids=[tag(s) for s in MESHES])
def test_mesh_steps_match_the_jax_zero_step(jax_side, port_runs, shape,
                                           zero):
    run = port_runs[(shape, zero)]
    np.testing.assert_allclose(_series(run, "loss"),
                               jax_side.jx[f"loss_zero_{tag(shape)}"],
                               rtol=RTOL)
    np.testing.assert_allclose(_series(run, "grad_norm"),
                               jax_side.jx[f"norm_zero_{tag(shape)}"],
                               rtol=RTOL)


def test_model_axis_gap_is_the_reference_groupnorm_gap(jax_side, port_runs):
    """(1, 2) normalises each rank's 8 heads on their own: its step-0 loss
    differs from one device's in both packages, by the same amount; (2, 1)
    (data only) does not."""
    jx = jax_side.jx
    one = jx["loss_zero_1x1"][0]
    for shape in ((1, 2), (2, 2)):
        ref_gap = jx[f"loss_zero_{tag(shape)}"][0] - one
        assert abs(ref_gap) > 1e-4 * abs(one)
        for zero in (False, True):
            gap = (port_runs[(shape, zero)].metrics[0]["loss"]
                   - port_runs[((1, 1), zero)].metrics[0]["loss"])
            assert abs(gap - ref_gap) <= RTOL * abs(one), (shape, zero)
    for zero in (False, True):
        np.testing.assert_allclose(
            port_runs[((2, 1), zero)].metrics[0]["loss"],
            port_runs[((1, 1), zero)].metrics[0]["loss"], rtol=RTOL)


def test_model_grad_sum_leaves_are_the_reference_set():
    """``w_bc`` and ``conv_bc`` feed only a rank's heads, so their
    gradients are summed over ``model``, as the reference's; the port's set
    adds MLA's latent leaves (``wkv_a``, ``kv_norm``, ``wq_a``), whose sum
    the reference's autodiff makes on its plain path."""
    assert MODEL_GRAD_SUM_LEAVES == \
        jax_steps._MODEL_GRAD_SUM_LEAVES | {"wkv_a", "kv_norm", "wq_a"}
    assert port_zero.MODEL_SUM_LEAVES == MODEL_GRAD_SUM_LEAVES
    assert {"w_bc", "conv_bc"} <= port_zero.MODEL_SUM_LEAVES


def test_zero_gathers_float32_leaves_in_the_compute_dtype():
    """On a bf16 config the ZeRO loss program's gather of ``A_log``, ``D``
    and ``dt_bias`` gives the bf16 rounding of the float32 master, as the
    reference's ``gather_master_local`` (which casts every master); the
    model then reads them in float32 (``mamba.py:_dt_and_a``)."""
    cfg = dataclasses.replace(_cfg(), dtype="bfloat16")
    ts = make_train_step(cfg, zero=True, device=CPU)
    params = ts.init_params(0)
    plan = MeshPlan.single_device()
    rng = np.random.default_rng(7)
    for leaf in ("A_log", "D", "dt_bias"):
        name = f"blocks.0.ssm.{leaf}"
        master = params.ranks[0][name]
        master.copy_(torch.from_numpy(
            rng.normal(size=master.shape).astype(np.float32)))
        got = port_zero.gather_master_local(master, params.shapes[name],
                                            torch.bfloat16, plan)
        want = jax_zero.gather_master_local(
            jnp.asarray(master.numpy()), params.shapes[name], jnp.bfloat16,
            JaxMeshPlan(("data", "model"), (1, 1)))
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want, np.float32)), leaf
        assert not torch.equal(got.float(), master.reshape(got.shape))
    # the step runs with them: finite loss and norm
    batch = {"tokens": np.asarray(
        rng.integers(0, cfg.vocab_size, (2, 17)), np.int32)}
    _, _, m = ts.step_fn(params, ts.init_opt(params), batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))


@pytest.mark.parametrize("extra", [[], ["--mesh", "1x2", "--batch", "4",
                                         "--seq", "32"]],
                         ids=["one_device", "mesh_1x2"])
def test_launcher_trains_mamba2(capsys, extra):
    launch_train.main(["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
                       "--steps", "5", *extra])
    assert "(improved)" in capsys.readouterr().out
