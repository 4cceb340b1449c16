"""Training MLA and MoE on a mesh of ranks: deepseek-v2-lite through
``make_train_step`` with heads and experts split over ``model``.

Holds ``make_train_step(cfg, MeshPlan(("data", "model"), (D, M)))`` to the
JAX package on reduced deepseek-v2-lite-16b (a dense layer, then MLA with
4 heads and an MoE of 4 experts top-2 plus 2 shared, vocab 1000 padded to
1024, float32), from the JAX init carried over by ``params_from_jax``, on
the same ``SyntheticLM`` batches of 4 x 16 (seed 0). As in
``test_torch_train_mesh.py`` the JAX side runs once per module in a
subprocess with 8 host devices and Auto mesh axes, from the code below,
and writes ``.npz`` results; the port runs in process on the CPU, every
rank a thread.

On (1, 2), (2, 1) and (2, 2), plain and ZeRO, with the tolerances below:

* step 0's loss, ``lm_loss`` and ``aux_loss`` within 1e-5 relative of the
  JAX ``make_train_step`` on the same mesh. On a data mesh each data rank
  routes its own rows (the capacity and the aux are per rank, as in the
  reference), so the mesh's loss differs from one device's;
* every gradient leaf, assembled from the ranks, within ``rtol=1e-4,
  atol=1e-6`` (``test_torch_train_mesh.py``'s; measured at most 1.2e-7
  abs, 2.6e-6 of a leaf's largest magnitude) of the JAX mesh gradient:
  ``value_and_grad`` of the reference's ``loss_fn`` under
  ``shard_map(check=True)`` on that mesh, over dp (its autodiff sums a
  data-replicated param's gradient over ``data``). The JAX
  ``make_train_step`` exposes no gradients; its ZeRO path's norm is held
  below;
* three AdamW steps: losses and ``aux_loss`` within 1e-5 relative of the
  JAX mesh run, the assembled params within ``rtol=1e-4, atol=5e-5``: the
  floor ``test_torch_train_mesh.py`` explains (an element whose gradient
  is rounding noise moves by an arbitrary share of lr) sits higher here,
  the JAX package's own (1, 2) run ending 1.95e-5 from its 1 x 1 run and
  the port's at most 3.33e-5 from the JAX run (measured on the CPU);
* ``grad_norm`` within 1e-5 relative of the JAX ``zero=True`` step's on
  that mesh (its plain path reports dp times the norm; ROADMAP Queue 3).

The port alone: on (1, 2) every leaf's gradient equals one device's
within ``rtol=1e-4, atol=1e-6`` (the router's, and MLA's ``wkv_a`` and
``kv_norm``, summed over ``model`` once, the aux counted once), also with
a q LoRA (``wq_a``, ``q_norm``); remat on ≡ off bitwise; the collectives
a step makes.
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
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.common import (MODEL_GRAD_SUM_LEAVES,  # noqa: E402
                                       MeshPlan)
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
CPU = "cpu"
ARCH = "deepseek-v2-lite-16b"

#: constants both processes read
SHARED = r'''
LR, STEPS, B, S = 3e-4, 3, 4, 16
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
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import pvary, shard_map
from repro.configs.registry import get_config
from repro.data.pipeline import SyntheticLM
from repro.models.model_zoo import build_model
from repro.optim.adamw import AdamWConfig
from repro.train.steps import batch_specs, make_train_step, plan_from_mesh
from repro_torch.configs.registry import get_config as port_config
from repro_torch.models.convert import params_from_jax
exec(open(os.path.join(out_dir, "shared.py")).read())
arch = "deepseek-v2-lite-16b"
cfg = dataclasses.replace(get_config(arch).reduced(), vocab_size=1000)
cfg_t = dataclasses.replace(port_config(arch).reduced(), vocab_size=1000)
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

for shape in MESHES:
    mesh, t = mesh_of(shape), tag(shape)
    plan = plan_from_mesh(mesh)
    bundle = build_model(cfg, plan)
    axes = plan.axis_names

    def mean(v):
        vma = getattr(jax.core.get_aval(v), "vma", frozenset())
        missing = tuple(n for n in axes if n not in vma)
        return jax.lax.pmean(pvary(v, missing) if missing else v, axes)

    def grads_of(p, batch):
        (loss, m), g = jax.value_and_grad(bundle.loss_fn, has_aux=True)(
            p, batch)
        return (mean(loss), mean(m["aux_loss"]),
                jax.tree.map(lambda x: x / plan.dp, g))
    specs = bundle.specs()
    loss, aux, g = jax.jit(shard_map(
        grads_of, mesh=mesh, in_specs=(specs, batch_specs(cfg, plan,
                                                          "train")),
        out_specs=(P(), P(), specs), check=True))(
        fresh(), {"tokens": jnp.asarray(batches[0])})
    res[f"gloss_{t}"], res[f"gaux_{t}"] = np.asarray(loss), np.asarray(aux)
    put(f"grads_{t}", g)
    for zero in (False, True):
        ts = make_train_step(cfg, mesh, optimizer=AdamWConfig(lr=LR),
                             zero=zero)
        p = ts.shard_params_fn(fresh()) if zero else fresh()
        opt = ts.init_opt(p)
        ms = []
        for b in batches:
            p, opt, m = ts.step_fn(p, opt, {"tokens": b})
            ms.append([float(m[k]) for k in ("loss", "lm_loss", "aux_loss",
                                             "grad_norm")])
        kind = "zero" if zero else "plain"
        res[f"metrics_{kind}_{t}"] = np.array(ms)
        put(f"params_{kind}_{t}", ts.gather_params_fn(p) if zero else p)
np.savez(os.path.join(out_dir, "jax.npz"), **res)
print("JAX-OK")
"""

KEYS = ("loss", "lm_loss", "aux_loss", "grad_norm")


def _cfg(**kw):
    return dataclasses.replace(get_config(ARCH).reduced(), vocab_size=1000,
                               **kw)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_deepseek_mesh_train")
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


def _train_step(shape=(1, 1), zero=False, cfg=None, **kw):
    return make_train_step(cfg or _cfg(), MeshPlan(("data", "model"), shape),
                           optimizer=AdamWConfig(lr=LR), zero=zero,
                           device=CPU, **kw)


def _params(ts, state):
    if ts.zero:
        return ts.shard_params_fn(state)
    params = ts.init_params(0)
    params.load_state_dict(state)
    return params


@pytest.fixture(scope="module")
def port_runs(jax_side):
    """Every mesh's gradients on batch 0 and three AdamW steps, plain and
    ZeRO, and one device's gradients."""
    batches = jax_side.jx["batches"]
    p0 = jax_side.tree("p0")
    out = {}
    for shape in [(1, 1)] + MESHES:
        for zero in (False, True):
            ts = _train_step(shape, zero)
            params = _params(ts, p0)
            loss, grads = ts.grad_fn(params, {"tokens": batches[0]})
            opt = ts.init_opt(params)
            metrics = []
            for b in batches:
                params, opt, m = ts.step_fn(params, opt, {"tokens": b})
                metrics.append([float(m[k]) for k in KEYS])
            out[shape, zero] = SimpleNamespace(
                loss=float(loss), grads=grads, metrics=np.array(metrics),
                params=(ts.gather_params_fn(params) if zero
                        else params.state_dict()))
    return out


CASES = [(s, z) for s in MESHES for z in (False, True)]
IDS = [f"{tag(s)}-{'zero' if z else 'plain'}" for s, z in CASES]


@pytest.mark.parametrize("shape,zero", CASES, ids=IDS)
def test_step0_losses_match_the_jax_step_on_the_mesh(jax_side, port_runs,
                                                     shape, zero):
    run = port_runs[shape, zero]
    want = jax_side.jx[f"metrics_{'zero' if zero else 'plain'}_{tag(shape)}"]
    assert run.metrics[0][2] > 0
    assert_allclose(run.metrics[0][:3], want[0][:3], rtol=1e-5)
    assert_allclose(run.loss, jax_side.jx[f"gloss_{tag(shape)}"], rtol=1e-5)
    # loss = lm_loss + router_aux_weight * aux_loss, as the reference's
    lm, aux = run.metrics[0][1], run.metrics[0][2]
    assert_allclose(run.metrics[0][0], lm + _cfg().router_aux_weight * aux,
                    rtol=1e-6)


@pytest.mark.parametrize("shape,zero", CASES, ids=IDS)
def test_assembled_gradients_match_the_jax_mesh_gradients(jax_side,
                                                          port_runs, shape,
                                                          zero):
    got = port_runs[shape, zero].grads
    want = jax_side.tree(f"grads_{tag(shape)}")
    assert set(got) == set(want)
    for name, g in got.items():
        assert g.abs().max() > 0, name
        assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                        err_msg=name)


@pytest.mark.parametrize("shape,zero", CASES, ids=IDS)
def test_three_adamw_steps_match_the_jax_mesh_run(jax_side, port_runs,
                                                  shape, zero):
    kind = "zero" if zero else "plain"
    run = port_runs[shape, zero]
    want = jax_side.jx[f"metrics_{kind}_{tag(shape)}"]
    assert_allclose(run.metrics[:, :3], want[:, :3], rtol=1e-5)
    # the true norm: the JAX ZeRO step's (its plain path reports dp times)
    assert_allclose(run.metrics[:, 3],
                    jax_side.jx[f"metrics_zero_{tag(shape)}"][:, 3],
                    rtol=1e-5)
    params = jax_side.tree(f"params_{kind}_{tag(shape)}")
    assert set(run.params) == set(params)
    for name, w in params.items():
        assert_allclose(run.params[name].numpy(), w.numpy(), rtol=1e-4,
                        atol=5e-5, err_msg=name)


def _same_grads(got, want):
    assert set(got) == set(want)
    for n, w in want.items():
        assert_allclose(got[n].numpy(), w.numpy(), rtol=1e-4, atol=1e-6,
                        err_msg=n)


def test_model_replicated_leaves_match_one_device(port_runs):
    """On (1, 2) the batch is one device's, so every assembled gradient is
    one device's: the router's (its gates' part summed over the ranks'
    experts, the aux's reaching each rank at 1 / tp), MLA's ``wkv_a`` and
    ``kv_norm`` (each rank's heads' part), summed over ``model`` once."""
    one = port_runs[(1, 1), False].grads
    for leaf in ("moe.router", "attn.wkv_a", "attn.kv_norm"):
        assert leaf.rsplit(".", 1)[-1] in MODEL_GRAD_SUM_LEAVES
    for zero in (False, True):
        _same_grads(port_runs[(1, 2), zero].grads, one)


def test_q_lora_leaves_are_summed_once():
    """With a q LoRA (``wq_a``, ``q_norm``, ``wq_b``) the (1, 2) mesh's
    gradients, plain and ZeRO, equal one device's: ``wq_a`` and ``q_norm``
    feed only a rank's heads and are summed over ``model`` exactly once
    (twice would double them, not at all halve them)."""
    cfg = _cfg(q_lora_rank=32)
    batch = {"tokens": np.random.default_rng(3).integers(
        0, 1000, (2, 9)).astype(np.int32)}
    one_ts = _train_step(cfg=cfg)
    state = one_ts.init_params(5).state_dict()
    _, one = one_ts.grad_fn(_params(one_ts, state), batch)
    assert {"blocks.1.attn.wq_a", "blocks.1.attn.q_norm"} <= set(one)
    for zero in (False, True):
        ts = _train_step((1, 2), zero, cfg=cfg)
        _, got = ts.grad_fn(_params(ts, state), batch)
        _same_grads(got, one)


def test_remat_on_and_off_give_the_same_gradients(jax_side):
    """The MoE's rerun in the backward repeats its routing bit for bit."""
    batch = {"tokens": jax_side.jx["batches"][0]}
    p0 = jax_side.tree("p0")
    got = {}
    for remat in (True, False):
        ts = _train_step((2, 2), remat=remat)
        got[remat] = ts.grad_fn(_params(ts, p0), batch)
    assert got[True][0] == got[False][0]
    for name, g in got[True][1].items():
        torch.testing.assert_close(g, got[False][1][name], rtol=0, atol=0)


def test_a_step_makes_the_collectives_counted(jax_side):
    """(1, 2), 2 layers (1 of them MoE): psums 2 a layer and 3 more forward
    (embedding, s, z), 2 a layer and 1 more backward (the f's; the aux's
    pmean transposes with no collective), then the model sums of the
    replicated leaves each rank uses in part (``wkv_a`` and ``kv_norm`` a
    layer, the router an MoE layer), the norm and the metrics; one
    pmax."""
    cfg = _cfg()
    ts = _train_step((1, 2))
    params = _params(ts, jax_side.tree("p0"))
    opt = ts.init_opt(params)
    ts.mesh.stats.reset()
    ts.step_fn(params, opt, {"tokens": jax_side.jx["batches"][0]})
    L, n_moe = cfg.num_layers, cfg.num_layers - cfg.first_dense_layers
    assert ts.mesh.stats.calls == {"psum": 6 * L + n_moe + 6, "pmax": 1}
