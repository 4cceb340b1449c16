"""The port's training step against the JAX package's, on reduced qwen3.

``qwen3-1.7b.reduced()`` (2 layers, d_model 256, vocab 1024, float32): the
JAX params are built with ``jax.random`` and carried into the port through
``params_from_jax``; both packages see the same ``SyntheticLM`` batches.
Tolerances, set from what was measured on the CPU:

* the loss to 1e-5 relative (measured: equal); every gradient leaf to
  ``rtol=1e-4, atol=1e-6`` (measured max abs 5.7e-7: XLA and PyTorch sum
  in different orders);
* three AdamW steps: loss and pre-clip ``grad_norm`` to 1e-5 relative
  (measured 7e-8), and the JAX run's losses to the literal 7.35252,
  7.32321, 6.81092 at 1e-4; the params after three steps to
  ``rtol=1e-4, atol=1e-5`` (measured max abs 1.07e-5: AdamW divides each
  gradient by its own running scale, so a last-bit difference of a
  near-zero gradient element moves its update by a visible share of lr).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import ActorDataPipeline as JaxActorPipe  # noqa: E402
from repro.data.pipeline import SyncDataPipeline as JaxSyncPipe  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models.model_zoo import build_model as jax_build  # noqa: E402
from repro.optim.adamw import AdamWConfig as JaxAdamW  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.steps import plan_from_mesh  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data.pipeline import (ActorDataPipeline,  # noqa: E402
                                       SyncDataPipeline, SyntheticLM)
from repro_torch.models.convert import (jax_leaves, params_from_jax,  # noqa: E402
                                        params_to_jax)
from repro_torch.models.model_zoo import loss_fn  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
LR = 3e-4
STEPS = 3
JAX_LOSSES = (7.35252, 7.32321, 6.81092)


def _mesh():
    """A 1x1 mesh with Auto axes (jax 0.9 makes Explicit ones by default)."""
    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((1, 1), ("data", "model"), **kw)


@pytest.fixture(scope="module")
def ref():
    """The JAX side, computed once: initial params, batches, the first
    batch's loss and gradients, and three train steps."""
    cfg_j = jax_get_config("qwen3-1.7b").reduced()
    mesh = _mesh()
    ts = jax_make_train_step(cfg_j, mesh, optimizer=JaxAdamW(lr=LR),
                             zero=False)
    params = ts.init_params(jax.random.PRNGKey(0))
    np0 = jax.device_get(params)
    src = JaxSyntheticLM(cfg_j.vocab_size, 2, 32)
    batches = [src(i) for i in range(STEPS)]
    bundle = jax_build(cfg_j, plan_from_mesh(mesh))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        bundle.loss_fn, has_aux=True))(params, {"tokens": jnp.asarray(batches[0])})
    opt = ts.init_opt(params)
    losses, norms = [], []
    for b in batches:
        params, opt, m = ts.step_fn(params, opt, {"tokens": b})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(cfg=get_config("qwen3-1.7b").reduced(), np0=np0,
                batches=batches, loss=float(loss),
                grads=jax.device_get(grads), losses=losses, norms=norms,
                params=jax.device_get(params))


def _port_step(cfg):
    return make_train_step(cfg, optimizer=AdamWConfig(lr=LR), zero=False,
                           device="cpu")


def _port_model(ref):
    model = _port_step(ref["cfg"]).init_params(0)
    model.load_state_dict(params_from_jax(ref["np0"], ref["cfg"]))
    return model


def _grads(model, batch, remat):
    loss, metrics = loss_fn(model, {"tokens": batch}, remat=remat)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return loss.detach(), metrics, dict(zip(names, grads))


def test_leaf_order_is_the_jax_tree_flatten_order(ref):
    paths = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(ref["np0"])[0]]
    assert [p for p, _ in jax_leaves(ref["cfg"])] == paths


def test_params_to_jax_inverts_params_from_jax(ref):
    tree = params_to_jax(params_from_jax(ref["np0"], ref["cfg"]), ref["cfg"])
    flat_j = jax.tree_util.tree_flatten_with_path(ref["np0"])[0]
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (_, a), (_, b) in zip(flat_t, flat_j):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_forward_loss_and_grads_match_jax(ref):
    loss, metrics, grads = _grads(_port_model(ref), ref["batches"][0], True)
    assert set(metrics) == {"lm_loss", "aux_loss", "loss"}
    assert float(metrics["aux_loss"]) == 0.0
    assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    want = params_from_jax(ref["grads"], ref["cfg"])
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g.abs().max() > 0, name
        assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                        err_msg=name)


def test_remat_on_and_off_give_the_same_gradients(ref):
    model = _port_model(ref)
    l1, _, g1 = _grads(model, ref["batches"][0], remat=True)
    l0, _, g0 = _grads(model, ref["batches"][0], remat=False)
    assert float(l1) == float(l0)
    for name in g1:
        torch.testing.assert_close(g1[name], g0[name], rtol=0, atol=0)


def test_three_train_steps_match_jax(ref):
    assert_allclose(ref["losses"], JAX_LOSSES, rtol=1e-4)
    ts = _port_step(ref["cfg"])
    model = _port_model(ref)
    opt = ts.init_opt(model)
    losses, norms = [], []
    for b in ref["batches"]:
        model, opt, m = ts.step_fn(model, opt, {"tokens": b})
        assert set(m) == {"lm_loss", "aux_loss", "loss", "grad_norm"}
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    assert int(opt.step) == STEPS
    assert_allclose(losses, ref["losses"], rtol=1e-5)
    assert_allclose(norms, ref["norms"], rtol=1e-5)
    want = params_from_jax(ref["params"], ref["cfg"])
    got = model.state_dict()
    for name, w in want.items():
        assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-4, atol=1e-5,
                        err_msg=name)


def test_zero_and_wider_meshes_raise():
    """``zero=True`` (the default) runs at 1 x 1 and gives the plain
    path's loss (``tests/test_torch_zero.py`` holds it to the JAX
    package). A Mamba config now trains on a mesh as well (it raised
    naming item 8c before the SSD scan had a backward;
    ``tests/test_torch_mamba_train.py`` holds it to the JAX package):
    on (2, 1) its first step's loss is one device's. What still raises is
    named: a hybrid (jamba, item 13), and SSM heads that the model axis
    does not split."""
    from repro_torch.models.common import MeshPlan
    for arch in ("qwen3-1.7b", "mamba2-370m"):
        cfg = get_config(arch).reduced()
        batch = {"tokens": SyntheticLM(cfg.vocab_size, 2, 32)(0)}
        losses = []
        for zero, shape in ((True, (1, 1)), (False, (1, 1)), (True, (2, 1))):
            ts = make_train_step(cfg, MeshPlan(("data", "model"), shape),
                                 zero=zero, device="cpu")
            assert ts.zero is zero
            params = ts.init_params(0)
            _, _, m = ts.step_fn(params, ts.init_opt(params), batch)
            losses.append(float(m["loss"]))
        assert max(losses) - min(losses) <= 1e-6 * abs(losses[1]), arch
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        make_train_step(get_config("jamba-v0.1-52b").reduced(),
                        MeshPlan(("data", "model"), (2, 1)), device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        make_train_step(get_config("mamba2-370m").reduced(),
                        MeshPlan(("data", "model"), (1, 3)), device="cpu")


@pytest.mark.parametrize("kind", ["actor", "sync"])
def test_data_pipeline_batches_equal_the_reference(kind):
    n = 5
    if kind == "actor":
        ours = list(ActorDataPipeline(SyntheticLM(1024, 2, 32, seed=3), n))
        theirs = list(JaxActorPipe(JaxSyntheticLM(1024, 2, 32, seed=3), n))
    else:
        ours = list(SyncDataPipeline(SyntheticLM(1024, 2, 32, seed=3), n))
        theirs = list(JaxSyncPipe(JaxSyntheticLM(1024, 2, 32, seed=3), n))
    assert len(ours) == len(theirs) == n
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_checkpoints_restore_across_packages(ref, tmp_path):
    """A checkpoint written by either package restores in the other, params
    and AdamW state alike."""
    cfg = ref["cfg"]
    ts = _port_step(cfg)
    model = _port_model(ref)
    opt = ts.init_opt(model)
    model, opt, _ = ts.step_fn(model, opt, {"tokens": ref["batches"][0]})
    tree = {"params": params_to_jax(model.state_dict(), cfg),
            "step": opt.step}
    ckpt.save_checkpoint(str(tmp_path / "port"), tree, step=1,
                         meta={"arch": cfg.name})
    like_j = {"params": ref["np0"], "step": jnp.zeros((), jnp.int32)}
    got_j, step = jax_ckpt.load_checkpoint(str(tmp_path / "port"), like_j)
    assert step == 1 and int(got_j["step"]) == 1
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(got_j["params"])[0],
            jax.tree_util.tree_flatten_with_path(tree["params"])[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b)

    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), {"params": ref["params"]},
                             step=3)
    manifest = json.loads((tmp_path / "jax" / "manifest.json").read_text())
    assert "params.body.0.attn.wq" in manifest["leaves"]
    like_t = {"params": params_to_jax(model.state_dict(), cfg)}
    got_t, step = ckpt.load_checkpoint(str(tmp_path / "jax"), like_t)
    assert step == 3
    state = params_from_jax(got_t["params"], cfg)
    want = params_from_jax(ref["params"], cfg)
    for name, w in want.items():
        torch.testing.assert_close(state[name], w, rtol=0, atol=0)


def test_launcher_smoke_trains_on_cpu():
    # one intra-op thread: the reduced model's ops are too small to share,
    # and spare threads only spin against the other test workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "5"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert "(improved)" in res.stdout, res.stdout
    assert res.stdout.count("step ") == 2     # steps 0 and 4


def test_adamw_update_matches_jax():
    """The pytree-at-once AdamW (clip, bias correction, decoupled decay) on
    random float32 leaves: two steps, params and moments within 1e-6."""
    from repro.optim.adamw import adamw_update as jax_adamw_update
    from repro.optim.adamw import init_adamw as jax_init_adamw
    from repro_torch.optim.adamw import adamw_update, init_adamw
    rng = np.random.default_rng(12)
    shapes = {"a": (8, 16), "b": (16,), "c": (3, 5, 7)}
    params = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(2)]
    cfg = AdamWConfig(lr=1e-2, grad_clip=1.0)
    pj = {n: jnp.asarray(v) for n, v in params.items()}
    sj = jax_init_adamw(pj)
    pt = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    st = init_adamw(pt)
    for g in grads:
        pj, sj, nj = jax_adamw_update(JaxAdamW(lr=1e-2, grad_clip=1.0), pj,
                                      {n: jnp.asarray(v) for n, v in g.items()},
                                      sj)
        st, nt = adamw_update(cfg, pt, {n: torch.from_numpy(v)
                                        for n, v in g.items()}, st)
        assert_allclose(float(nt), float(nj), rtol=1e-6)
    assert int(st.step) == int(sj.step) == 2
    for n in shapes:
        assert_allclose(pt[n].numpy(), np.asarray(pj[n]), rtol=1e-6, atol=1e-6)
        assert_allclose(st.mu[n].numpy(), np.asarray(sj.mu[n]), rtol=1e-6,
                        atol=1e-7)
        assert_allclose(st.nu[n].numpy(), np.asarray(sj.nu[n]), rtol=1e-6,
                        atol=1e-7)
