"""Training deepseek-v2-lite (MLA + MoE) in the port against the JAX
package, on the CPU.

``deepseek-v2-lite-16b.reduced()`` (2 layers: a dense one, then MLA with a
capacity-routed MoE of 4 experts top-2 and 2 shared; q/k head dim 96, v 64;
float32) in two variants: the reduced capacity factor 8, where no token
is dropped, and ``capacity_factor=1.0``, where experts drop tokens (each
takes 32 of the batch's 128 picks: a test checks that some are dropped).
The JAX params are built with ``jax.random`` and carried into the port
through ``params_from_jax``; both packages see the same ``SyntheticLM``
batches (2 x 32 tokens). The routers' load-balance loss is in the loss as
the reference adds it (``router_aux_weight * aux``), so ``aux_loss`` is
held to the JAX step's, not to 0. Tolerances, as ``tests/test_torch_train
.py`` holds qwen3 (measured here in brackets):

* ``lm_loss``, ``aux_loss`` and the total loss to 1e-5 relative (6e-8);
  every gradient leaf to ``rtol=1e-4, atol=1e-6`` (max abs 1.3e-6 on
  ``embed``, whose entries reach 0.5; XLA and PyTorch sum in other
  orders);
* three AdamW steps: each step's losses and pre-clip ``grad_norm`` to 1e-5
  relative (3e-7); the params after them to ``rtol=1e-4, atol=5e-5``
  (max abs 4.1e-5: AdamW moves an element whose gradient is rounding noise
  by a share of lr = 3e-4 that the noise decides, here up to 0.14 lr);
* the MoE's and MLA's own backwards against ``jax.vjp`` of the reference's
  functions: float32 at the output's scale (the expert stacks are drawn at
  std 1 / sqrt(E) = 0.5, so the MoE's values reach 10^2-10^3).
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models.attention import mla_forward as jax_mla_forward  # noqa: E402
from repro.models.mlp import moe_forward as jax_moe_forward  # noqa: E402
from repro.models.model_zoo import build_model as jax_build  # noqa: E402
from repro.optim.adamw import AdamWConfig as JaxAdamW  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.steps import plan_from_mesh  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention, mlp  # noqa: E402
from repro_torch.models.common import MeshPlan  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model_zoo import loss_fn  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ARCH = "deepseek-v2-lite-16b"
LR = 3e-4
STEPS = 3
B, S = 2, 32
#: capacity factor by variant: the reduced config's 8 (no drops), 1.0
VARIANTS = {"no_drops": 8.0, "drops": 1.0}
PLAN = MeshPlan.single_device()


def _mesh():
    """A 1x1 mesh with Auto axes (jax 0.9 makes Explicit ones by default)."""
    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((1, 1), ("data", "model"), **kw)


def _configs(variant):
    cf = VARIANTS[variant]
    return (dataclasses.replace(jax_get_config(ARCH).reduced(),
                                capacity_factor=cf),
            dataclasses.replace(get_config(ARCH).reduced(),
                                capacity_factor=cf))


@pytest.fixture(scope="module", params=list(VARIANTS))
def ref(request):
    """The JAX side of one variant, computed once: initial params,
    batches, the first batch's loss, metrics and gradients, and three
    train steps (metrics and params)."""
    cfg_j, cfg_t = _configs(request.param)
    mesh = _mesh()
    ts = jax_make_train_step(cfg_j, mesh, optimizer=JaxAdamW(lr=LR),
                             zero=False)
    params = ts.init_params(jax.random.PRNGKey(0))
    np0 = jax.device_get(params)
    src = JaxSyntheticLM(cfg_j.vocab_size, B, S)
    batches = [src(i) for i in range(STEPS)]
    bundle = jax_build(cfg_j, plan_from_mesh(mesh))
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        bundle.loss_fn, has_aux=True))(params,
                                       {"tokens": jnp.asarray(batches[0])})
    opt = ts.init_opt(params)
    steps = []
    for b in batches:
        params, opt, m = ts.step_fn(params, opt, {"tokens": b})
        steps.append({k: float(v) for k, v in m.items()})
    return dict(variant=request.param, cfg_j=cfg_j, cfg=cfg_t, np0=np0,
                batches=batches, mesh=mesh,
                metrics={k: float(v) for k, v in metrics.items()},
                grads=jax.device_get(grads), steps=steps,
                params=jax.device_get(params))


def _port_step(cfg, zero=False):
    return make_train_step(cfg, optimizer=AdamWConfig(lr=LR), zero=zero,
                           device="cpu")


def _port_model(ref):
    model = _port_step(ref["cfg"]).init_params(0)
    model.load_state_dict(params_from_jax(ref["np0"], ref["cfg"]))
    return model


def _grads(model, batch, remat):
    loss, metrics = loss_fn(model, {"tokens": batch}, remat=remat)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return ({k: float(v.detach()) for k, v in metrics.items()},
            dict(zip(names, grads)))


def test_forward_loss_and_grads_match_jax(ref):
    metrics, grads = _grads(_port_model(ref), ref["batches"][0], True)
    assert set(metrics) == {"lm_loss", "aux_loss", "loss"}
    assert metrics["aux_loss"] > 0.5          # E sum f P is 1 when balanced
    for k in ("lm_loss", "aux_loss", "loss"):
        assert_allclose(metrics[k], ref["metrics"][k], rtol=1e-5, err_msg=k)
    w = ref["cfg"].router_aux_weight
    assert_allclose(metrics["loss"], metrics["lm_loss"]
                    + w * metrics["aux_loss"], rtol=1e-7)
    want = params_from_jax(ref["grads"], ref["cfg"])
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g.abs().max() > 0, name
        assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                        err_msg=name)


def test_remat_on_and_off_give_the_same_gradients(ref):
    """The remat rerun repeats each MoE's routing bit for bit, so the
    gradients with and without remat are equal."""
    model = _port_model(ref)
    m1, g1 = _grads(model, ref["batches"][0], remat=True)
    m0, g0 = _grads(model, ref["batches"][0], remat=False)
    assert m1 == m0
    for name in g1:
        torch.testing.assert_close(g1[name], g0[name], rtol=0, atol=0)


def test_three_train_steps_match_jax(ref):
    ts = _port_step(ref["cfg"])
    model = _port_model(ref)
    opt = ts.init_opt(model)
    for step, b in enumerate(ref["batches"]):
        model, opt, m = ts.step_fn(model, opt, {"tokens": b})
        assert set(m) == {"lm_loss", "aux_loss", "loss", "grad_norm"}
        for k, want in ref["steps"][step].items():
            assert_allclose(float(m[k]), want, rtol=1e-5,
                            err_msg=f"step {step} {k}")
    assert int(opt.step) == STEPS
    want = params_from_jax(ref["params"], ref["cfg"])
    got = model.state_dict()
    for name, w in want.items():
        assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-4, atol=5e-5,
                        err_msg=name)


def test_zero_step_matches_the_plain_step(ref):
    """The ZeRO 1 x 1 step (the default: the taped loss program with its
    MLA and MoE steps over flat master rows) against the plain step on the
    same batches: each step's metrics, ``aux_loss`` among them, and the
    gradients of the first batch."""
    runs = {}
    for zero in (False, True):
        ts = _port_step(ref["cfg"], zero=zero)
        assert ts.zero is zero
        state = params_from_jax(ref["np0"], ref["cfg"])
        params = (ts.shard_params_fn(state) if zero
                  else _port_model(ref))
        _, grads = ts.grad_fn(params, {"tokens": ref["batches"][0]})
        opt = ts.init_opt(params)
        metrics = []
        for b in ref["batches"][:2]:
            params, opt, m = ts.step_fn(params, opt, {"tokens": b})
            metrics.append({k: float(v) for k, v in m.items()})
        runs[zero] = metrics, grads
    (m_plain, g_plain), (m_zero, g_zero) = runs[False], runs[True]
    for step, (a, b) in enumerate(zip(m_zero, m_plain)):
        assert set(a) == set(b)
        assert a["aux_loss"] > 0.5
        for k in a:
            assert_allclose(a[k], b[k], rtol=1e-6, err_msg=f"step {step} {k}")
    assert set(g_zero) == set(g_plain)
    for name, g in g_plain.items():
        assert_allclose(g_zero[name].numpy(), g.numpy(), rtol=1e-5,
                        atol=1e-7, err_msg=name)


def test_the_drops_variant_drops_tokens(ref, monkeypatch):
    """What each variant exercises: at capacity factor 1.0 the MoE drops
    some of the batch's token picks (affinities that miss their expert's
    capacity), at 8 none. Counted from the capacity ``top_k`` of the loss's
    forward."""
    calls = []

    def top_k(x, k):
        vals, idx = real(x, k)
        calls.append((x, vals))
        return vals, idx
    real = mlp.top_k
    monkeypatch.setattr(mlp, "top_k", top_k)
    with torch.no_grad():
        loss_fn(_port_model(ref), {"tokens": ref["batches"][0]})
    (A_t, kept), = [(x, v) for x, v in calls
                    if x.shape[0] == ref["cfg"].num_experts]
    picks = int((A_t > 0).sum())
    assert picks == B * S * ref["cfg"].top_k
    dropped = picks - int((kept > 0).sum())
    assert (dropped > 0) == (ref["variant"] == "drops"), dropped


# ---------------------------------------------------------------------------
# the modules' backwards against jax.vjp
# ---------------------------------------------------------------------------

def _layer1(ref):
    """The MoE layer's JAX params (numpy) and the port's block."""
    tree = jax.tree.map(lambda a: np.asarray(a)[0], ref["np0"]["body"][0])
    return tree, _port_model(ref).blocks[1]


def _scale_tol(want):
    """float32 at the array's scale: ``atol`` 2e-6 of its largest entry."""
    return dict(rtol=2e-4, atol=2e-6 * float(np.abs(np.asarray(want)).max()))


def test_moe_backward_matches_jax_vjp(ref):
    """``moe_forward``'s gradients (through the scatter of the gates into
    the affinities, the capacity ``top_k``'s gathered values, the token
    gather and the ``index_put_`` combine), against ``jax.vjp`` of the
    reference's, with the output's and the aux loss's cotangents: x and
    every MoE leaf, with and without drops."""
    cfg_j, cfg_t = ref["cfg_j"], ref["cfg"]
    tree, blk = _layer1(ref)
    rng = np.random.default_rng(21)
    x = rng.normal(size=(B, S, cfg_t.d_model)).astype(np.float32)
    dout = rng.normal(size=x.shape).astype(np.float32)
    plan_j = plan_from_mesh(ref["mesh"])
    (out_j, aux_j), vjp = jax.vjp(
        lambda p, xv: jax_moe_forward(p, xv, cfg_j, plan_j),
        tree["moe"], jnp.asarray(x))
    dp_j, dx_j = vjp((jnp.asarray(dout), jnp.float32(1.0)))
    leaves = dict(blk.moe.named_parameters())
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t, aux_t = mlp.moe_forward(blk.moe, xt, cfg_t)
    got = torch.autograd.grad((out_t, aux_t), [xt, *leaves.values()],
                              (torch.from_numpy(dout), torch.tensor(1.0)))
    assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                    **_scale_tol(out_j))
    assert_allclose(float(aux_t.detach()), float(aux_j), rtol=1e-5)
    assert_allclose(got[0].numpy(), np.asarray(dx_j), **_scale_tol(dx_j),
                    err_msg="dx")
    flat = {}
    for path, v in jax.tree_util.tree_flatten_with_path(dp_j)[0]:
        flat[".".join(k.key for k in path)] = np.asarray(v)
    assert set(flat) == set(leaves)
    for (name, _), g in zip(leaves.items(), got[1:]):
        assert g.abs().max() > 0, name
        assert_allclose(g.numpy(), flat[name], **_scale_tol(flat[name]),
                        err_msg=name)


def test_mla_backward_matches_jax_vjp(ref):
    """``mla_forward``'s gradients at the reduced head dims (96, 64) on the
    CPU's plain attention: through the rope key's expand and the two
    concatenations into one shared key, against ``jax.vjp`` of the
    reference's (its attention is ``flash_attention_triangular``)."""
    cfg_j, cfg_t = ref["cfg_j"], ref["cfg"]
    tree, blk = _layer1(ref)
    rng = np.random.default_rng(22)
    x = rng.normal(size=(B, S, cfg_t.d_model)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    pos = np.arange(S)
    plan_j = plan_from_mesh(ref["mesh"])
    y_j, vjp = jax.vjp(lambda p, xv: jax_mla_forward(
        p, xv, cfg_j, plan_j, jnp.asarray(pos))[0], tree["attn"],
        jnp.asarray(x))
    dp_j, dx_j = vjp(jnp.asarray(dy))
    leaves = dict(blk.attn.named_parameters())
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = attention.mla_forward(blk.attn, xt, cfg_t, PLAN,
                                torch.from_numpy(pos))[0]
    got = torch.autograd.grad(y_t, [xt, *leaves.values()],
                              torch.from_numpy(dy))
    assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **_scale_tol(y_j))
    assert_allclose(got[0].numpy(), np.asarray(dx_j), **_scale_tol(dx_j),
                    err_msg="dx")
    for (name, _), g in zip(leaves.items(), got[1:]):
        want = np.asarray(dp_j[name])
        assert g.abs().max() > 0, name
        assert_allclose(g.numpy(), want, **_scale_tol(want), err_msg=name)


def test_launcher_trains_deepseek_on_cpu(capsys):
    launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert "(improved)" in out
