"""What ``test_torch_encdec.py`` (whisper) and ``test_torch_frontend.py``
(pixtral) share: the reduced config in both packages, the JAX params carried
into the port, numpy-seeded batches in the reference's forms, and the JAX
side's runs (its whole-model ``prefill`` / ``decode_step``, its loss and
gradients, its ``make_train_step``, its ``classic_loop``), each computed
once per file. Imports jax; the files that use it skip without it.

The JAX functions are called as the reference's own smoke tests call them:
outside ``shard_map`` on the 1 x 1 plan (``repro/models/common.py``
``force_vary`` and ``certified_pmean`` are no-ops there), under
``jax.jit``; ``make_train_step`` and ``classic_loop`` on a 1 x 1 mesh with
Auto axes (jax 0.9 makes Explicit ones by default).
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.launch import serve as jax_serve
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jax_build
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.train.steps import make_train_step as jax_make_train_step
from repro.train.steps import plan_from_mesh
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import classic_batch
from repro_torch.models.common import MeshPlan
from repro_torch.models.convert import params_from_jax, unstack_layers
from repro_torch.models.transformer import Transformer

#: float32 outputs, logits and caches (XLA and PyTorch sum in other orders)
F32 = dict(rtol=2e-4, atol=2e-5)


def decode_tol(want):
    """Decode logits read bf16 caches, where a last-bit float32 difference
    can round an entry to the next bf16 value: ``F32`` with ``atol`` at the
    logits' scale (2e-5 of the largest)."""
    return dict(rtol=2e-4, atol=2e-5 * max(1.0, float(np.abs(want).max())))


#: gradients (tests/test_torch_train.py)
GRAD = dict(rtol=1e-4, atol=1e-6)
LR = 3e-4
#: params after three AdamW steps: ``rtol=1e-4, atol=5e-5`` (as
#: tests/test_torch_deepseek_train.py), but for the elements whose gradient
#: is rounding noise: below ``NOISE`` of the largest |g| of any element in
#: any of the three steps (the JAX run's), held within ``atol=LR``. AdamW
#: divides a gradient by its own running scale, so such an element moves by
#: a share of lr that the noise decides: on reduced whisper one embedding
#: element, its |g| 2.8e-7 of the largest, lands 1.5e-4 (0.51 lr) from the
#: JAX run.
PARAMS = dict(rtol=1e-4, atol=5e-5)
NOISE = 1e-6


def check_params(got, want, grad_max):
    """``got`` and ``want`` (``state_dict``s) to :data:`PARAMS`, but the
    elements whose ``grad_max`` (the JAX run's largest |g| over the steps,
    a ``state_dict`` too) is below :data:`NOISE` of the largest of all,
    which are held within ``atol=LR``."""
    floor = NOISE * max(float(np32(g).max()) for g in grad_max.values())
    for name, w in want.items():
        g, w = np32(got[name]), np32(w)
        noise = np32(grad_max[name]) < floor
        np.testing.assert_allclose(g[~noise], w[~noise], **PARAMS,
                                   err_msg=name)
        np.testing.assert_allclose(g[noise], w[noise], rtol=PARAMS["rtol"],
                                   atol=LR, err_msg=f"{name} (noise)")


STEPS = 3
B, S = 2, 32
CACHE_LEN = 48          # the classic loop's: prompt 32 + gen 8 + 8
GEN = 8
PLAN = MeshPlan.single_device()


def mesh():
    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((1, 1), ("data", "model"), **kw)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def classic_args(**kw):
    return argparse.Namespace(**{**dict(
        batch=B, prompt_len=S, gen=GEN, cache_len=0, seed=0, device="cpu",
        mesh="1x1"), **kw})


def jax_classic_tokens(cfg_j, monkeypatch):
    """The JAX ``classic_loop``'s ids (B, GEN + 1): the array it stacks,
    caught at its ``np.stack``."""
    caught = []
    real = np.stack

    def stack(arrays, axis=0, **kw):
        out = real(arrays, axis=axis, **kw)
        caught.append(out)
        return out
    monkeypatch.setattr(np, "stack", stack)
    jax_serve.classic_loop(cfg_j, classic_args(), mesh())
    monkeypatch.setattr(np, "stack", real)
    (gen,) = [a for a in caught if a.shape == (B, GEN + 1)]
    return gen


def build(arch, vocab_size=None):
    """The reduced configs (``vocab_size`` overridden when given), the JAX
    params of ``PRNGKey(0)`` (what the JAX ``classic_loop`` serves) and the
    port's model loaded with them."""
    cfg_j, cfg_t = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if vocab_size:
        cfg_j = dataclasses.replace(cfg_j, vocab_size=vocab_size)
        cfg_t = dataclasses.replace(cfg_t, vocab_size=vocab_size)
    plan_j = plan_from_mesh(mesh())
    params = jax_build(cfg_j, plan_j).init(jax.random.PRNGKey(0))
    np_params = jax.device_get(params)
    state = params_from_jax(np_params, cfg_t)
    with torch.device("meta"):
        model = Transformer(cfg_t, PLAN)
    model.load_state_dict(state, assign=True)
    return dict(cfg_j=cfg_j, cfg=cfg_t, plan_j=plan_j, params=params,
                np_params=np_params, state=state, model=model)


def jax_serving(env, seed=2):
    """The JAX whole-model prefill of a numpy-seeded prompt batch (hidden,
    every layer's cache), then two decode steps from its greedy tokens."""
    cfg_j, plan_j, params = env["cfg_j"], env["plan_j"], env["params"]
    batch = classic_batch(cfg_j, B, S, np.random.default_rng(seed))
    prefill = jax.jit(lambda p, b: JT.prefill(p, b, cfg_j, plan_j,
                                              CACHE_LEN))
    decode = jax.jit(lambda p, c, t, q: JT.decode_step(p, c, t, q, cfg_j,
                                                       plan_j))
    h, caches = prefill(params, {k: jnp.asarray(v) for k, v in batch.items()})
    layers = [{k: np.asarray(v) for k, v in c.items()}
              for c in unstack_layers(jax.device_get(caches), env["cfg"])]
    logits0 = np.asarray(h[:, 0] @ params["unembed"].astype(h.dtype))
    toks, steps = [], []
    tok = np.argmax(logits0[:, :cfg_j.vocab_size], -1).astype(np.int32)
    pos = np.full((B,), S, np.int32)
    for _ in range(2):
        toks.append(tok)
        logits, caches = decode(params, caches, jnp.asarray(tok),
                                jnp.asarray(pos))
        steps.append(np.asarray(logits))
        tok = np.argmax(steps[-1][:, :cfg_j.vocab_size], -1).astype(np.int32)
        pos = pos + 1
    return dict(batch=batch, h=np.asarray(h), caches=layers,
                logits0=logits0, toks=toks, decode_logits=steps)


def jax_training(env, seed=3, train_step=True):
    """The JAX loss, metrics and gradients of one batch, and three AdamW
    steps (metrics each step, params after): through the JAX
    ``make_train_step`` (plain), or with ``train_step=False`` through the
    same reference functions it runs inside ``shard_map`` -- ``loss_fn``
    under ``jax.value_and_grad`` and ``optim/zero.py:
    plain_dp_adamw_update`` on the 1 x 1 plan, each jitted, outside
    ``shard_map`` (for whisper, whose ``make_train_step`` raises under jax
    0.9's vma check: ``test_torch_encdec.py`` pins that)."""
    from repro.optim.adamw import init_adamw
    from repro.optim.zero import plain_dp_adamw_update
    cfg_j, plan_j = env["cfg_j"], env["plan_j"]
    rng = np.random.default_rng(seed)
    batches = [classic_batch(cfg_j, B, S, rng, "train")
               for _ in range(STEPS)]
    bundle = jax_build(cfg_j, plan_j)
    value_and_grad = jax.jit(jax.value_and_grad(bundle.loss_fn, has_aux=True))
    params = jax.tree.map(jnp.array, env["params"])
    (_, metrics), grads = value_and_grad(
        params, {k: jnp.asarray(v) for k, v in batches[0].items()})
    out = dict(batches=batches,
               metrics={k: float(v) for k, v in metrics.items()},
               grads=jax.device_get(grads), steps=[])
    opt_cfg = JaxAdamW(lr=LR)
    grad_max = jax.tree.map(jnp.zeros_like, params)

    def grad_at(params, b):
        """The step's loss and gradients at ``params``, its |g| folded into
        ``grad_max``."""
        nonlocal grad_max
        (_, m), g = value_and_grad(
            params, {k: jnp.asarray(v) for k, v in b.items()})
        grad_max = jax.tree.map(lambda a, x: jnp.maximum(a, jnp.abs(x)),
                                grad_max, g)
        return m, g

    if train_step:
        ts = jax_make_train_step(cfg_j, mesh(), optimizer=opt_cfg, zero=False)
        opt = ts.init_opt(params)
        for b in batches:
            grad_at(params, b)
            params, opt, m = ts.step_fn(params, opt, b)
            out["steps"].append({k: float(v) for k, v in m.items()})
    else:
        ones = jax.tree.map(lambda _: 1, params)
        update = jax.jit(lambda p, g, st: plain_dp_adamw_update(
            opt_cfg, p, g, st, plan_j, ones))
        opt = init_adamw(params)
        for b in batches:
            m, g = grad_at(params, b)
            params, opt, gnorm = update(params, g, opt)
            out["steps"].append({**{k: float(v) for k, v in m.items()},
                                 "grad_norm": float(gnorm)})
    out["params"] = jax.device_get(params)
    out["grad_max"] = jax.device_get(grad_max)
    return out
