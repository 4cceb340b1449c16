"""pixtral-12b (an embed frontend) in the port against the JAX package, on
the CPU; and the attention backward's plain path for non-causal and cross
attention.

``pixtral-12b.reduced()`` (2 layers, d_model 256, 4 q and 2 kv heads of
64, float32) with ``vocab_size=1000`` (padded to 1024 logit columns, so
greedy selection must mask 24): the JAX params of ``PRNGKey(0)`` carried
into the port through ``params_from_jax``, the same numpy-seeded inputs
through both packages (``tests/torch_frontend_parity.py``): prefill from
patch embeddings ``{"embeds"}``, decode from token ids, training from
``{"embeds", "labels"}``. Held as ``test_torch_encdec.py`` holds whisper:
the prefill's hidden and caches, two decode steps' logits, ``forward_loss``
and every gradient (``embed``'s is zero: the loss reads embeddings, not
ids, and JAX's gradient is zero too), three AdamW steps of the plain and
the ZeRO 1 x 1 step against the JAX ``make_train_step``, and the greedy ids
of the classic loop, identical to the JAX ``classic_loop``'s.

The plain attention's autograd with ``causal=False``, Sq == Sk (an
encoder) and Sq != Sk (cross-attention, ragged against its 512-row
blocks), is held to ``jax.vjp`` of the reference's ``flash_attention_ref``
at 1e-5: the plain version the card's backward kernels are held to.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jax_flash_attention_ref)
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model_zoo import loss_fn  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402

import torch_frontend_parity as P  # noqa: E402

ARCH = "pixtral-12b"


@pytest.fixture(scope="module")
def env():
    env = P.build(ARCH, vocab_size=1000)
    assert env["cfg"].padded_vocab() == 1024
    env["serve"] = P.jax_serving(env)
    env["train"] = P.jax_training(env)
    return env


def test_config_equals_the_reference_field_for_field():
    a, b = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced())
    assert a.param_count() == b.param_count() == 12_247_777_280


def test_prefill_from_embeds_matches_jax(env):
    js = env["serve"]
    assert set(js["batch"]) == {"embeds"}
    h, caches = T.prefill(env["model"], js["batch"], P.CACHE_LEN)
    assert_allclose(P.np32(h), js["h"], **P.F32)
    for li, (got, want) in enumerate(zip(caches, js["caches"])):
        assert set(got) == set(want) == {"k", "v"}
        for key, w in want.items():
            assert tuple(got[key].shape) == w.shape == (
                P.B, P.CACHE_LEN, 2, 64), key
            assert_allclose(P.np32(got[key]), P.np32(w), rtol=2 ** -7,
                            atol=1e-6, err_msg=f"layer {li} {key}")


def test_decode_from_tokens_matches_jax(env):
    js = env["serve"]
    model = env["model"]
    h, caches = T.prefill(model, js["batch"], P.CACHE_LEN)
    assert_allclose((h[:, 0] @ model.unembed).numpy(), js["logits0"],
                    **P.F32)
    pos = torch.full((P.B,), P.S, dtype=torch.int32)
    for step, (tok, want) in enumerate(zip(js["toks"],
                                           js["decode_logits"])):
        logits, caches = T.decode_step(model, caches, torch.from_numpy(tok),
                                       pos)
        assert logits.shape == (P.B, 1024)
        assert_allclose(logits.numpy(), want, **P.decode_tol(want),
                        err_msg=f"decode step {step}")
        pos = pos + 1


def test_forward_loss_and_grads_match_jax(env):
    jt = env["train"]
    ts = make_train_step(env["cfg"], zero=False, device="cpu")
    model = ts.init_params(0)
    model.load_state_dict(env["state"])
    _, metrics = loss_fn(model, jt["batches"][0])
    for k in ("lm_loss", "aux_loss", "loss"):
        assert_allclose(float(metrics[k]), jt["metrics"][k], rtol=1e-5,
                        err_msg=k)
    _, grads = ts.grad_fn(model, jt["batches"][0])
    want = params_from_jax(jt["grads"], env["cfg"])
    assert set(grads) == set(want)
    assert not grads["embed"].any() and not want["embed"].any()
    for name, g in grads.items():
        assert name == "embed" or g.abs().max() > 0, name
        assert_allclose(g.numpy(), want[name].numpy(), **P.GRAD,
                        err_msg=name)


@pytest.mark.parametrize("zero", [False, True])
def test_three_train_steps_match_jax(env, zero):
    jt = env["train"]
    ts = make_train_step(env["cfg"], optimizer=AdamWConfig(lr=P.LR),
                         zero=zero, device="cpu")
    if zero:
        params = ts.shard_params_fn(env["state"])
    else:
        params = ts.init_params(0)
        params.load_state_dict(env["state"])
    opt = ts.init_opt(params)
    for step, b in enumerate(jt["batches"]):
        params, opt, m = ts.step_fn(params, opt, b)
        for k, want in jt["steps"][step].items():
            assert_allclose(float(m[k]), want, rtol=1e-5,
                            err_msg=f"step {step} {k}")
    got = ts.gather_params_fn(params) if zero else params.state_dict()
    P.check_params(got, params_from_jax(jt["params"], env["cfg"]),
                   params_from_jax(jt["grad_max"], env["cfg"]))


def test_classic_loop_tokens_match_the_jax_classic_loop(env, monkeypatch,
                                                        capsys):
    want = P.jax_classic_tokens(env["cfg_j"], monkeypatch)
    got = launch_serve.classic_loop(env["cfg"], P.classic_args(),
                                    params=env["model"])
    np.testing.assert_array_equal(got, want)
    assert (got < 1000).all()
    assert "serve ok (classic loop)" in capsys.readouterr().out


@pytest.mark.parametrize("Sq,Sk,H,KV", [(100, 100, 4, 2), (37, 600, 4, 1),
                                        (600, 37, 2, 2)])
def test_plain_backward_non_causal_and_cross_matches_jax_vjp(Sq, Sk, H, KV):
    """Autograd through the plain ``flash_attention`` with ``causal=False``
    (Sq == Sk, and Sq != Sk on either side of the 512-row block) against
    ``jax.vjp`` of the reference's ``flash_attention_ref``: output and dq,
    dk, dv at 1e-5."""
    rng = np.random.default_rng(Sq + Sk)
    q, k, v = (rng.normal(size=(2, s, h, 64)).astype(np.float32)
               for s, h in ((Sq, H), (Sk, KV), (Sk, KV)))
    do = rng.normal(size=(2, Sq, H, 64)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda *a: jax_flash_attention_ref(
        *a, causal=False), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=False)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    tol = dict(rtol=1e-5, atol=1e-5)
    assert_allclose(out.detach().numpy(), np.asarray(out_j), **tol)
    for name, g, w in zip("qkv", got, want):
        assert_allclose(g.numpy(), np.asarray(w), **tol, err_msg=f"d{name}")
