"""whisper-medium (encoder-decoder) in the port against the JAX package, on
the CPU.

``whisper-medium.reduced()`` (2 encoder and 2 decoder layers, d_model 256,
4 q and 2 kv heads of 64, 64 encoder frames, vocab 1024, float32): the JAX
params of ``PRNGKey(0)`` carried into the port through ``params_from_jax``,
the same numpy-seeded inputs through both packages
(``tests/torch_frontend_parity.py``). Held, at float32 ``rtol=2e-4,
atol=2e-5`` (XLA and PyTorch sum in other orders):

* the whole-model prefill's last hidden and every layer's cache leaf
  (``k``, ``v`` padded to the cache length, ``xk``, ``xv`` rounded to
  bfloat16 as the reference rounds them; within one bf16 step) and two
  decode steps' logits (``atol`` at 2e-5 of the logits' scale: they read
  the bf16 caches);
* ``forward_loss`` and every gradient (``rtol=1e-4, atol=1e-6``), and
  three AdamW steps of the plain and the ZeRO 1 x 1 step against the JAX
  step's own functions (its ``loss_fn`` under ``jax.value_and_grad``, then
  ``plain_dp_adamw_update``, outside ``shard_map``): each step's metrics to
  1e-5 relative, the params after them to ``rtol=1e-4, atol=5e-5`` (but
  within lr where the gradient is rounding noise, below 1e-6 of the
  largest: ``torch_frontend_parity.check_params``);
* the greedy ids of 8 steps of the port's ``classic_loop``, identical to
  the JAX ``classic_loop``'s.

It also pins a reference surface: the reference's decode rotates no RoPE
into the cross-attention's q (``_cross_attn_decode``, ``repro/models/
transformer.py:231-242``) while its prefill does (``attention.py:129-132``),
so its decode after a 32-token prefill is not the 33-token prefill's last
position; the port reproduces the JAX decode, gap included. And another:
the JAX ``make_train_step`` raises for whisper under jax 0.9, whose
``shard_map`` checks the varying axes of a scan's carry: the encoder's
scan (``transformer.py:406-416``) starts from a carry varying over
``data`` only and returns one varying over ``model`` too.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model_zoo import loss_fn  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402

import torch_frontend_parity as P  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ARCH = "whisper-medium"


@pytest.fixture(scope="module")
def env():
    env = P.build(ARCH)
    env["serve"] = P.jax_serving(env)
    env["train"] = P.jax_training(env, train_step=False)
    return env


def test_config_equals_the_reference_field_for_field():
    a, b = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced())
    assert a.param_count() == b.param_count() == 1_012_523_008


def test_prefill_hidden_and_caches_match_jax(env):
    js = env["serve"]
    h, caches = T.prefill(env["model"], js["batch"], P.CACHE_LEN)
    assert_allclose(P.np32(h), js["h"], **P.F32)
    assert len(caches) == len(js["caches"]) == env["cfg"].num_layers
    for li, (got, want) in enumerate(zip(caches, js["caches"])):
        assert set(got) == set(want) == {"k", "v", "xk", "xv"}
        for key, w in want.items():
            assert got[key].dtype == torch.bfloat16, key
            assert tuple(got[key].shape) == w.shape, key
            assert_allclose(P.np32(got[key]), P.np32(w), rtol=1e-2,
                            atol=1e-2, err_msg=f"layer {li} {key}")
            # the bf16 rounding of the same float32 values: at most one
            # bf16 step apart
            assert_allclose(P.np32(got[key]), P.np32(w), rtol=2 ** -7,
                            atol=1e-6, err_msg=f"layer {li} {key}")
        assert not caches[li]["k"][:, P.S:].any()     # padding past the prompt


def test_two_decode_steps_match_jax(env):
    js = env["serve"]
    model = env["model"]
    h, caches = T.prefill(model, js["batch"], P.CACHE_LEN)
    logits0 = (h[:, 0] @ model.unembed).numpy()
    assert_allclose(logits0, js["logits0"], **P.F32)
    pos = torch.full((P.B,), P.S, dtype=torch.int32)
    for step, (tok, want) in enumerate(zip(js["toks"],
                                           js["decode_logits"])):
        logits, caches = T.decode_step(model, caches, torch.from_numpy(tok),
                                       pos)
        assert_allclose(logits.numpy(), want, **P.decode_tol(want),
                        err_msg=f"decode step {step}")
        pos = pos + 1


def test_reference_cross_decode_rope_gap_is_pinned(env):
    """The reference's decode leaves the cross-attention's q unrotated
    (``transformer.py:231-242``), its prefill rotates it (``attention.py:
    130-132``): the decode at position 32 after a 32-token prefill differs
    from the 33-token prefill's last logits by more than 0.1, and the port
    reproduces the JAX decode (not the prefill), so the gap is the
    reference's own."""
    js = env["serve"]
    cfg_j, plan_j, params = env["cfg_j"], env["plan_j"], env["params"]
    tok = js["toks"][0]
    longer = dict(js["batch"], tokens=np.concatenate(
        [js["batch"]["tokens"], tok[:, None]], axis=1))
    h33, _ = jax.jit(lambda p, b: JT.prefill(p, b, cfg_j, plan_j,
                                             P.CACHE_LEN))(
        params, {k: jnp.asarray(v) for k, v in longer.items()})
    prefill33 = np.asarray(h33[:, 0] @ params["unembed"])
    decode32 = js["decode_logits"][0]
    gap = np.abs(decode32 - prefill33).max()
    assert gap > 0.1, gap
    model = env["model"]
    _, caches = T.prefill(model, js["batch"], P.CACHE_LEN)
    port32, _ = T.decode_step(model, caches, torch.from_numpy(tok),
                              torch.full((P.B,), P.S, dtype=torch.int32))
    assert_allclose(port32.numpy(), decode32, **P.decode_tol(decode32))
    h_t, _ = T.prefill(model, longer, P.CACHE_LEN)
    port33 = (h_t[:, 0] @ model.unembed).numpy()
    assert_allclose(port33, prefill33, **P.F32)
    assert np.abs(port32.numpy() - port33).max() > 0.1


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
    for name, g in grads.items():
        assert g.abs().max() > 0, name
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
    assert got.shape == (P.B, P.GEN + 1)
    np.testing.assert_array_equal(got, want)
    assert "serve ok (classic loop)" in capsys.readouterr().out


def test_reference_make_train_step_is_red_for_whisper(env):
    """The reference surface the training parity works around: its
    ``make_train_step`` traces the encoder's ``lax.scan`` inside
    ``shard_map``, whose carry leaves the body varying over more axes than
    it entered (no ``force_vary``, unlike ``_run_body``'s), which jax 0.9
    refuses."""
    from repro.optim.adamw import AdamWConfig as JaxAdamW
    from repro.train.steps import make_train_step as jax_make_train_step
    ts = jax_make_train_step(env["cfg_j"], P.mesh(),
                             optimizer=JaxAdamW(lr=P.LR), zero=False)
    params = jax.tree.map(jnp.array, env["params"])
    with pytest.raises(TypeError, match="carry"):
        ts.step_fn(params, ts.init_opt(params), env["train"]["batches"][0])
