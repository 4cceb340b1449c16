"""The port's model slice against the JAX package's, on reduced qwen3.

``qwen3-1.7b.reduced()`` with ``vocab_size=1000`` (padded to 1024 logit
columns), float32 compute: the JAX params are built with ``jax.random`` and
loaded into the port through ``params_from_jax``. Prefill logits, prefill
caches and three decode steps go through the JAX ``lower_serve_stages``
stages and the port's, fed the same token ids. Tolerances: float32
``rtol=2e-4, atol=2e-5`` on logits and hiddens (XLA and PyTorch sum in
different orders); the prefill caches are bfloat16 in both packages, where
one rounding may differ by an ulp, so they compare at ``2e-2``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core.lowering import lower_serve_stages as jax_lower  # noqa: E402
from repro.models.common import apply_rope as jax_rope  # noqa: E402
from repro.models.common import rms_norm as jax_rms  # noqa: E402
from repro.models.model_zoo import build_model as jax_build  # noqa: E402
from repro.train.steps import plan_from_mesh  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.lowering import lower_serve_stages  # noqa: E402
from repro_torch.models.common import (MeshPlan, apply_rope,  # noqa: E402
                                       rms_norm)
from repro_torch.models.convert import (params_from_jax,  # noqa: E402
                                        unstack_layers)
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
CACHE_LEN = 24
PROMPTS = (7, 5)


def _mesh():
    """The reference's 1x1 mesh with Auto axes. jax 0.9 makes Explicit axes
    by default, and the reference's serving path scatters a slot into its
    mesh-typed group caches, which only Auto axes accept."""
    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((1, 1), ("data", "model"), **kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def env():
    cfg_j = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                                vocab_size=1000)
    cfg_t = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                                vocab_size=1000)
    assert cfg_t.padded_vocab() == 1024
    mesh = _mesh()
    params = jax_build(cfg_j, plan_from_mesh(mesh)).init(jax.random.PRNGKey(0))
    np_params = jax.device_get(params)
    with torch.device("meta"):
        model = Transformer(cfg_t, MeshPlan.single_device())
    model.load_state_dict(params_from_jax(np_params, cfg_t), assign=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 1000, (n,)).astype(np.int32) for n in PROMPTS]
    return cfg_j, cfg_t, mesh, params, model, prompts


# ---------------------------------------------------------------------------
# numerics units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_rope_matches_jax(dtype, tol):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 4, 64)).astype(np.float32)
    pos = np.arange(6) * 37
    want = jax_rope(jnp.asarray(x, dtype), jnp.asarray(pos), 1.0, 1e6)
    got = apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                     torch.from_numpy(pos), 1.0, 1e6)
    assert got.dtype == getattr(torch, dtype)
    assert_allclose(_np(got), _np(want), **tol)


def test_rope_pairs_interleaved_elements():
    """RoPE rotates (x[0], x[1]), (x[2], x[3]), ... — not the halves."""
    x = torch.zeros((1, 1, 1, 8))
    x[..., 0] = 1.0
    out = apply_rope(x, torch.tensor([1]), 1.0, 1e4)
    assert out[..., 1].abs().item() > 0.5          # partner of 0 is 1
    assert out[..., 4].abs().item() == 0.0          # not the rotate-half 4


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_rms_norm_matches_jax(dtype, tol):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(3, 5, 64)) * 3).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    want = jax_rms(jnp.asarray(x, dtype), jnp.asarray(w, dtype), 1e-5)
    got = rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                   torch.from_numpy(w).to(getattr(torch, dtype)), 1e-5)
    assert_allclose(_np(got), _np(want), **tol)


def test_params_from_jax_covers_every_leaf(env):
    cfg_j, cfg_t, _, params, model, _ = env
    n_jax = sum(int(np.prod(np.shape(a)))
                for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    blk = unstack_layers(jax.device_get(params), cfg_t)[1]
    assert_allclose(model.blocks[1].attn.wq.numpy(),
                    np.asarray(blk["attn"]["wq"]))


def test_port_init_is_seeded_and_shaped(env):
    cfg_t = env[1]
    plan = MeshPlan.single_device()
    a = build_model(cfg_t, plan, seed=3, device="cpu")
    b = build_model(cfg_t, plan, seed=3, device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert {k: tuple(v.shape) for k, v in a.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in env[4].state_dict().items()}
    assert not any(p.requires_grad for p in a.parameters())


# ---------------------------------------------------------------------------
# stage slices: prefill and decode
# ---------------------------------------------------------------------------

def _jax_layer_caches(tree):
    """Per-layer caches of a stage's {"prologue", "body"} tree (period 1)."""
    out = [dict(c) for c in tree["prologue"]]
    for slot in tree["body"]:
        for i in range(np.shape(slot["k"])[0]):
            out.append({k: np.asarray(v)[i] for k, v in slot.items()})
    return out


def _stages(env, num_stages):
    cfg_j, cfg_t, mesh, params, model, _ = env
    js = jax_lower(cfg_j, mesh, params, num_stages=num_stages,
                   cache_len=CACHE_LEN, max_prompt_len=8,
                   group_size=len(PROMPTS))
    ts = lower_serve_stages(cfg_t, model, num_stages=num_stages,
                            cache_len=CACHE_LEN, max_prompt_len=8,
                            group_size=len(PROMPTS))
    return js, ts


def _prefill(js, ts, toks):
    S = toks.size
    xj = jnp.asarray(toks[None])
    xt = torch.from_numpy(toks[None])
    cj, ct = [], []
    for sj, st in zip(js.stages, ts.stages):
        xj, caj = sj.prefill(sj.params, xj, jnp.full((1,), S - 1, jnp.int32))
        with torch.inference_mode():
            xt, cat = st.prefill(st.params, xt, S - 1)
        cj.append(caj)
        ct.append(cat)
    return (xj, cj), (xt, ct)


@pytest.mark.parametrize("num_stages", [1, 2])
def test_prefill_logits_and_caches_match_jax(env, num_stages):
    js, ts = _stages(env, num_stages)
    toks = env[5][0]
    S = toks.size
    (lj, cj), (lt, ct) = _prefill(js, ts, toks)
    assert lt.shape == (1, 1024)
    assert_allclose(_np(lt), _np(lj), **F32)
    for sj, st in zip(cj, ct):
        for jc, tc in zip(_jax_layer_caches(sj), st):
            for key in ("k", "v"):
                assert tc[key].dtype == torch.bfloat16
                assert tc[key].shape[1] == S           # unpadded
                assert_allclose(_np(tc[key]), _np(jc[key])[:, :S], **BF16)
                assert not np.asarray(jc[key], np.float32)[:, S:].any()


@pytest.mark.parametrize("num_stages", [1, 2])
def test_three_decode_steps_match_jax(env, num_stages):
    """Two requests of unequal prompt lengths prefilled into the slots of a
    group, then three decode steps; every step's logits agree and the port
    writes its caches in place."""
    cfg_t = env[1]
    js, ts = _stages(env, num_stages)
    G = len(PROMPTS)
    jc = [s.init_caches(jnp.zeros((G,), jnp.int32)) for s in js.stages]
    with torch.inference_mode():
        tc = [s.init_caches(G) for s in ts.stages]
    assert tc[0][0]["k"].dtype == torch.float32      # cfg dtype for .reduced()
    tok = []
    for b, toks in enumerate(env[5]):
        (lj, cjs), (_, cts) = _prefill(js, ts, toks)
        for s, (sj, st) in enumerate(zip(js.stages, ts.stages)):
            jc[s] = sj.write_slot(jc[s], cjs[s], b)
            with torch.inference_mode():
                st.write_slot(tc[s], cts[s], b)
        tok.append(int(np.argmax(np.asarray(lj)[0, :cfg_t.vocab_size])))
    pos = np.asarray(PROMPTS, np.int32)
    for step in range(3):
        xj = jnp.asarray(tok, jnp.int32)
        xt = torch.tensor(tok, dtype=torch.int32)
        pt = torch.from_numpy(pos.copy())
        for s, (sj, st) in enumerate(zip(js.stages, ts.stages)):
            xj, jc[s] = sj.decode(sj.params, jc[s], xj, jnp.asarray(pos))
            with torch.inference_mode():
                xt, same = st.decode(st.params, tc[s], xt, pt)
            assert same is tc[s]
        assert_allclose(_np(xt), _np(xj), **F32)
        tok = [int(t) for t in np.argmax(np.asarray(xj)[:, :1000], axis=-1)]
        pos = pos + 1
    # decode wrote full-precision k/v at the decoded positions, in place
    last = _jax_layer_caches(jc[-1])[-1]["k"]
    assert_allclose(_np(tc[-1][-1]["k"]), _np(last), **F32)
