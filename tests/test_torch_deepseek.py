"""The port's MLA + MoE slice against the JAX package's, on reduced
deepseek-v2-lite-16b.

``deepseek-v2-lite-16b.reduced()`` (2 layers: a leading dense layer, then
MLA with a capacity-routed MoE; d_model 256, 4 heads, kv_lora 64, q/k head
dim nope 64 + rope 32 = 96, v head dim 64, 4 routed experts top-2 plus 2
shared of 256 units, capacity factor 8, float32) with ``vocab_size=1000``
(padded to 1024 logit columns): the JAX params are built with
``jax.random`` and carried into the port by ``params_from_jax``, and the
same numpy-seeded inputs go through both packages. Tolerances: float32
``rtol=2e-4, atol=2e-5`` on outputs, logits and caches (XLA and PyTorch
sum in different orders), the load-balance loss to 1e-5 relative; the MoE
at capacity factor 1.0 drops tokens, and its choice of which is exact
(ties to the lower index, as ``jax.lax.top_k``). Serving must be
token-identical to the JAX ``ServeSession`` on actors and monolithic,
dense and paged (pages recycled), with unequal prompt and generation
lengths, mid-flight admission and decode groups of 2 slots (the MoE's
capacity couples a group's tokens).
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import api as jax_api  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core.lowering import lower_serve_stages as jax_lower  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.models.attention import mla_decode as jax_mla_decode  # noqa: E402
from repro.models.attention import mla_forward as jax_mla_forward  # noqa: E402
from repro.models.mlp import moe_forward as jax_moe_forward  # noqa: E402
from repro.models.model_zoo import build_model as jax_build  # noqa: E402
from repro.train.steps import plan_from_mesh  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.lowering import lower_serve_stages  # noqa: E402
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.core.sbp import ndsbp  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.flash_decode import kernel as fd_kernel  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import attention, mlp  # noqa: E402
from repro_torch.models.common import MeshPlan  # noqa: E402
from repro_torch.models.convert import (jax_leaves,  # noqa: E402
                                        params_from_jax, params_to_jax)
from repro_torch.models.model_zoo import (build_model,  # noqa: E402
                                          cache_specs, loss_fn,
                                          make_decode_caches)
from repro_torch.models.transformer import (Transformer,  # noqa: E402
                                            check_supported)
from repro_torch.train.steps import make_train_step  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ARCH = "deepseek-v2-lite-16b"
F32 = dict(rtol=2e-4, atol=2e-5)
CACHE_LEN = 24
PLAN = MeshPlan.single_device()
PROMPT_LENS = [5, 8, 3, 6, 4]
GENS = [3, 6, 2, 5, 4]
GEOMETRY = dict(num_groups=2, group_size=2, max_prompt_len=max(PROMPT_LENS),
                max_new_tokens=max(GENS), cache_len=CACHE_LEN)
PAGED = dict(cache="paged", page_len=4, num_pages=12)


def _mesh():
    """The reference's 1x1 mesh with Auto axes (its serving path scatters
    into mesh-typed group caches, which only Auto axes accept)."""
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
    cfg_j = dataclasses.replace(jax_get_config(ARCH).reduced(),
                                vocab_size=1000)
    cfg_t = dataclasses.replace(get_config(ARCH).reduced(), vocab_size=1000)
    assert cfg_t.padded_vocab() == 1024 and cfg_t.dtype == "float32"
    mesh = _mesh()
    plan_j = plan_from_mesh(mesh)
    params = jax_build(cfg_j, plan_j).init(jax.random.PRNGKey(0))
    np_params = jax.device_get(params)
    state = params_from_jax(np_params, cfg_t)
    with torch.device("meta"):
        model = Transformer(cfg_t, PLAN)
    model.load_state_dict(state, assign=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 1000, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    # the JAX functions the cases call, jitted once for the module (a
    # compile a shape, shared by the cases of both layers)
    jit = {("moe", f): jax.jit(lambda p, x, f=f: jax_moe_forward(
        p, x, dataclasses.replace(cfg_j, capacity_factor=f), plan_j))
        for f in (8.0, 1.0)}
    jit["mla_forward"] = jax.jit(lambda p, x, pos: jax_mla_forward(
        p, x, cfg_j, plan_j, pos))
    jit["mla_decode"] = jax.jit(lambda p, x, c, kpe, pos: jax_mla_decode(
        p, x, c, kpe, pos, cfg_j, plan_j))
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, mesh=mesh, plan_j=plan_j,
                params=params, np_params=np_params, state=state, model=model,
                prompts=prompts, jit=jit)


def _layer(env, i):
    """Layer i's params: the JAX tree's (numpy) and the port's block. Layer
    0 is the prologue's dense layer, layer 1 the body's MoE layer."""
    if i == 0:
        tree = env["np_params"]["prologue"][0]
    else:
        tree = jax.tree.map(lambda a: np.asarray(a)[i - 1],
                            env["np_params"]["body"][0])
    return tree, env["model"].blocks[i]


def _hidden(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

def test_config_equals_the_reference_field_for_field():
    a, b = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced())
    assert a.param_count() == b.param_count() == 15_706_468_352


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 17, 40])
@pytest.mark.parametrize("layer", [0, 1])
def test_mla_forward_matches_jax(env, layer, S):
    cfg_j, cfg_t = env["cfg_j"], env["cfg_t"]
    p_j, blk = _layer(env, layer)
    x = _hidden(cfg_t, 2, S, seed=S + 10 * layer)
    pos = np.arange(S)
    y_j, (c_j, kpe_j) = env["jit"]["mla_forward"](
        p_j["attn"], jnp.asarray(x), jnp.asarray(pos))
    y_t, (c_t, kpe_t) = attention.mla_forward(
        blk.attn, torch.from_numpy(x), cfg_t, PLAN, torch.from_numpy(pos))
    assert y_t.shape == (2, S, cfg_t.d_model)
    assert c_t.shape == (2, S, cfg_t.kv_lora_rank)
    assert kpe_t.shape == (2, S, cfg_t.qk_rope_head_dim)
    for got, want in ((y_t, y_j), (c_t, c_j), (kpe_t, kpe_j)):
        assert_allclose(_np(got), _np(want), **F32)


def test_mla_decode_matches_jax(env):
    """One absorbed decode step over random latent caches at three
    positions: the output and both caches (the new token written in
    place) agree."""
    cfg_j, cfg_t = env["cfg_j"], env["cfg_t"]
    p_j, blk = _layer(env, 1)
    rng = np.random.default_rng(7)
    B, L = 3, 20
    x = _hidden(cfg_t, B, 1, seed=8)
    c = rng.normal(size=(B, L, cfg_t.kv_lora_rank)).astype(np.float32)
    kpe = rng.normal(size=(B, L, cfg_t.qk_rope_head_dim)).astype(np.float32)
    pos = np.asarray([0, 9, L - 1], np.int32)
    y_j, c_j, kpe_j = env["jit"]["mla_decode"](
        p_j["attn"], jnp.asarray(x), jnp.asarray(c), jnp.asarray(kpe),
        jnp.asarray(pos))
    c_t, kpe_t = torch.from_numpy(c.copy()), torch.from_numpy(kpe.copy())
    y_t = attention.mla_decode(blk.attn, torch.from_numpy(x), c_t, kpe_t,
                               torch.from_numpy(pos), cfg_t, PLAN)
    assert y_t.shape == (B, 1, cfg_t.d_model)
    for got, want in ((y_t, y_j), (c_t, c_j), (kpe_t, kpe_j)):
        assert_allclose(_np(got), _np(want), **F32)


def test_mla_prefill_then_decode_equals_the_longer_prefill(env):
    """The absorbed decode of token S from a prefill's latent cache equals
    the materialised prefill over S + 1 tokens at its last position."""
    cfg_t = env["cfg_t"]
    _, blk = _layer(env, 1)
    S = 12
    x = torch.from_numpy(_hidden(cfg_t, 2, S + 1, seed=31))
    _, (c, kpe) = attention.mla_forward(blk.attn, x[:, :S], cfg_t, PLAN,
                                        torch.arange(S))
    cache_c = torch.zeros((2, 16, cfg_t.kv_lora_rank))
    cache_kpe = torch.zeros((2, 16, cfg_t.qk_rope_head_dim))
    cache_c[:, :S], cache_kpe[:, :S] = c, kpe
    y = attention.mla_decode(blk.attn, x[:, S:], cache_c, cache_kpe,
                             torch.full((2,), S, dtype=torch.int32), cfg_t,
                             PLAN)
    full, _ = attention.mla_forward(blk.attn, x, cfg_t, PLAN,
                                    torch.arange(S + 1))
    assert_allclose(_np(y[:, 0]), _np(full[:, S]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("causal,Sq,Sk", [(True, 40, 40), (False, 24, 40),
                                          (True, 9, 33)])
def test_plain_attention_at_mla_head_dims_matches_pallas(causal, Sq, Sk):
    """The plain version at the reduced config's (D, Dv) = (96, 64), against
    the Pallas kernel in interpret mode (causal with a q offset where Sq <
    Sk), float32."""
    rng = np.random.default_rng(Sq + Sk)
    q = rng.normal(size=(2, Sq, 4, 96)).astype(np.float32)
    k = rng.normal(size=(2, Sk, 4, 96)).astype(np.float32)
    v = rng.normal(size=(2, Sk, 4, 64)).astype(np.float32)
    kw = dict(causal=causal, q_offset=Sk - Sq if causal else 0)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), block_q=16, block_k=16,
                                  interpret=True, **kw)
    got = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), block_q=16,
                              block_k=16, **kw)
    assert got.shape == (2, Sq, 4, 64)
    assert_allclose(_np(got), _np(want), **F32)
    got = fa_kernel.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    assert_allclose(_np(got), _np(want), **F32)
    assert fa_kernel.launches == 0


@pytest.mark.parametrize("dtype,D,Dv", [
    (torch.bfloat16, 192, 128), (torch.bfloat16, 128, 128),
    (torch.float32, 96, 64), (torch.float32, 192, 128)])
def test_head_dim_pairs_the_kernel_takes(dtype, D, Dv):
    fa_kernel.check_head_dims(dtype, D, Dv)


@pytest.mark.parametrize("dtype,D,Dv", [
    (torch.bfloat16, 96, 64), (torch.bfloat16, 192, 192),
    (torch.float32, 192, 64), (torch.float16, 128, 128)])
def test_head_dim_pairs_the_kernel_refuses(dtype, D, Dv):
    with pytest.raises(ValueError, match="head dims"):
        fa_kernel.check_head_dims(dtype, D, Dv)


def test_backward_refuses_mla_head_dims():
    """The backward takes MLA's pairs, (192, 128) in both dtypes and the
    reduced config's (96, 64) in float32, and refuses an MLA pair outside
    ``BWD_HEAD_DIMS`` ((96, 64) in bf16, (192, 192)), on a tensor off the
    CPU before any device work."""
    for dtype, D, Dv in ((torch.bfloat16, 192, 128), (torch.float32, 192, 128),
                         (torch.float32, 96, 64)):
        fa_kernel.check_head_dims(dtype, D, Dv, backward=True)
    for dtype, D, Dv in ((torch.bfloat16, 96, 64), (torch.bfloat16, 192, 192),
                         (torch.float32, 192, 64)):
        with pytest.raises(ValueError, match="backward: head dims"):
            fa_kernel.check_head_dims(dtype, D, Dv, backward=True)
        q = torch.empty((1, 8, 2, D), device="meta", dtype=dtype,
                        requires_grad=True)
        v = torch.empty((1, 8, 2, Dv), device="meta", dtype=dtype,
                        requires_grad=True)
        with pytest.raises(ValueError, match="backward: head dims"):
            fa_kernel.flash_attention(q, q, v)
    # a pair the backward takes passes its check and reaches the card's
    # input checks, which a tensor off the card fails before any launch
    q = torch.empty((1, 8, 2, 192), device="meta", requires_grad=True)
    v = torch.empty((1, 8, 2, 128), device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="card"):
        fa_kernel.flash_attention(q, q, v)
    assert fa_kernel.launches == 0


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_tol(want):
    """float32 at the output's scale: the reference's init draws the expert
    stacks at std 1 / sqrt(E) (its ``dense_init`` fans in over axis 0), 0.5
    at the reduced E = 4, so the outputs reach about 10^3 and entries near
    0 are sums that cancel; ``atol`` is 2e-6 of the largest output (the
    packages differ by up to 7.4e-7 of it), ``rtol`` 2e-4 as elsewhere."""
    return dict(rtol=2e-4, atol=2e-6 * float(np.abs(np.asarray(want)).max()))


def _moe_input(cfg, seed, dup: bool):
    x = _hidden(cfg, 2, 9, seed)
    if dup:          # repeated tokens: equal affinities, ties broken by index
        x[0, 3] = x[0, 0]
        x[1, 5] = x[0, 0]
        x[1, 1] = x[0, 7]
    return x


@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "duplicated"])
@pytest.mark.parametrize("factor", [8.0, 1.0])
def test_moe_forward_matches_jax(env, factor, dup):
    """At the reduced config's capacity factor 8 no token is dropped; at 1.0
    (cap = ceil(18 * 2 / 4) = 9 of 18 tokens an expert) tokens past an
    expert's capacity are, and which ones must match: the output, the
    load-balance loss, and the same drops."""
    cfg_j = dataclasses.replace(env["cfg_j"], capacity_factor=factor)
    cfg_t = dataclasses.replace(env["cfg_t"], capacity_factor=factor)
    p_j, blk = _layer(env, 1)
    x = _moe_input(cfg_t, 40 + int(factor), dup)
    y_j, aux_j = env["jit"]["moe", factor](p_j["moe"], jnp.asarray(x))
    y_t, aux_t = mlp.moe_forward(blk.moe, torch.from_numpy(x), cfg_t)
    assert y_t.shape == x.shape and aux_t.dtype == torch.float32
    assert_allclose(_np(y_t), _np(y_j), **_moe_tol(y_j))
    assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    if dup:
        t = torch.from_numpy(x).reshape(18, -1)
        logits = t @ blk.moe.router
        assert torch.equal(logits[3], logits[0])   # the ties are exact
    if factor == 1.0:
        assert mlp.moe_capacity(cfg_t, 18) == 9
        # some token lost an expert it was routed to: the output differs
        # from the same routing without capacity
        y_full, _ = mlp.moe_forward(
            blk.moe, torch.from_numpy(x),
            dataclasses.replace(cfg_t, capacity_factor=8.0))
        assert not torch.allclose(y_t, y_full)


def test_top_k_breaks_ties_as_jax():
    x = np.asarray([[0.5, 0.2, 0.5, 0.0, 0.2, 0.5],
                    [0.0, 0.0, 0.0, 0.0, 1.0, 0.0]], np.float32)
    for k in (1, 3, 5):
        vj, ij = jax.lax.top_k(jnp.asarray(x), k)
        vt, it = mlp.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_moe_capacity_at_full_width():
    """deepseek-v2-lite's capacity (factor 1.25): a decode group of 4 slots
    leaves one token an expert, a 512-token prefill 60."""
    cfg = get_config(ARCH)
    assert cfg.capacity_factor == 1.25
    assert mlp.moe_capacity(cfg, 4) == 1
    assert mlp.moe_capacity(cfg, 512) == 60


# ---------------------------------------------------------------------------
# params: conversion, init, caches
# ---------------------------------------------------------------------------

def test_leaf_order_is_the_jax_tree_flatten_order(env):
    paths = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
             for path, _ in
             jax.tree_util.tree_flatten_with_path(env["np_params"])[0]]
    assert [p for p, _ in jax_leaves(env["cfg_t"])] == paths


def test_params_to_jax_inverts_params_from_jax(env):
    tree = params_to_jax(env["state"], env["cfg_t"])
    flat_j = jax.tree_util.tree_flatten_with_path(env["np_params"])[0]
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (_, a), (_, b) in zip(flat_t, flat_j):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert {k for k in env["state"] if k.startswith("blocks.1.")} == {
        "blocks.1." + n for n in (
            "ln1", "ln2", "attn.wq", "attn.wkv_a", "attn.kv_norm",
            "attn.w_uk", "attn.w_uv", "attn.wo", "moe.router", "moe.w_gate",
            "moe.w_up", "moe.w_down", "moe.shared.w_gate", "moe.shared.w_up",
            "moe.shared.w_down")}


def test_port_init_is_seeded_shaped_as_jax_and_cast_by_block(env):
    """The seeded init: repeatable, the reference tree's shapes, and in a
    compute dtype exactly the cast of the float32 init (each block drawn in
    float32 and cast as it is built)."""
    cfg_t = env["cfg_t"]
    a = build_model(cfg_t, PLAN, seed=3, device="cpu")
    b = build_model(cfg_t, PLAN, seed=3, device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert {k: tuple(v.shape) for k, v in a.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in env["state"].items()}
    h = build_model(cfg_t, PLAN, seed=3, device="cpu", dtype=torch.bfloat16)
    for (na, pa), (_, ph) in zip(a.named_parameters(), h.named_parameters()):
        assert ph.dtype == torch.bfloat16, na
        assert torch.equal(ph, pa.to(torch.bfloat16)), na
    # the expert stacks' std: the reference's dense_init fans in over axis 0
    w = build_model(dataclasses.replace(cfg_t, num_experts=16), PLAN,
                    device="cpu").blocks[1].moe.w_gate
    assert abs(float(w.std()) - 0.25) < 0.01


def test_mla_caches_and_their_specs(env):
    cfg_t = env["cfg_t"]
    caches = make_decode_caches(cfg_t, PLAN, 2, CACHE_LEN)
    for c in caches:
        assert set(c) == {"c", "kpe"}
        assert c["c"].shape == (2, CACHE_LEN, cfg_t.kv_lora_rank)
        assert c["kpe"].shape == (2, CACHE_LEN, cfg_t.qk_rope_head_dim)
        assert c["c"].dtype == torch.float32
    with torch.device("meta"):
        full = make_decode_caches(get_config(ARCH), PLAN, 4, 569,
                                  layers=[0])[0]
    assert full["c"].shape == (4, 569, 512) and full["kpe"].shape == (
        4, 569, 64)
    assert full["c"].dtype == torch.bfloat16
    # the batch over data, replicated over model (reference :122-124)
    spec = cache_specs(cfg_t, MeshPlan(("data", "model"), (2, 2)),
                       ("data",))[1]
    assert spec == {"c": ndsbp("S(0),B"), "kpe": ndsbp("S(0),B")}


def test_describe_counts_deepseek_units():
    """Full-width deepseek-v2-lite on the meta device (shapes only): the
    reference tree's parameter count, 27 units, 14 and 13 a stage."""
    cfg = get_config(ARCH)
    with torch.device("meta"):
        model = Transformer(cfg, PLAN, dtype=torch.bfloat16)
    # the reference tree's leaves hold as many (jax.eval_shape of its init);
    # cfg.param_count() says 15,706,468,352, leaving out kv_norm and the
    # final norm
    assert sum(p.numel() for p in model.parameters()) == 15_706_484_224
    prog = lower_serve_stages(cfg, model, num_stages=2, cache_len=569,
                              max_prompt_len=512, group_size=4)
    rep = prog.describe()
    assert "over 27 stack units (1 attn/dense, 26 attn/moe layers)" in rep
    assert "stage 0: units [0, 14)" in rep and "stage 1: units [14, 27)" in rep


def test_stages_share_a_compute_dtype_model(env):
    """A model built in its compute dtype is held once: the stages' weights
    are its tensors, not copies (31 GB of bf16 fits the card once)."""
    cfg = dataclasses.replace(env["cfg_t"], dtype="bfloat16")
    model = build_model(cfg, PLAN, device="cpu", dtype=torch.bfloat16)
    held = {p.untyped_storage().data_ptr() for p in model.parameters()}
    prog = lower_serve_stages(cfg, model, num_stages=2, cache_len=CACHE_LEN,
                              max_prompt_len=8, group_size=2)
    n = 0
    for st in prog.stages:
        for p in st.params.parameters():
            assert p.dtype == torch.bfloat16
            assert p.untyped_storage().data_ptr() in held
            n += 1
    assert n == len(held)


# ---------------------------------------------------------------------------
# serve stages
# ---------------------------------------------------------------------------

def _jax_layer_caches(tree):
    out = [dict(c) for c in tree["prologue"]]
    for slot in tree["body"]:
        for i in range(np.shape(slot["c"])[0]):
            out.append({k: np.asarray(v)[i] for k, v in slot.items()})
    return out


@pytest.mark.parametrize("num_stages", [1, 2])
def test_prefill_and_decode_stages_match_jax(env, num_stages):
    """Two prompts prefilled into a group's slots, then three decode steps:
    logits and every MLA cache leaf agree (the prefill's c and kpe rounded
    to bf16 in both, the decode's written in float32)."""
    js = jax_lower(env["cfg_j"], env["mesh"], env["params"],
                   num_stages=num_stages, cache_len=CACHE_LEN,
                   max_prompt_len=8, group_size=2)
    ts = lower_serve_stages(env["cfg_t"], env["model"],
                            num_stages=num_stages, cache_len=CACHE_LEN,
                            max_prompt_len=8, group_size=2)
    jc = [s.init_caches(jnp.zeros((2,), jnp.int32)) for s in js.stages]
    with torch.inference_mode():
        tc = [s.init_caches(2) for s in ts.stages]
    tok = []
    for b, toks in enumerate(env["prompts"][:2]):
        S = toks.size
        xj, xt = jnp.asarray(toks[None]), torch.from_numpy(toks[None])
        for s, (sj, st) in enumerate(zip(js.stages, ts.stages)):
            xj, cj = sj.prefill(sj.params, xj,
                                jnp.full((1,), S - 1, jnp.int32))
            with torch.inference_mode():
                xt, ct = st.prefill(st.params, xt, S - 1)
            jc[s] = sj.write_slot(jc[s], cj, b)
            with torch.inference_mode():
                st.write_slot(tc[s], ct, b)
        assert_allclose(_np(xt), _np(xj), **F32)
        tok.append(int(np.argmax(np.asarray(xj)[0, :1000])))
    pos = np.asarray([p.size for p in env["prompts"][:2]], np.int32)
    for step in range(3):
        xj = jnp.asarray(tok, jnp.int32)
        xt = torch.tensor(tok, dtype=torch.int32)
        for s, (sj, st) in enumerate(zip(js.stages, ts.stages)):
            xj, jc[s] = sj.decode(sj.params, jc[s], xj, jnp.asarray(pos))
            with torch.inference_mode():
                xt, _ = st.decode(st.params, tc[s], xt,
                                  torch.from_numpy(pos.copy()))
        assert_allclose(_np(xt), _np(xj), **F32)
        tok = [int(t) for t in np.argmax(np.asarray(xj)[:, :1000], axis=-1)]
        pos = pos + 1
    for sj, st in zip(jc, tc):
        for cj, ct in zip(_jax_layer_caches(sj), st):
            for key in ("c", "kpe"):
                assert_allclose(_np(ct[key]), _np(cj[key]), **F32)


# ---------------------------------------------------------------------------
# serving, token for token
# ---------------------------------------------------------------------------

SESSIONS = [("actors", "dense"), ("monolithic", "dense"),
            ("actors", "paged"), ("monolithic", "paged")]


@pytest.fixture(scope="module")
def served(env):
    reqs = list(zip(env["prompts"], GENS))
    fa_kernel.launches = 0
    fd_kernel.reset_counts()
    out = {}
    for backend, cache in SESSIONS:
        kw = dict(stages=2) if backend == "actors" else {}
        if cache == "paged":
            kw.update(PAGED)
        for pkg, sess in (
                ("jax", lambda: jax_api.compile(
                    env["cfg_j"], mode="serve", backend=backend,
                    params=env["params"], mesh=env["mesh"], **kw,
                    **GEOMETRY)),
                ("port", lambda: api.compile(
                    env["cfg_t"], mode="serve", backend=backend,
                    params=env["state"], device="cpu", **kw, **GEOMETRY))):
            s = sess()
            out[(pkg, backend, cache)] = (s.generate(reqs),
                                          dict(s.last_stats))
            s.close()
    return out, fa_kernel.launches + fd_kernel.launches


@pytest.mark.parametrize("backend,cache", SESSIONS)
def test_port_matches_jax_token_for_token(served, backend, cache):
    want, _ = served[0][("jax", backend, cache)]
    got, stats = served[0][("port", backend, cache)]
    assert [len(o) for o in got] == GENS
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), f"request {i}: port {g} != jax {w}"
    assert stats["admitted_mid_flight"] >= 1
    assert all((o >= 0).all() and (o < 1000).all() for o in got)


def test_port_backends_and_caches_agree(served):
    base, sb = served[0][("port", "monolithic", "dense")]
    for backend, cache in SESSIONS:
        got, st = served[0][("port", backend, cache)]
        assert all(np.array_equal(x, y) for x, y in zip(got, base))
        assert st["prefill_items"] == len(GENS)
    assert served[0][("port", "monolithic", "paged")][1]["shared_pages"] == 0


def test_cpu_serving_launches_no_kernel(served):
    assert served[1] == 0


def test_tokens_match_jax_with_expert_drops(env):
    """Capacity factor 1.0: a decode group of 2 slots gives an expert 1
    token (cap = ceil(2 * 2 / 4)), so the slots compete for experts and
    tokens are dropped; the port's choice of which matches the
    reference's, token for token. A parked slot's token competes too, and
    what it reads decides which live token it displaces: the reference's
    paged session reads zeros for it, its dense session the slot's stale
    cache, and the two disagree (request 1 from its fourth token). The
    port's dense and paged caches both keep parked rows inert
    (``core/lowering.py:parked_rows_matter``), so the port is held to
    the reference's paged session."""
    cfg_j = dataclasses.replace(env["cfg_j"], capacity_factor=1.0)
    cfg_t = dataclasses.replace(env["cfg_t"], capacity_factor=1.0)
    reqs = list(zip(env["prompts"], GENS))
    sj = jax_api.compile(cfg_j, mode="serve", backend="monolithic",
                         params=env["params"], mesh=env["mesh"], **PAGED,
                         **GEOMETRY)
    st = api.compile(cfg_t, mode="serve", backend="monolithic",
                     params=env["state"], device="cpu", **GEOMETRY)
    want, got = sj.generate(reqs), st.generate(reqs)
    sj.close()
    st.close()
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# what still raises
# ---------------------------------------------------------------------------

def test_mla_and_moe_on_a_mesh_raise(env):
    """MLA and MoE serve on a mesh whose model axis splits the heads and
    the experts (``tests/test_torch_deepseek_mesh.py`` holds them to the
    JAX sessions); a model axis that splits neither raises naming the
    heads, one that splits the heads but not the experts names the
    experts, both before a model is built."""
    mesh = Placement(("data", "model"), (1, 2))
    with api.compile(env["cfg_t"], mode="serve", params=env["state"],
                     device="cpu", mesh=mesh, **GEOMETRY) as sess:
        assert "tp=2 (heads, experts, vocab, latent cache replicated)" in \
            sess.describe()
    with pytest.raises(ValueError, match="4 MLA heads do not split over "
                                         "tp = 8"):
        api.compile(env["cfg_t"], mode="serve", params=env["state"],
                    device="cpu", mesh=Placement(("data", "model"), (1, 8)),
                    **GEOMETRY)
    wide = dataclasses.replace(env["cfg_t"], num_heads=8)
    with pytest.raises(ValueError, match="4 experts do not split over "
                                         "tp = 8"):
        api.compile(wide, mode="serve", device="cpu",
                    mesh=Placement(("data", "model"), (1, 8)), **GEOMETRY)


def test_training_mla_and_moe_raises(env):
    """Training MLA + MoE runs on one device
    (``tests/test_torch_deepseek_train.py`` holds it to the JAX package)
    and on meshes (``tests/test_torch_deepseek_mesh_train.py``); on a
    model axis that does not split its 4 heads it raises naming them,
    plain and ZeRO. A frontend arch's step builds on a mesh, a pure data
    mesh too (``tests/test_torch_frontend_mesh_train.py`` holds it to the
    JAX package)."""
    loss, metrics = loss_fn(env["model"],
                            {"tokens": np.zeros((1, 9), np.int32)})
    assert torch.isfinite(loss) and float(metrics["aux_loss"]) > 0
    for zero in (True, False):
        with pytest.raises(ValueError, match="4 MLA heads do not split"):
            make_train_step(env["cfg_t"], MeshPlan(("data", "model"),
                                                   (1, 8)),
                            zero=zero, device="cpu")
    for arch in ("whisper-medium", "pixtral-12b"):
        for shape in ((1, 2), (2, 1)):
            ts = make_train_step(get_config(arch).reduced(),
                                 MeshPlan(("data", "model"), shape),
                                 device="cpu")
            assert ts.zero and ts.mesh.shape == shape


@pytest.mark.parametrize("arch,what", [("jamba-v0.1-52b", "ssm/moe"),
                                       ("deepseek-v3-671b", "MTP")])
def test_hybrids_and_mtp_still_raise(arch, what):
    """A hybrid's ssm/moe layers are built and served
    (``tests/test_torch_jamba.py``); training them raises, naming the
    kind and item 13. MTP, which raised here until the port built it, is
    built now: deepseek-v3 passes the check, and its reduced model's loss
    reports ``mtp_loss`` (``tests/test_torch_deepseek_v3.py`` holds it to
    the JAX package)."""
    check_supported(get_config(ARCH))
    cfg = get_config(arch)
    if cfg.mtp:
        check_supported(cfg)
        small = dataclasses.replace(cfg.reduced(), vocab_size=1000)
        model = build_model(small, PLAN, device="cpu")
        loss, metrics = loss_fn(model, {"tokens": np.zeros((1, 9),
                                                           np.int32)})
        assert set(metrics) == {"lm_loss", "aux_loss", "mtp_loss", "loss"}
        assert torch.isfinite(loss) and float(metrics[what.lower() +
                                                     "_loss"]) > 0
        return
    check_supported(cfg)
    with pytest.raises(NotImplementedError,
                       match=f"{what}.*Queue 1 item 13"):
        make_train_step(cfg, device="cpu")


def test_launcher_serves_deepseek_on_cpu(capsys):
    outs = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "3", "--prompt-len", "6",
                              "--gen", "4"])
    assert [len(o) for o in outs] == [4, 3, 4]
    assert "serve ok" in capsys.readouterr().out


def test_launcher_serves_deepseek_v3_on_cpu(capsys):
    """deepseek-v3-671b's reduced config (MLA with a q LoRA, MoE, and the
    MTP module the serve path leaves unread) through the serve launcher."""
    outs = launch_serve.main(["--arch", "deepseek-v3-671b", "--smoke",
                              "--device", "cpu", "--requests", "3",
                              "--prompt-len", "6", "--gen", "4"])
    assert [len(o) for o in outs] == [4, 3, 4]
    assert "serve ok" in capsys.readouterr().out


def test_launcher_trains_deepseek_v3_on_cpu(capsys):
    """The train launcher on reduced deepseek-v3-671b: the loss with its
    MTP term falls over three steps."""
    from repro_torch.launch import train as launch_train
    launch_train.main(["--arch", "deepseek-v3-671b", "--smoke", "--device",
                       "cpu", "--steps", "3", "--batch", "2", "--seq", "32"])
    assert "(improved)" in capsys.readouterr().out
