"""The port's hybrid slice (jamba: Mamba-2 layers with an MLP or an MoE
after the mixer, one attention layer in a period) against the JAX
package's.

Two configs, made the same way in both packages, with ``vocab_size=1000``
(padded to 1024 logit columns), float32: ``jamba-v0.1-52b.reduced()`` (2
layers: ``ssm/dense``, then ``attn/moe``; d_model 256, 16 SSM heads of head
dim 32, d_state 16, chunk 32, 4 experts top-2 of 256 units, capacity factor
8) and the same with ``num_layers=8, attn_every=4, attn_offset=2``, whose
period ``ssm/dense, ssm/moe, attn/dense, ssm/moe`` holds the full model's
three kinds and whose 2 periods give 2 stages. The JAX params are built
with ``jax.random`` and carried into the port by ``params_from_jax``; the
same numpy-seeded inputs go through both packages, and the JAX side of
each comparison runs once per module.

Tolerances: float32 ``rtol=2e-4, atol=2e-5`` on outputs and conv tails,
``1e-4`` on the float32 SSD state (the mamba tests'), one bf16 ulp on the
attention caches the prefill rounds to bf16; an MoE block's output, and
the logits of a stack with MoE layers, at their own scale (the deepseek
tests': the reference draws its expert stacks at std ``1 / sqrt(E)``, so
the residual stream reaches about 10^3). Serving must be token-identical
to the JAX paged ``ServeSession`` on actors and monolithic, dense and
paged (pages recycled), chunked prefill equal to unchunked, and at the
full model's capacity factor 1.25, where tokens past an expert's capacity
drop. The JAX package's dense serving advances a slot admitted into a
group with live slots by the group's parked decode in its admission round
(its SSM state is not positional, so the dummy token's step lands on it);
its paged serving reads zeros for parked rows and drops their writes. The
port's dense cache keeps parked rows inert in the same way for a stack
with SSM or MoE layers, so its dense and paged sessions agree, with each
other and with the JAX paged session.
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
from repro.models import transformer as jax_T  # noqa: E402
from repro.models.model_zoo import build_model as jax_build  # noqa: E402
from repro.train.steps import plan_from_mesh  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.lowering import lower_serve_stages  # noqa: E402
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.core.sbp import ndsbp  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_decode import kernel as fd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import MeshPlan  # noqa: E402
from repro_torch.models.convert import (jax_leaves,  # noqa: E402
                                        params_from_jax, params_to_jax)
from repro_torch.models.model_zoo import (build_model,  # noqa: E402
                                          cache_specs, loss_fn,
                                          make_decode_caches)
from repro_torch.train.steps import make_train_step  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ARCH = "jamba-v0.1-52b"
F32 = dict(rtol=2e-4, atol=2e-5)
STATE = dict(rtol=1e-4, atol=1e-4)
#: the attention caches, which the prefill rounds to bf16 (the reference's
#: prefill cache dtype): float32 inputs that differ in their last bits may
#: round to neighbouring bf16 values, one ulp (2^-7 relative at most) apart
BF16 = dict(rtol=2.0 ** -7, atol=2e-5)
CACHE_LEN = 24
PLAN = MeshPlan.single_device()
# unequal, 3 = ssm_d_conv - 1; two lengths, as each is a JAX compile
PROMPT_LENS = [8, 3, 8, 8, 3]
GENS = [3, 6, 2, 5, 4]
GEOMETRY = dict(num_groups=2, group_size=2, max_prompt_len=max(PROMPT_LENS),
                max_new_tokens=max(GENS), cache_len=CACHE_LEN)
PAGED = dict(cache="paged", page_len=4, num_pages=12)
#: the two test configs: the reduced one, and an 8-layer cut with the full
#: model's three kinds in a period and two periods
CONFIGS = {"reduced": {},
           "period4": dict(num_layers=8, attn_every=4, attn_offset=2)}
KINDS = {"reduced": [("ssm", "dense"), ("attn", "moe")],
         "period4": [("ssm", "dense"), ("ssm", "moe"), ("attn", "dense"),
                     ("ssm", "moe")] * 2}
#: (backend, cache) of the port's sessions, each held to the JAX session
SESSIONS = [("actors", "dense"), ("monolithic", "dense"),
            ("actors", "paged"), ("monolithic", "paged")]


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


def _configs(name, **extra):
    kw = dict(vocab_size=1000, **CONFIGS[name], **extra)
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _stages(name):
    """The actors' stage count: one a stack unit (a period)."""
    return 2 if name == "period4" else 1


@pytest.fixture(scope="module")
def env():
    mesh = _mesh()
    plan_j = plan_from_mesh(mesh)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 1000, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    out = dict(mesh=mesh, plan_j=plan_j, prompts=prompts,
               reqs=list(zip(prompts, GENS)))
    for name in CONFIGS:
        cfg_j, cfg_t = _configs(name)
        params = jax_build(cfg_j, plan_j).init(jax.random.PRNGKey(0))
        np_params = jax.device_get(params)
        state = params_from_jax(np_params, cfg_t)
        with torch.device("meta"):
            model = T.Transformer(cfg_t, PLAN)
        model.load_state_dict(state, assign=True)
        out[name] = dict(cfg_j=cfg_j, cfg_t=cfg_t, params=params,
                         np_params=np_params, state=state, model=model)
    return out


def _layer_tree(np_params, cfg, i):
    """Layer i's params in the JAX tree (numpy): ``body[j][leaf][period]``."""
    P = len(T.stack_layout(cfg).period_slots)
    return jax.tree.map(lambda a: np.asarray(a)[i // P],
                        np_params["body"][i % P])


def _jax_layer_caches(tree):
    """A JAX cache tree's caches, one dict per layer, in layer order."""
    out = [dict(c) for c in tree["prologue"]]
    n = np.shape(next(iter(tree["body"][0].values())))[0]
    for i in range(n):
        for slot in tree["body"]:
            out.append({k: np.asarray(v)[i] for k, v in slot.items()})
    return out


def _moe_tol(want):
    """float32 at the output's scale: the reference's expert stacks are
    drawn at std 1 / sqrt(E), so an MoE block's outputs reach about 10^3;
    ``atol`` is 2e-6 of the largest, as the deepseek tests hold them."""
    return dict(rtol=2e-4, atol=2e-6 * float(np.abs(np.asarray(want)).max()))


def _scaled(want):
    """float32 at the output's scale: ``atol`` 2e-5 of the largest entry
    (at least 2e-5), for the hiddens and logits of a stack with MoE
    layers."""
    return dict(rtol=2e-4, atol=2e-5 * max(
        1.0, float(np.abs(np.asarray(want)).max())))


def _hold_caches(got, want, what):
    for key, w in want.items():
        tol = {"h": STATE, "k": BF16, "v": BF16}.get(key, F32)
        assert_allclose(_np(got[key]), _np(w), err_msg=f"{what} {key}", **tol)


# ---------------------------------------------------------------------------
# the config and the boundary
# ---------------------------------------------------------------------------

def test_config_equals_the_reference_field_for_field():
    a, b = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced())
    assert a.param_count() == b.param_count() == 51_459_529_728
    for name, kinds in KINDS.items():
        _, cfg = _configs(name)
        assert T.stack_layout(cfg).layer_kinds() == kinds


def test_full_model_kinds_and_units():
    """jamba's period of 8 (attention at offset 4, MoE on every second
    layer), 4 units; 16 layers are 2 units, 2 stages; on the meta device
    the modules hold what the config counts (no biases or extra norms)."""
    cfg = get_config(ARCH)
    assert T.stack_layout(cfg).period_slots == (
        ("ssm", "dense"), ("ssm", "moe"), ("ssm", "dense"), ("ssm", "moe"),
        ("attn", "dense"), ("ssm", "moe"), ("ssm", "dense"), ("ssm", "moe"))
    assert len(T.stage_units(cfg)) == 4
    cut = dataclasses.replace(cfg, num_layers=16)
    with torch.device("meta"):
        model = T.Transformer(cut, PLAN, dtype=torch.bfloat16)
    # cfg.param_count() leaves out the norms and the SSM's per-head
    # vectors; the modules hold the reference tree's leaves
    assert cut.param_count() == 25_998_200_320
    assert sum(p.numel() for p in model.parameters()) == 25_998_322_688
    prog = lower_serve_stages(cut, model, num_stages=2, cache_len=569,
                              max_prompt_len=512, group_size=4)
    rep = prog.describe()
    assert "stage 0: units [0, 1)" in rep and "stage 1: units [1, 2)" in rep
    blk = model.blocks[1]
    assert {n for n, _ in blk.named_parameters()} >= {
        "ln1", "ln2", "ssm.w_x", "moe.router", "moe.w_gate"}


# ---------------------------------------------------------------------------
# the hybrid blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layer,kind", [(0, "ssm/dense"), (1, "ssm/moe")])
def test_hybrid_block_prefill_and_decode_match_jax(env, layer, kind):
    """An SSM block with its MLP branch: the prefill's output, router loss
    and caches, then two decode steps from those caches, against the JAX
    ``apply_block`` and ``decode_block``."""
    e = env["period4"]
    cfg_j, cfg_t = e["cfg_j"], e["cfg_t"]
    k, m = kind.split("/")
    assert T.stack_layout(cfg_t).layer_kinds()[layer] == (k, m)
    p_j = _layer_tree(e["np_params"], cfg_t, layer)
    blk = e["model"].blocks[layer]
    rng = np.random.default_rng(layer)
    S = 45                                       # one chunk and a ragged one
    x = rng.normal(size=(2, S + 2, cfg_t.d_model)).astype(np.float32)
    pos = np.arange(S)
    plan_j = env["plan_j"]
    prefill_j = jax.jit(lambda p, v, ps: jax_T.apply_block(
        p, v, cfg_j, plan_j, k, m, ps, want_cache=True, cache_len=CACHE_LEN))
    decode_j = jax.jit(lambda p, v, c, ps: jax_T.decode_block(
        p, v, c, ps, cfg_j, plan_j, k, m))
    y_j, aux_j, c_j = prefill_j(p_j, jnp.asarray(x[:, :S]), jnp.asarray(pos))
    with torch.no_grad():
        y_t, aux_t, c_t = T.apply_block(
            blk, torch.from_numpy(x[:, :S]), cfg_t, PLAN, k, m,
            torch.from_numpy(pos), want_cache=True, cache_len=CACHE_LEN)
    tol = _moe_tol(y_j) if m == "moe" else F32
    assert_allclose(_np(y_t), _np(y_j), **tol)
    if m == "moe":
        assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    else:
        assert aux_t is None and float(aux_j) == 0.0
    assert set(c_t) == {"h", "tail_x", "tail_bc"} == set(c_j)
    _hold_caches(c_t, c_j, f"prefill {kind}")
    for t in range(2):
        xt = x[:, S + t:S + t + 1]
        p = np.full((2,), S + t, np.int32)
        y_j, c_j = decode_j(p_j, jnp.asarray(xt), c_j, jnp.asarray(p))
        with torch.no_grad():
            y_t, c_t = T.decode_block(blk, torch.from_numpy(xt), c_t,
                                      torch.from_numpy(p), cfg_t, PLAN, k, m)
        assert_allclose(_np(y_t), _np(y_j),
                        **(_moe_tol(y_j) if m == "moe" else F32))
        _hold_caches(c_t, c_j, f"decode step {t} {kind}")


# ---------------------------------------------------------------------------
# params: conversion, init, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_leaf_order_is_the_jax_tree_flatten_order(env, name):
    e = env[name]
    paths = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
             for path, _ in
             jax.tree_util.tree_flatten_with_path(e["np_params"])[0]]
    assert [p for p, _ in jax_leaves(e["cfg_t"])] == paths


@pytest.mark.parametrize("name", list(CONFIGS))
def test_params_to_jax_inverts_params_from_jax(env, name):
    e = env[name]
    tree = params_to_jax(e["state"], e["cfg_t"])
    flat_j = jax.tree_util.tree_flatten_with_path(e["np_params"])[0]
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (_, a), (_, b) in zip(flat_t, flat_j):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert {k[len("blocks.0."):] for k in e["state"]
            if k.startswith("blocks.0.")} == {
        "ln1", "ln2", "mlp.w_gate", "mlp.w_up", "mlp.w_down", *(
            "ssm." + n for n in ("w_x", "w_z", "w_bc", "w_dt", "dt_bias",
                                 "A_log", "D", "conv_x", "conv_bc",
                                 "norm_w", "out_proj"))}


def test_port_init_is_seeded_shaped_as_jax_and_cast_by_block(env):
    """The seeded init: repeatable, the reference tree's shapes, and in
    bf16 exactly the cast of the float32 init but for the SSM leaves the
    model reads in float32 (``FLOAT32_PARAMS``), which stay float32."""
    e = env["period4"]
    cfg_t = e["cfg_t"]
    a = build_model(cfg_t, PLAN, seed=3, device="cpu")
    b = build_model(cfg_t, PLAN, seed=3, device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert {k: tuple(v.shape) for k, v in a.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in e["state"].items()}
    h = build_model(cfg_t, PLAN, seed=3, device="cpu", dtype=torch.bfloat16)
    kept = 0
    for (na, pa), (_, ph) in zip(a.named_parameters(), h.named_parameters()):
        if na.rsplit(".", 1)[-1] in T.FLOAT32_PARAMS:
            assert ph.dtype == torch.float32 and torch.equal(ph, pa), na
            kept += 1
        else:
            assert ph.dtype == torch.bfloat16, na
            assert torch.equal(ph, pa.to(torch.bfloat16)), na
    assert kept == 6 * len(T.FLOAT32_PARAMS)       # the 6 SSM layers'


def test_caches_and_their_specs_follow_each_layer_kind(env):
    """A stage's caches in a mixed stack: k/v for the attention layers,
    the SSD state and conv tails for the SSM layers (state float32); the
    specs by kind (reference ``model_zoo.py:108-140``)."""
    cfg_t = env["period4"]["cfg_t"]
    caches = make_decode_caches(cfg_t, PLAN, 2, CACHE_LEN)
    for c, (kind, _) in zip(caches, KINDS["period4"]):
        if kind == "attn":
            assert set(c) == {"k", "v"}
            assert c["k"].shape == (2, CACHE_LEN, cfg_t.num_kv_heads,
                                    cfg_t.head_dim)
        else:
            assert set(c) == {"h", "tail_x", "tail_bc"}
            assert c["h"].shape == (2, cfg_t.ssm_heads, cfg_t.ssm_head_dim,
                                    cfg_t.ssm_d_state)
    with torch.device("meta"):
        full = make_decode_caches(get_config(ARCH), PLAN, 4, 569,
                                  layers=[3, 4])
    assert full[0]["h"].shape == (4, 128, 64, 16)
    assert full[0]["h"].dtype == torch.float32
    assert full[0]["tail_bc"].dtype == torch.bfloat16
    assert full[1]["k"].shape == (4, 569, 8, 128)
    specs = cache_specs(cfg_t, MeshPlan(("data", "model"), (2, 2)),
                        ("data",))
    assert specs[2] == {"k": ndsbp("S(0),S(1)"), "v": ndsbp("S(0),S(1)")}
    assert specs[1] == {"h": ndsbp("S(0),S(1)"), "tail_x": ndsbp("S(0),S(2)"),
                        "tail_bc": ndsbp("S(0),B")}


def test_block_specs_add_the_mlp_to_an_ssm_block():
    cfg = get_config(ARCH)
    plan = MeshPlan(("data", "model"), (1, 2))
    ssm = T.block_specs(cfg, plan, ("ssm", "none"))
    for mlp_kind, extra in (("dense", {"mlp.w_gate", "mlp.w_up",
                                       "mlp.w_down"}),
                            ("moe", {"moe.router", "moe.w_gate", "moe.w_up",
                                     "moe.w_down"})):
        got = T.block_specs(cfg, plan, ("ssm", mlp_kind))
        assert set(got) == set(ssm) | {"ln2"} | extra
        assert {n: got[n] for n in ssm} == ssm
        with torch.device("meta"):
            blk = T.Block(cfg, PLAN, kind=("ssm", mlp_kind))
        assert set(got) == {n for n, _ in blk.named_parameters()}


# ---------------------------------------------------------------------------
# the whole model and the serve stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_whole_model_prefill_and_decode_match_jax(env, name):
    """The reference bundle's prefill of two prompts, then two decode
    steps, against :func:`transformer.prefill` and :func:`decode_step`:
    the last hidden, the logits and every cache leaf. Each decode step
    starts from the JAX side's caches: the prefill's k/v are rounded to
    bf16, and one element a rounding boundary apart moves the next logits
    by ~5e-5, which would hide the step's own error (4e-6)."""
    e = env[name]
    bundle = jax_build(e["cfg_j"], env["plan_j"])
    toks = np.stack([env["prompts"][0], env["prompts"][2]])
    h_j, c_j = bundle.prefill(e["params"], {"tokens": jnp.asarray(toks)},
                              CACHE_LEN)
    h_t, c_t = T.prefill(e["model"], {"tokens": toks}, CACHE_LEN)
    assert_allclose(_np(h_t), _np(h_j), **_scaled(h_j))
    for i, (got, want) in enumerate(zip(c_t, _jax_layer_caches(c_j))):
        _hold_caches(got, want, f"prefill layer {i}")
    tok = np.argmax(np.asarray(h_j[:, 0] @ e["params"]["unembed"]),
                    axis=-1).astype(np.int32)
    pos = np.full((2,), toks.shape[1], np.int32)
    for step in range(2):
        # copies: the port's decode writes its caches in place, and a numpy
        # view of a JAX array shares its buffer
        c_t = [{k: torch.from_numpy(_np(v).copy()).to(c_t[i][k].dtype)
                for k, v in layer.items()}
               for i, layer in enumerate(_jax_layer_caches(c_j))]
        lj, c_j = bundle.decode_step(e["params"], c_j, jnp.asarray(tok),
                                     jnp.asarray(pos))
        lt, c_t = T.decode_step(e["model"], c_t, tok, pos)
        assert_allclose(_np(lt), _np(lj), **_scaled(lj))
        for i, (got, want) in enumerate(zip(c_t, _jax_layer_caches(c_j))):
            _hold_caches(got, want, f"decode step {step} layer {i}")
        tok = np.argmax(np.asarray(lj)[:, :1000], axis=-1).astype(np.int32)
        pos = pos + 1


@pytest.mark.parametrize("name,num_stages", [("reduced", 1), ("period4", 1),
                                             ("period4", 2)])
def test_prefill_and_decode_stages_match_jax(env, name, num_stages):
    """Two prompts prefilled into a group's slots, then three decode steps
    through ``lower_serve_stages``: logits and every cache leaf of both
    kinds, which share a stage, against the JAX stages. The prompts have
    one length (one JAX prefill compile a stage)."""
    e = env[name]
    js = jax_lower(e["cfg_j"], env["mesh"], e["params"],
                   num_stages=num_stages, cache_len=CACHE_LEN,
                   max_prompt_len=8, group_size=2)
    ts = lower_serve_stages(e["cfg_t"], e["model"], num_stages=num_stages,
                            cache_len=CACHE_LEN, max_prompt_len=8,
                            group_size=2)
    jc = [s.init_caches(jnp.zeros((2,), jnp.int32)) for s in js.stages]
    with torch.inference_mode():
        tc = [s.init_caches(2) for s in ts.stages]
    tok = []
    prompts = [env["prompts"][0], env["prompts"][2][::-1].copy()]
    for b, toks in enumerate(prompts):
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
        assert_allclose(_np(xt), _np(xj), **_scaled(xj))
        tok.append(int(np.argmax(np.asarray(xj)[0, :1000])))
    pos = np.asarray([p.size for p in prompts], np.int32)
    for _ in range(3):
        xj = jnp.asarray(tok, jnp.int32)
        xt = torch.tensor(tok, dtype=torch.int32)
        for s, (sj, st) in enumerate(zip(js.stages, ts.stages)):
            xj, jc[s] = sj.decode(sj.params, jc[s], xj, jnp.asarray(pos))
            with torch.inference_mode():
                xt, _ = st.decode(st.params, tc[s], xt,
                                  torch.from_numpy(pos.copy()))
        assert_allclose(_np(xt), _np(xj), **_scaled(xj))
        tok = [int(t) for t in np.argmax(np.asarray(xj)[:, :1000], axis=-1)]
        pos = pos + 1
    kinds = []
    for sj, st in zip(jc, tc):
        for cj, ct in zip(_jax_layer_caches(sj), st):
            _hold_caches(ct, cj, "stage cache")
            kinds.append("k" in ct)
    assert kinds == [k == "attn" for k, _ in KINDS[name]]


# ---------------------------------------------------------------------------
# serving, token for token
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(env):
    """Each config's JAX paged ``ServeSession`` (monolithic: the
    reference's own tests hold its actors to it), the port's four sessions
    and a chunked one, and the last request served alone, on the same
    requests; the port's kernel counters over all of them."""
    fa_kernel.launches = ssd_kernel.launches = 0
    fd_kernel.reset_counts()
    out, reports = {}, []
    for name in CONFIGS:
        e = env[name]
        s = jax_api.compile(e["cfg_j"], mode="serve", backend="monolithic",
                            params=e["params"], mesh=env["mesh"], **PAGED,
                            **GEOMETRY)
        out[(name, "jax")] = s.generate(env["reqs"])
        s.close()
        for backend, cache in SESSIONS + [("actors", "chunked")]:
            kw = dict(stages=_stages(name)) if backend == "actors" else {}
            if cache != "dense":
                kw.update(PAGED)
            if cache == "chunked":
                kw["prefill_chunk"] = 3
            s = api.compile(e["cfg_t"], mode="serve", backend=backend,
                            params=e["state"], device="cpu", **kw,
                            **GEOMETRY)
            reports.append(s.static_report)
            out[(name, backend, cache)] = (s.generate(env["reqs"]),
                                           dict(s.last_stats))
            if (backend, cache) == ("actors", "dense"):
                out[(name, "alone")] = s.generate(env["reqs"][-1:])[0]
            s.close()
    launches = fa_kernel.launches + fd_kernel.launches + ssd_kernel.launches
    return out, reports, launches


@pytest.mark.parametrize("backend,cache", SESSIONS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_matches_jax_token_for_token(served, name, backend, cache):
    out = served[0]
    got, stats = out[(name, backend, cache)]
    assert [len(o) for o in got] == GENS
    for i, (g, w) in enumerate(zip(got, out[(name, "jax")])):
        assert np.array_equal(g, w), f"{name} request {i}: port {g} != jax {w}"
    assert stats["admitted_mid_flight"] >= 1
    assert stats["prefill_items"] == len(GENS)
    if cache == "paged":
        # MoE configs keep shared-prefix pages off, as the reference does
        assert stats["shared_pages"] == 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_a_slot_admitted_mid_flight_keeps_its_state(served, name):
    """The last request is admitted mid-flight into a group whose other
    slot is live, and is parked in that group's decode of its admission
    round: its tokens are those it gets served alone (at capacity factor 8
    no token is dropped, so its group does not change them)."""
    out = served[0]
    got, stats = out[(name, "actors", "dense")]
    assert stats["admitted_mid_flight"] >= 1
    assert np.array_equal(got[-1], out[(name, "alone")])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_chunked_prefill_matches_unchunked(served, name):
    out = served[0]
    got, stats = out[(name, "actors", "chunked")]
    want, _ = out[(name, "actors", "dense")]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    # a prompt longer than the chunk is chunked, a shorter one prefilled
    assert stats["chunk_tokens"] == sum(n for n in PROMPT_LENS if n > 3)
    assert stats["prefill_items"] == sum(n <= 3 for n in PROMPT_LENS)


def test_every_compile_passes_the_static_check(served):
    reports = served[1]
    assert len(reports) == len(CONFIGS) * (len(SESSIONS) + 1)
    assert all(r.verdict == "PASS" for r in reports), \
        [r.describe() for r in reports if r.verdict != "PASS"]


def test_cpu_serving_launches_no_kernel(served):
    assert served[2] == 0


def test_tokens_match_jax_with_expert_drops(env):
    """The full model's capacity factor 1.25: a decode group of 2 slots
    gives an expert ceil(2 * 2 * 1.25 / 4) = 2 tokens, a prompt of 8 an
    expert 5 of its 16 choices, so tokens past an expert's capacity drop;
    the port's choice of which matches the reference's, token for token,
    on the 8-layer config (four MoE layers), against the JAX paged
    session (whose parked rows are inert, as the port's)."""
    cfg_j, cfg_t = _configs("period4", capacity_factor=1.25)
    e = env["period4"]
    sj = jax_api.compile(cfg_j, mode="serve", backend="monolithic",
                         params=e["params"], mesh=env["mesh"], **PAGED,
                         **GEOMETRY)
    st = api.compile(cfg_t, mode="serve", backend="actors", stages=2,
                     params=e["state"], device="cpu", **GEOMETRY)
    want, got = sj.generate(env["reqs"]), st.generate(env["reqs"])
    sj.close()
    st.close()
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def _bytes(tree) -> int:
    if torch.is_tensor(tree):
        return tree.nbytes
    return sum(_bytes(v) for v in (tree.values() if isinstance(tree, dict)
                                   else tree))


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_cache_bound_covers_what_the_caches_hold(env, cache):
    """The static report's per-stage bound holds each stage's cache term
    (``membound.serve_cache_bound``), which counts both kinds' bytes: k/v
    of the attention layers, state and tails of the SSM layers. After a
    run the dense group caches hold exactly the term; the paged slabs'
    pages hold the term less the page table and cursors (int32, kept on
    the host)."""
    from repro_torch.analysis import membound
    e = env["period4"]
    kw = PAGED if cache == "paged" else {}
    s = api.compile(e["cfg_t"], mode="serve", backend="actors", stages=2,
                    params=e["state"], device="cpu", **kw, **GEOMETRY)
    s.generate(env["reqs"][:3])
    terms = membound.serve_cache_bound(s.sstaged, s.num_groups, s.cache,
                                       s.cache_spec)
    bound = s.static_report.peak_bytes_per_device
    for st, sc in enumerate(s.executor.stage_caches):
        name = f"stage{st}"
        assert bound[name] >= terms[name] > 0
        if cache == "dense":
            assert _bytes(list(sc.caches.values())) == terms[name]
        else:
            spec = s.cache_spec
            index = spec.max_requests * (spec.pages_per_req + 2) * 4
            assert _bytes(sc.pages()) == terms[name] - index
    s.close()


# ---------------------------------------------------------------------------
# the launcher, and what raises
# ---------------------------------------------------------------------------

def test_launcher_serves_jamba_on_cpu(capsys):
    outs = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "3", "--prompt-len", "6",
                              "--gen", "4"])
    assert [len(o) for o in outs] == [4, 3, 4]
    assert "serve ok" in capsys.readouterr().out


def test_moe_on_a_mesh_raises(env):
    """The MoE serves on a mesh whose model axis splits its experts
    (``tests/test_torch_deepseek_mesh.py`` holds reduced jamba on (1, 2)
    to the JAX session); on one that does not (4 experts over 8 ranks,
    while the 16 SSM heads split) it raises naming the experts, before a
    model is built."""
    with pytest.raises(ValueError, match="4 experts do not split over "
                                         "tp = 8"):
        api.compile(env["reduced"]["cfg_t"], mode="serve",
                    params=env["reduced"]["state"], device="cpu",
                    mesh=Placement(("data", "model"), (1, 8)), **GEOMETRY)


def test_training_a_hybrid_raises_item_13(env):
    """The port serves jamba but does not train it: every training entry
    point refuses it by name, one device or a mesh, plain or ZeRO, and the
    taped loss program too, so no path runs an SSM layer without its MLP.
    The one-device loss (``loss_fn``) runs the MLP branch after the mixer
    and stays open."""
    e = env["reduced"]
    loss, metrics = loss_fn(e["model"], {"tokens": np.zeros((1, 9),
                                                            np.int32)})
    assert torch.isfinite(loss) and float(metrics["aux_loss"]) > 0
    for shape in ((1, 1), (1, 2), (2, 1)):
        for zero in (True, False):
            with pytest.raises(NotImplementedError,
                               match="training ssm/dense layers.*Queue 1 "
                                     "item 13"):
                make_train_step(e["cfg_t"], MeshPlan(("data", "model"),
                                                     shape),
                                zero=zero, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        T.mesh_loss_program(e["cfg_t"], PLAN)
