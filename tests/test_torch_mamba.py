"""The port's Mamba-2 slice against the JAX package's, on reduced mamba2.

``mamba2-370m.reduced()`` (2 SSM layers, d_model 256, 16 SSM heads of head
dim 32, d_state 32, chunk 32, float32) with ``vocab_size=1000`` (padded to
1024 logit columns): the JAX params are built with ``jax.random`` and loaded
into the port through ``params_from_jax``, and the same numpy-seeded inputs
go through both packages. Tolerances: float32 ``rtol=2e-4, atol=2e-5`` on
outputs, logits and conv tails (XLA and PyTorch sum in different orders),
``1e-4`` on the float32 SSD state, as ``test_kernels.py`` holds ``hT``.
Serving must be token-identical to the JAX ``ServeSession`` on actors and
on monolithic, with unequal prompt and generation lengths and mid-flight
admission (2 groups of 1 slot), as ``TestSSMServe`` serves it.
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
from repro.models.mamba import mamba_decode as jax_mamba_decode  # noqa: E402
from repro.models.mamba import mamba_forward as jax_mamba_forward  # noqa: E402
from repro.models.model_zoo import build_model as jax_build  # noqa: E402
from repro.train.steps import plan_from_mesh  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.lowering import (lower_serve_stages,  # noqa: E402
                                       write_slot)
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models.common import MeshPlan  # noqa: E402
from repro_torch.models.convert import (jax_leaves,  # noqa: E402
                                        params_from_jax, params_to_jax)
from repro_torch.models.model_zoo import (build_model,  # noqa: E402
                                          loss_fn, make_decode_caches)
from repro_torch.models.transformer import (Transformer,  # noqa: E402
                                            check_supported)
from repro_torch.train.steps import make_train_step  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

F32 = dict(rtol=2e-4, atol=2e-5)
STATE = dict(rtol=1e-4, atol=1e-4)
CACHE_LEN = 24
PLAN = MeshPlan.single_device()
PROMPT_LENS = [5, 8, 3, 6, 4]   # unequal prompt lengths, 3 = d_conv - 1
GENS = [3, 6, 2, 5, 4]          # unequal generation lengths
GEOMETRY = dict(num_groups=2, group_size=1, max_prompt_len=max(PROMPT_LENS),
                max_new_tokens=max(GENS), cache_len=CACHE_LEN)


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
    cfg_j = dataclasses.replace(jax_get_config("mamba2-370m").reduced(),
                                vocab_size=1000)
    cfg_t = dataclasses.replace(get_config("mamba2-370m").reduced(),
                                vocab_size=1000)
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
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, mesh=mesh, plan_j=plan_j,
                params=params, np_params=np_params, state=state, model=model,
                prompts=prompts)


def _layer(env, i):
    """Layer i's SSM params: the JAX tree's (numpy) and the port's module."""
    p_j = {k: np.asarray(v)[i]
           for k, v in env["np_params"]["body"][0]["ssm"].items()}
    return p_j, env["model"].blocks[i].ssm


def _hidden(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# the Mamba block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [3, 45, 70])       # one chunk, ragged, three
def test_mamba_forward_matches_jax(env, S):
    cfg_j, cfg_t = env["cfg_j"], env["cfg_t"]
    p_j, p_t = _layer(env, 1)
    x = _hidden(cfg_t, 2, S, seed=S)
    out_j, (h_j, (tx_j, tbc_j)) = jax_mamba_forward(
        p_j, jnp.asarray(x), cfg_j, env["plan_j"], return_state=True)
    out_t, (h_t, (tx_t, tbc_t)) = mamba.mamba_forward(
        p_t, torch.from_numpy(x), cfg_t, PLAN, return_state=True)
    assert out_t.shape == (2, S, cfg_t.d_model)
    assert h_t.dtype == torch.float32
    assert h_t.shape == (2, cfg_t.ssm_heads, cfg_t.ssm_head_dim,
                         cfg_t.ssm_d_state)
    assert tx_t.shape == (2, cfg_t.ssm_d_conv - 1, cfg_t.ssm_d_inner)
    assert_allclose(_np(out_t), _np(out_j), **F32)
    assert_allclose(_np(h_t), _np(h_j), **STATE)
    assert_allclose(_np(tx_t), _np(tx_j), **F32)
    assert_allclose(_np(tbc_t), _np(tbc_j), **F32)
    assert_allclose(_np(mamba.mamba_forward(p_t, torch.from_numpy(x), cfg_t,
                                            PLAN)), _np(out_t))


def test_mamba_decode_matches_jax(env):
    cfg_j, cfg_t = env["cfg_j"], env["cfg_t"]
    p_j, p_t = _layer(env, 0)
    rng = np.random.default_rng(11)
    x = _hidden(cfg_t, 3, 1, seed=12)
    h = rng.normal(size=(3, cfg_t.ssm_heads, cfg_t.ssm_head_dim,
                         cfg_t.ssm_d_state)).astype(np.float32)
    tx = rng.normal(size=(3, cfg_t.ssm_d_conv - 1,
                          cfg_t.ssm_d_inner)).astype(np.float32)
    tbc = rng.normal(size=(3, cfg_t.ssm_d_conv - 1,
                           2 * mamba.G_GROUPS * cfg_t.ssm_d_state)
                     ).astype(np.float32)
    out_j, st_j = jax_mamba_decode(p_j, jnp.asarray(x),
                                   tuple(map(jnp.asarray, (h, tx, tbc))),
                                   cfg_j, env["plan_j"])
    out_t, st_t = mamba.mamba_decode(
        p_t, torch.from_numpy(x), tuple(map(torch.from_numpy, (h, tx, tbc))),
        cfg_t, PLAN)
    assert out_t.shape == (3, 1, cfg_t.d_model)
    assert_allclose(_np(out_t), _np(out_j), **F32)
    for tol, a, b in zip((STATE, F32, F32), st_t, st_j):
        assert_allclose(_np(a), _np(b), **tol)


@pytest.mark.parametrize("S", [3, 33, 64])
def test_prefill_then_decode_equals_full_forward(env, S):
    """Prefill S tokens, decode token S+1 from the prefill's state: the
    output equals ``mamba_forward`` over all S+1 tokens at the last
    position, and the new state equals the longer prefill's. This pins the
    order of the conv tail's rows."""
    cfg_t = env["cfg_t"]
    _, p_t = _layer(env, 0)
    x = torch.from_numpy(_hidden(cfg_t, 2, S + 1, seed=20 + S))
    _, (h, (tx, tbc)) = mamba.mamba_forward(p_t, x[:, :S], cfg_t, PLAN,
                                            return_state=True)
    out, (h1, tx1, tbc1) = mamba.mamba_decode(p_t, x[:, S:], (h, tx, tbc),
                                              cfg_t, PLAN)
    full, (hf, (txf, tbcf)) = mamba.mamba_forward(p_t, x, cfg_t, PLAN,
                                                  return_state=True)
    assert_allclose(_np(out[:, 0]), _np(full[:, S]), rtol=1e-4, atol=1e-5)
    assert_allclose(_np(h1), _np(hf), rtol=1e-4, atol=1e-5)
    # the tails are projections of the same rows, taken in matmuls of
    # another shape: equal up to the GEMM's rounding
    assert_allclose(_np(tx1), _np(txf), rtol=1e-5, atol=1e-6)
    assert_allclose(_np(tbc1), _np(tbcf), rtol=1e-5, atol=1e-6)


def test_init_mamba_state_matches_cache_layout(env):
    cfg_t = env["cfg_t"]
    h, tx, tbc = mamba.init_mamba_state(cfg_t, PLAN, 2, torch.float32)
    cache = make_decode_caches(cfg_t, PLAN, 2, CACHE_LEN)[0]
    assert set(cache) == {"h", "tail_x", "tail_bc"}
    for a, key in zip((h, tx, tbc), ("h", "tail_x", "tail_bc")):
        assert a.shape == cache[key].shape and not a.any()
    assert cache["h"].dtype == torch.float32


def test_bf16_config_caches_keep_state_in_float32():
    cfg = get_config("mamba2-370m")
    with torch.device("meta"):
        cache = make_decode_caches(cfg, PLAN, 4, 569, layers=[0])[0]
    assert cache["h"].dtype == torch.float32
    assert cache["h"].shape == (4, 32, 64, 128)
    assert cache["tail_x"].dtype == torch.bfloat16
    assert cache["tail_x"].shape == (4, 3, 2048)
    assert cache["tail_bc"].shape == (4, 3, 256)


# ---------------------------------------------------------------------------
# params: conversion, init
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
    assert {k for k in env["state"] if ".ssm." in k} == {
        f"blocks.{i}.ssm.{n}" for i in range(2) for n in (
            "w_x", "w_z", "w_bc", "w_dt", "dt_bias", "A_log", "D", "conv_x",
            "conv_bc", "norm_w", "out_proj")}


def test_port_init_is_seeded_and_shaped_as_jax(env):
    cfg_t = env["cfg_t"]
    a = build_model(cfg_t, PLAN, seed=3, device="cpu")
    b = build_model(cfg_t, PLAN, seed=3, device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert {k: tuple(v.shape) for k, v in a.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in env["state"].items()}
    for name in ("A_log", "D", "dt_bias", "norm_w"):
        assert_allclose(getattr(a.blocks[0].ssm, name).numpy(),
                        env["state"][f"blocks.0.ssm.{name}"].numpy(),
                        rtol=1e-6)


def test_check_supported_admits_ssm_and_refuses_hybrids():
    """The port builds and serves a hybrid's SSM layers with their MLP
    (jamba, ``tests/test_torch_jamba.py``) and refuses to train them,
    naming item 13; deepseek-v3's multi-token prediction is built
    (``tests/test_torch_deepseek_v3.py`` holds it to the JAX package)."""
    check_supported(get_config("mamba2-370m"))
    check_supported(get_config("jamba-v0.1-52b"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        make_train_step(get_config("jamba-v0.1-52b"), device="cpu")
    check_supported(get_config("deepseek-v3-671b"))


def test_training_an_ssm_config_raises(env):
    """SSM layers train now (they raised naming Queue 2 item 4 until the SSD
    scan had a backward): the loss and every gradient leaf of reduced
    mamba2 against the JAX bundle's ``value_and_grad`` on the same params
    and tokens, the loss to 1e-5 relative and each leaf to 1e-4 relative in
    norm: ``A_log``'s gradient sums the decays' terms with much
    cancellation, and both packages' float32 runs sit 2.5e-5 to 6.6e-5
    from a float64 run of the port there (2.8e-5 from each other); the
    other leaves agree within 1.6e-5. The train step runs on it. A hybrid
    still raises, naming item 13."""
    cfg_t = env["cfg_t"]
    tokens = np.random.default_rng(5).integers(
        0, cfg_t.vocab_size, (2, 41)).astype(np.int32)
    with torch.device("meta"):
        model = Transformer(cfg_t, PLAN)
    model.load_state_dict(env["state"], assign=True)
    for p in model.parameters():
        p.requires_grad_(True)
    loss, _ = loss_fn(model, {"tokens": tokens})
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(
        loss, list(model.parameters()))))
    bundle = jax_build(env["cfg_j"], env["plan_j"])
    (want_loss, _), want = jax.value_and_grad(bundle.loss_fn, has_aux=True)(
        env["params"], {"tokens": jnp.asarray(tokens)})
    assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    want = params_from_jax(jax.device_get(want), cfg_t)
    assert set(want) == set(grads)
    for n, w in want.items():
        err = float((grads[n] - w).norm() / w.norm())
        assert err <= 1e-4, f"{n}: {err:.3e} relative in norm"
    ts = make_train_step(cfg_t, zero=False, device="cpu")
    params = ts.init_params(0)
    _, _, m = ts.step_fn(params, ts.init_opt(params), {"tokens": tokens})
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        make_train_step(get_config("jamba-v0.1-52b"), device="cpu")


# ---------------------------------------------------------------------------
# serve stages
# ---------------------------------------------------------------------------

def _stages(env, num_stages):
    js = jax_lower(env["cfg_j"], env["mesh"], env["params"],
                   num_stages=num_stages, cache_len=CACHE_LEN,
                   max_prompt_len=8, group_size=2)
    ts = lower_serve_stages(env["cfg_t"], env["model"], num_stages=num_stages,
                            cache_len=CACHE_LEN, max_prompt_len=8,
                            group_size=2)
    return js, ts


def _jax_layer_caches(tree):
    out = [dict(c) for c in tree["prologue"]]
    for slot in tree["body"]:
        for i in range(np.shape(slot["h"])[0]):
            out.append({k: np.asarray(v)[i] for k, v in slot.items()})
    return out


@pytest.mark.parametrize("num_stages", [1, 2])
def test_prefill_and_decode_stages_match_jax(env, num_stages):
    """Two prompts prefilled into the slots of a group, then three decode
    steps: logits and every SSM cache leaf agree."""
    js, ts = _stages(env, num_stages)
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
            assert_allclose(_np(ct["h"]), _np(cj["h"]), **STATE)
            for key in ("tail_x", "tail_bc"):
                assert_allclose(_np(ct[key]), _np(cj[key]), **F32)


def _caches(cfg, S, fill):
    """An attention and an SSM layer's slot caches of a prompt of S tokens
    and the group caches they go into."""
    rng = np.random.default_rng(fill)
    group = [{"k": torch.ones((2, 10, 2, 4)), "v": torch.ones((2, 10, 2, 4))},
             make_decode_caches(cfg, PLAN, 2, 10)[0]]
    slot = [{k: torch.from_numpy(rng.normal(size=(1, S, 2, 4))
                                 .astype(np.float32)) for k in ("k", "v")},
            {k: torch.from_numpy(rng.normal(size=(1,) + tuple(v.shape[1:]))
                                 .astype(np.float32))
             for k, v in group[1].items()}]
    return group, slot


def test_write_slot_copies_state_whole_and_positions_by_length(env):
    cfg = env["cfg_t"]
    group, slot = _caches(cfg, 4, 30)
    write_slot(group, slot, 1)
    assert torch.equal(group[0]["k"][1, :4], slot[0]["k"][0])
    assert not group[0]["k"][1, 4:].any()
    assert torch.equal(group[0]["k"][0], torch.ones((10, 2, 4)))
    for key in ("h", "tail_x", "tail_bc"):
        assert torch.equal(group[1][key][1], slot[1][key][0]), key
        assert not group[1][key][0].any(), key


def test_write_slot_refuses_a_short_conv_tail(env):
    cfg = env["cfg_t"]
    group, slot = _caches(cfg, 2, 31)
    slot[1]["tail_x"] = slot[1]["tail_x"][:, :2]
    with pytest.raises(ValueError, match="ssm_d_conv"):
        write_slot(group, slot, 0)


def test_describe_counts_ssm_units():
    """Full-width mamba2-370m on the meta device (shapes only): 48 units,
    24 a stage at stages = 2; A_log, D and dt_bias stay float32."""
    cfg = get_config("mamba2-370m")
    with torch.device("meta"):
        model = Transformer(cfg, PLAN)
    prog = lower_serve_stages(cfg, model, num_stages=2, cache_len=569,
                              max_prompt_len=512, group_size=4)
    rep = prog.describe()
    assert "over 48 stack units (48 ssm/none layers)" in rep
    assert "stage 0: units [0, 24)" in rep and "stage 1: units [24, 48)" in rep
    ssm = prog.stages[0].params.blocks[0].ssm
    assert ssm.w_x.dtype == torch.bfloat16
    assert {getattr(ssm, n).dtype for n in mamba.FLOAT32_PARAMS} == {
        torch.float32}
    # the reference tree's leaves hold as many (jax.eval_shape of its init);
    # cfg.param_count() says 419,662,848, leaving out the vocab padding,
    # conv_bc, dt_bias and the final norm
    assert sum(p.numel() for p in model.parameters()) == 419_763_712


# ---------------------------------------------------------------------------
# serving, token for token
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sessions(env):
    out = {}
    for backend in ("actors", "monolithic"):
        kw = dict(stages=2) if backend == "actors" else {}
        out[("jax", backend)] = jax_api.compile(
            env["cfg_j"], mode="serve", backend=backend, params=env["params"],
            mesh=env["mesh"], **kw, **GEOMETRY)
        out[("port", backend)] = api.compile(
            env["cfg_t"], mode="serve", backend=backend, params=env["state"],
            device="cpu", **kw, **GEOMETRY)
    yield out
    for s in out.values():
        s.close()


@pytest.fixture(scope="module")
def served(env, sessions):
    reqs = list(zip(env["prompts"], GENS))
    ssd_kernel.launches = 0
    out = {key: (s.generate(reqs), dict(s.last_stats))
           for key, s in sessions.items()}
    return out, ssd_kernel.launches


@pytest.mark.parametrize("backend", ["actors", "monolithic"])
def test_port_matches_jax_token_for_token(env, served, backend):
    want, _ = served[0][("jax", backend)]
    got, stats = served[0][("port", backend)]
    assert [len(o) for o in got] == GENS
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), f"request {i}: port {g} != jax {w}"
    assert stats["admitted_mid_flight"] >= 1
    assert all((o >= 0).all() and (o < 1000).all() for o in got)


def test_port_actors_match_port_monolithic(served):
    a, sa = served[0][("port", "actors")]
    b, sb = served[0][("port", "monolithic")]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for key in ("prefill_items", "decode_items", "rounds"):
        assert sa[key] == sb[key]
    assert sa["prefill_items"] == len(GENS)


def test_cpu_serving_launches_no_kernel(served):
    assert served[1] == 0


def test_short_prompt_is_refused(env, sessions):
    """A prompt of fewer than ssm_d_conv - 1 tokens cannot fill the conv
    state: refused before any work runs."""
    sess = sessions[("port", "monolithic")]
    rounds = sess._engine.rounds
    with pytest.raises(ValueError, match="ssm_d_conv"):
        sess.generate([(env["prompts"][0], 2), (env["prompts"][1][:2], 2)])
    assert sess._engine.rounds == rounds


def test_launcher_serves_mamba2_on_cpu(capsys):
    outs = launch_serve.main(["--arch", "mamba2-370m", "--smoke", "--device",
                              "cpu", "--requests", "3", "--prompt-len", "6",
                              "--gen", "4"])
    assert [len(o) for o in outs] == [4, 3, 4]
    assert "serve ok" in capsys.readouterr().out
