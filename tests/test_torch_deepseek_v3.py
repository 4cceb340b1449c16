"""The port's deepseek-v3-671b against the JAX package's, on one device on
the CPU: multi-token prediction (MTP) in the training loss, and MLA with a
q LoRA over an MoE served.

``deepseek-v3-671b.reduced()`` (2 layers: a leading dense layer, then MLA
with a q LoRA of rank 64 and an MoE of 4 routed experts top-2 plus 1
shared; d_model 256, 4 heads, kv_lora 64, q/k head dim nope 64 + rope 32
= 96, v head dim 64, capacity factor 8, MTP on at weight 0.3, float32) with
``vocab_size=1000`` (padded to 1024 logit columns), as the other deepseek
files use. The JAX params are built with ``jax.random.PRNGKey(0)`` and
carried into the port by ``params_from_jax``; the same numpy-seeded inputs
go through both packages. Tolerances (measured here in brackets):

* block and whole-model outputs, logits and float32 caches: ``rtol=2e-4,
  atol=2e-5`` (XLA and PyTorch sum in different orders) at the output's
  scale for the MoE layer (its expert stacks are drawn at std 1 / sqrt(E),
  so its outputs reach about 10^2); a prefill's latent cache, rounded to
  bf16 in both packages, to one bf16 step (``rtol=2**-7``): where the two
  float32 values straddle a rounding boundary the two roundings differ by
  one step (measured 0.0057 relative on 1 of 2,176 elements);
* ``forward_loss``'s ``lm_loss``, ``mtp_loss``, ``aux_loss`` and ``loss``
  to 1e-5 relative (at most 1.2e-7); every gradient leaf, the four MTP
  leaves among them, to ``rtol=1e-4, atol=1e-6`` (test_torch_train.py's);
* three AdamW steps, plain and ZeRO, against the JAX ``make_train_step``
  (ZeRO; at 1 x 1 its plain step makes the same update, and
  ``tests/test_torch_deepseek_v3_mesh.py`` holds the port's plain step to
  the JAX plain step on (2, 2)): each step's metrics, ``mtp_loss`` among
  them, to 1e-5 relative, the params after them to ``rtol=1e-4,
  atol=5e-5``, but for the elements whose gradient is rounding noise in
  some step, held within lr (``torch_frontend_parity
  .check_params_by_step``: AdamW moves such an element by a share of lr
  that the noise decides; here one ``embed`` element, its step-0 |g|
  4.6e-8 of the largest, ends 1.45e-4 from the JAX run);
* served tokens identical to the JAX paged ``ServeSession`` (monolithic;
  its actors give the same tokens), on the port's actors (2 stages) and
  monolithic engine, dense and paged.
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
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.model_zoo import build_model as jax_build  # noqa: E402
from repro.optim.adamw import AdamWConfig as JaxAdamW  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.steps import plan_from_mesh  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.lowering import lower_serve_stages  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import MeshPlan, dense_init  # noqa: E402
from repro_torch.models.convert import (jax_leaves,  # noqa: E402
                                        params_from_jax, params_to_jax,
                                        unstack_layers)
from repro_torch.models.model_zoo import (build_model,  # noqa: E402
                                          loss_fn, make_decode_caches)
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.steps import (make_train_step,  # noqa: E402
                                     metric_names)
from torch_frontend_parity import (check_params_by_step,  # noqa: E402
                                   noise_in_a_step)
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ARCH = "deepseek-v3-671b"
F32 = dict(rtol=2e-4, atol=2e-5)
#: a bf16-rounded cache: one bf16 step
BF16_STEP = dict(rtol=2.0 ** -7, atol=2e-5)
PLAN = MeshPlan.single_device()
CACHE_LEN = 24
LR, STEPS, B, S = 3e-4, 3, 2, 32
PROMPT_LENS = [5, 8, 3, 6, 4]
GENS = [3, 6, 2, 5, 4]
GEOMETRY = dict(num_groups=2, group_size=2, max_prompt_len=max(PROMPT_LENS),
                max_new_tokens=max(GENS), cache_len=CACHE_LEN)
PAGED = dict(cache="paged", page_len=4, num_pages=12)
#: the MTP module's leaves, as the port names them
MTP_TOP = ("mtp_norm_h", "mtp_norm_e", "mtp_proj")


def _mesh():
    """The reference's 1x1 mesh with Auto axes (its serving path scatters
    into mesh-typed group caches, which only Auto axes accept)."""
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _scale_tol(want):
    """float32 at the array's scale: ``atol`` 2e-6 of its largest entry
    (the MoE's outputs reach 10^2), ``rtol`` 2e-4 as elsewhere."""
    return dict(rtol=2e-4, atol=max(2e-5, 2e-6 * float(np.abs(
        np.asarray(want, np.float32)).max())))


@pytest.fixture(scope="module")
def env():
    cfg_j = dataclasses.replace(jax_get_config(ARCH).reduced(),
                                vocab_size=1000)
    cfg_t = dataclasses.replace(get_config(ARCH).reduced(), vocab_size=1000)
    assert cfg_t.mtp and cfg_t.q_lora_rank == 64 and cfg_t.num_experts == 4
    mesh = _mesh()
    plan_j = plan_from_mesh(mesh)
    bundle = jax_build(cfg_j, plan_j)
    params = bundle.init(jax.random.PRNGKey(0))
    np_params = jax.device_get(params)
    state = params_from_jax(np_params, cfg_t)
    with torch.device("meta"):
        model = T.Transformer(cfg_t, PLAN)
    model.load_state_dict(state, assign=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 1000, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    return dict(cfg_j=cfg_j, cfg=cfg_t, mesh=mesh, plan_j=plan_j,
                bundle=bundle, params=params, np_params=np_params,
                state=state, model=model, prompts=prompts)


# ---------------------------------------------------------------------------
# the config and the parameters
# ---------------------------------------------------------------------------

def test_config_equals_the_reference_field_for_field():
    a, b = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced())
    T.check_supported(a)
    T.check_supported(a.reduced())


def test_leaf_order_is_the_jax_tree_flatten_order(env):
    """The MTP leaves sort between ``final_norm`` and ``prologue``: the
    AdamW and gradient-norm order of every train step."""
    paths = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
             for path, _ in
             jax.tree_util.tree_flatten_with_path(env["np_params"])[0]]
    got = [p for p, _ in jax_leaves(env["cfg"])]
    assert got == paths
    tops = list(dict.fromkeys(p[0] for p in got))
    assert tops == ["body", "embed", "final_norm", "mtp_block", "mtp_norm_e",
                    "mtp_norm_h", "mtp_proj", "prologue", "unembed"]


def test_params_to_jax_inverts_params_from_jax(env):
    cfg = env["cfg"]
    tree = params_to_jax(env["state"], cfg)
    flat_j = jax.tree_util.tree_flatten_with_path(env["np_params"])[0]
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (_, a), (_, b) in zip(flat_t, flat_j):
        np.testing.assert_array_equal(a, np.asarray(b))
    d = cfg.d_model
    assert env["state"]["mtp_proj"].shape == (2 * d, d)
    assert {k for k in env["state"] if k.startswith("mtp_block.")} == {
        "mtp_block." + n for n in (
            "ln1", "ln2", "attn.wq_a", "attn.q_norm", "attn.wq_b",
            "attn.wkv_a", "attn.kv_norm", "attn.w_uk", "attn.w_uv",
            "attn.wo", "mlp.w_gate", "mlp.w_up", "mlp.w_down")}


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", ARCH,
                                  "jamba-v0.1-52b"])
def test_init_in_bf16_is_the_float32_init_cast_bitwise(arch):
    """Drawing in bf16 (each expert stack cast as it is drawn, the other
    leaves by block) gives bitwise what the float32 init, cast, gives: the
    old draw-then-cast. The same seed's float32 init is unchanged, leaf
    for leaf."""
    cfg = dataclasses.replace(get_config(arch).reduced(), vocab_size=1000)
    f32 = build_model(cfg, PLAN, seed=3, device="cpu")
    again = build_model(cfg, PLAN, seed=3, device="cpu")
    h = build_model(cfg, PLAN, seed=3, device="cpu", dtype=torch.bfloat16)
    keep32 = ("A_log", "D", "dt_bias")        # the SSM's float32-read leaves
    names = [n for n, _ in f32.named_parameters()]
    assert names == [n for n, _ in h.named_parameters()]
    for (n, a), (_, b), (_, c) in zip(f32.named_parameters(),
                                      again.named_parameters(),
                                      h.named_parameters()):
        assert a.dtype == torch.float32 and torch.equal(a, b), n
        dt = torch.float32 if n.rsplit(".", 1)[-1] in keep32 \
            else torch.bfloat16
        assert c.dtype == dt and torch.equal(c, a.to(dt)), n
    assert any(".moe.w_" in n for n in names)
    assert ("mtp_proj" in names) == cfg.mtp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_init_scales_in_place_as_the_product_did(dtype):
    """``dense_init``'s in-place scale and cast: bitwise ``(w * std)
    .to(dtype)`` of the same draw."""
    gen = torch.Generator().manual_seed(11)
    got = dense_init(gen, (6, 40, 24), dtype=dtype)
    w = torch.randn((6, 40, 24), generator=torch.Generator().manual_seed(11))
    assert got.dtype == dtype
    assert torch.equal(got, (w * (1.0 / np.sqrt(6))).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_update_in_chunks_is_the_whole_update_bitwise(monkeypatch,
                                                            dtype):
    """``adamw_param_update`` over chunks of a tensor's flat elements (how
    it bounds its float32 temporaries on deepseek-v3's 3.45 GiB embedding)
    gives the params and moments of one whole-tensor update, bit for bit,
    over two steps; the chunk (7) does not divide the size (5 x 13)."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(5)
    mk = lambda: torch.from_numpy(  # noqa: E731
        rng.normal(size=(5, 13)).astype(np.float32))
    p0, m0, v0 = mk(), mk(), mk().abs()
    grads = [mk(), mk()]
    runs = []
    for chunk in (adamw.UPDATE_CHUNK, 7):
        monkeypatch.setattr(adamw, "UPDATE_CHUNK", chunk)
        p, m, v = p0.to(dtype), m0.clone(), v0.clone()
        for step, g in enumerate(grads, 1):
            adamw.adamw_param_update(p, g * 0.5, m, v,
                                     torch.tensor(step, dtype=torch.int32),
                                     3e-4)
        runs.append((p, m, v))
    for a, b in zip(*runs):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_full_width_cuts_on_the_meta_device():
    """The two full-width cuts the card runs: 4 layers (3 dense, then one
    MoE of 256 experts top-8 and a shared one) with the MTP module, and
    one MLA + dense layer with it (the training cut); shapes only."""
    full = get_config(ARCH)
    counts = {}
    for name, kw in (("serve", dict(num_layers=4)),
                     ("train", dict(num_layers=1, first_dense_layers=0,
                                    num_experts=0))):
        cfg = dataclasses.replace(full, **kw)
        with torch.device("meta"):
            model = T.Transformer(cfg, PLAN, dtype=torch.bfloat16)
        counts[name] = sum(p.numel() for p in model.parameters())
        mtp = sum(p.numel() for n, p in model.named_parameters()
                  if n.startswith("mtp_"))
        assert mtp > 0
    assert [k for k, _ in T.stack_layout(dataclasses.replace(
        full, num_layers=4)).layer_kinds()] == ["attn"] * 4
    assert round(counts["serve"] / 1e9, 2) == 15.80
    assert round(counts["train"] / 1e9, 2) == 3.12
    with torch.device("meta"):
        w = T.Transformer(dataclasses.replace(full, num_layers=4),
                          PLAN).blocks[3].moe.w_gate
    assert tuple(w.shape) == (256, 7168, 2048)


# ---------------------------------------------------------------------------
# the MLA block with a q LoRA, and the whole model
# ---------------------------------------------------------------------------

def _block(env, which):
    """The JAX params (numpy) and the port's block of layer 0 (dense), 1
    (the body's MoE) or the MTP block, with its kinds."""
    npp, model = env["np_params"], env["model"]
    if which == "mtp":
        return npp["mtp_block"], model.mtp_block, ("attn", "dense")
    if which == 0:
        return npp["prologue"][0], model.blocks[0], ("attn", "dense")
    return (jax.tree.map(lambda a: np.asarray(a)[0], npp["body"][0]),
            model.blocks[1], ("attn", "moe"))


@pytest.fixture(scope="module")
def block_fns(env):
    """The jitted JAX ``apply_block`` / ``decode_block``, one compile a
    kind and shape, shared by the cases."""
    cfg_j, plan_j = env["cfg_j"], env["plan_j"]
    prefill = {k: jax.jit(lambda p, x, pos, k=k: JT.apply_block(
        p, x, cfg_j, plan_j, *k, pos, want_cache=True, cache_len=CACHE_LEN))
        for k in (("attn", "dense"), ("attn", "moe"))}
    decode = {k: jax.jit(lambda p, x, c, pos, k=k: JT.decode_block(
        p, x, c, pos, cfg_j, plan_j, *k)) for k in prefill}
    return prefill, decode


@pytest.mark.parametrize("which", [0, 1, "mtp"])
def test_mla_block_with_q_lora_prefill_matches_jax(env, block_fns, which):
    cfg = env["cfg"]
    p_j, blk, kind = _block(env, which)
    Sq = 17
    x = np.random.default_rng(5).normal(size=(2, Sq, cfg.d_model)).astype(
        np.float32)
    pos = np.arange(Sq)
    y_j, aux_j, c_j = block_fns[0][kind](p_j, jnp.asarray(x),
                                         jnp.asarray(pos))
    y_t, aux_t, c_t = T.apply_block(blk, torch.from_numpy(x), cfg, PLAN,
                                    *kind, torch.from_numpy(pos),
                                    want_cache=True, cache_len=CACHE_LEN)
    assert hasattr(blk.attn, "wq_a") and not hasattr(blk.attn, "wq")
    assert_allclose(_np(y_t), _np(y_j), **_scale_tol(y_j))
    if kind[1] == "moe":
        assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    else:
        assert aux_t is None and float(aux_j) == 0.0
    for key in ("c", "kpe"):
        assert c_t[key].dtype == torch.bfloat16
        assert_allclose(_np(c_t[key]), _np(c_j[key])[:, :Sq], **BF16_STEP)


@pytest.mark.parametrize("which", [0, 1])
def test_mla_block_with_q_lora_decode_matches_jax(env, block_fns, which):
    """One absorbed decode step of a block over random latent caches at
    three positions: the output and both caches (the new token written in
    place)."""
    cfg = env["cfg"]
    p_j, blk, kind = _block(env, which)
    rng = np.random.default_rng(7 + which)
    Bd = 3
    x = rng.normal(size=(Bd, 1, cfg.d_model)).astype(np.float32)
    cache = {"c": rng.normal(size=(Bd, CACHE_LEN, cfg.kv_lora_rank)),
             "kpe": rng.normal(size=(Bd, CACHE_LEN, cfg.qk_rope_head_dim))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    pos = np.asarray([0, 9, CACHE_LEN - 1], np.int32)
    y_j, c_j = block_fns[1][kind](p_j, jnp.asarray(x),
                                  {k: jnp.asarray(v) for k, v in
                                   cache.items()}, jnp.asarray(pos))
    c_t = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    y_t, _ = T.decode_block(blk, torch.from_numpy(x), c_t,
                            torch.from_numpy(pos), cfg, PLAN, *kind)
    assert_allclose(_np(y_t), _np(y_j), **_scale_tol(y_j))
    for key in ("c", "kpe"):
        assert_allclose(_np(c_t[key]), _np(c_j[key]), **F32)


def test_whole_model_prefill_and_two_decodes_match_jax(env):
    """The JAX bundle's whole-model prefill of a 2 x 11 prompt batch, then
    two decode steps from its greedy tokens, against the port's: the
    prefill's last hidden and every layer's latent cache (rounded to bf16:
    one step apart where a rounding flips), then each decode step's logits
    and caches, both packages decoding from the JAX prefill's caches (so a
    flipped bf16 step does not reach the logits). The MTP module takes no
    part."""
    cfg, bundle, params = env["cfg"], env["bundle"], env["params"]
    toks = np.random.default_rng(9).integers(0, 1000, (2, 11)).astype(
        np.int32)
    h_j, caches_j = jax.jit(lambda p, t: bundle.prefill(
        p, {"tokens": t}, CACHE_LEN))(params, jnp.asarray(toks))
    h_t, caches_t = T.prefill(env["model"], {"tokens": toks}, CACHE_LEN)
    assert_allclose(_np(h_t), _np(h_j), **F32)
    layers_j = unstack_layers(jax.device_get(caches_j), cfg)
    for cj, ct in zip(layers_j, caches_t):
        for key in ("c", "kpe"):
            assert ct[key].dtype == torch.bfloat16
            assert_allclose(_np(ct[key]), _np(cj[key]), **BF16_STEP)
            ct[key].copy_(torch.from_numpy(_np(cj[key])))
    logits0 = _np(h_j)[:, 0] @ env["np_params"]["unembed"]
    tok = np.argmax(logits0[:, :1000], -1).astype(np.int32)
    pos = np.full((2,), toks.shape[1], np.int32)
    decode = jax.jit(bundle.decode_step)
    for _ in range(2):
        lj, caches_j = decode(params, caches_j, jnp.asarray(tok),
                              jnp.asarray(pos))
        lt, caches_t = T.decode_step(env["model"], caches_t, tok, pos)
        assert_allclose(_np(lt), _np(lj), **_scale_tol(lj))
        for cj, ct in zip(unstack_layers(jax.device_get(caches_j), cfg),
                          caches_t):
            for key in ("c", "kpe"):
                assert_allclose(_np(ct[key]), _np(cj[key]), **BF16_STEP)
        tok = np.argmax(_np(lj)[:, :1000], -1).astype(np.int32)
        pos = pos + 1


def test_serve_stages_hold_no_mtp_leaf(env):
    """Serving reads no MTP leaf: the stages hold the embedding, the
    blocks, the final norm and the head only."""
    prog = lower_serve_stages(env["cfg"], env["model"], num_stages=2,
                              cache_len=CACHE_LEN, max_prompt_len=8,
                              group_size=2)
    names = [n for st in prog.stages for n, _ in
             st.params.named_parameters()]
    assert names and not any("mtp" in n for n in names)
    caches = make_decode_caches(env["cfg"], PLAN, 2, CACHE_LEN)
    assert len(caches) == env["cfg"].num_layers


# ---------------------------------------------------------------------------
# serving, token for token
# ---------------------------------------------------------------------------

SESSIONS = [("actors", "dense"), ("monolithic", "dense"),
            ("actors", "paged"), ("monolithic", "paged")]


@pytest.fixture(scope="module")
def served(env):
    """The JAX paged session's tokens (monolithic), and the port's on each
    of SESSIONS, with its stats and the kernel launches (none on the
    CPU)."""
    reqs = list(zip(env["prompts"], GENS))
    sess = jax_api.compile(env["cfg_j"], mode="serve", backend="monolithic",
                           params=env["params"], mesh=env["mesh"], **PAGED,
                           **GEOMETRY)
    want = sess.generate(reqs)
    sess.close()
    fa_kernel.launches = 0
    out = {}
    for backend, cache in SESSIONS:
        kw = dict(stages=2) if backend == "actors" else {}
        if cache == "paged":
            kw.update(PAGED)
        with api.compile(env["cfg"], mode="serve", backend=backend,
                         params=env["state"], device="cpu", **kw,
                         **GEOMETRY) as s:
            out[backend, cache] = (s.generate(reqs), dict(s.last_stats))
    return want, out, fa_kernel.launches


@pytest.mark.parametrize("backend,cache", SESSIONS)
def test_port_matches_the_jax_paged_session_token_for_token(served, backend,
                                                            cache):
    want, out, _ = served
    got, stats = out[backend, cache]
    assert [len(o) for o in got] == GENS
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), f"request {i}: port {g} != jax {w}"
    assert stats["admitted_mid_flight"] >= 1
    assert stats["prefill_items"] == len(GENS)


def test_cpu_serving_launches_no_kernel(served):
    assert served[2] == 0


# ---------------------------------------------------------------------------
# training at 1 x 1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(env):
    """The JAX side of training: the first batch's loss, metrics and
    gradients (``jax.value_and_grad`` of the bundle's ``loss_fn``), and
    three steps of the JAX ``make_train_step`` (ZeRO; metrics each step,
    params after)."""
    cfg_j, mesh = env["cfg_j"], env["mesh"]
    src = JaxSyntheticLM(cfg_j.vocab_size, B, S)
    batches = [src(i) for i in range(STEPS)]
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        env["bundle"].loss_fn, has_aux=True))(
        env["params"], {"tokens": jnp.asarray(batches[0])})
    ts = jax_make_train_step(cfg_j, mesh, optimizer=JaxAdamW(lr=LR),
                             zero=True)
    params = ts.shard_params_fn(jax.tree.map(jnp.array, env["np_params"]))
    opt = ts.init_opt(params)
    steps = []
    for b in batches:
        params, opt, m = ts.step_fn(params, opt, {"tokens": b})
        steps.append({k: float(v) for k, v in m.items()})
    cfg = env["cfg"]
    return dict(batches=batches,
                metrics={k: float(v) for k, v in metrics.items()},
                grads=params_from_jax(jax.device_get(grads), cfg),
                steps=steps,
                params=params_from_jax(jax.device_get(
                    ts.gather_params_fn(params)), cfg))


def _port_model(env):
    model = make_train_step(env["cfg"], zero=False,
                            device="cpu").init_params(0)
    model.load_state_dict(env["state"])
    return model


def test_forward_loss_and_grads_match_jax(env, ref):
    """The four losses, and every gradient leaf: the MTP leaves
    (``mtp_norm_h`` reads the final-normed hidden, normed twice) and the
    q LoRA's among them."""
    model = _port_model(env)
    loss, metrics = loss_fn(model, {"tokens": ref["batches"][0]})
    assert list(metrics) == ["lm_loss", "aux_loss", "mtp_loss", "loss"]
    for k, v in metrics.items():
        assert_allclose(float(v.detach()), ref["metrics"][k], rtol=1e-5,
                        err_msg=k)
    cfg = env["cfg"]
    assert_allclose(float(loss), float(metrics["lm_loss"])
                    + cfg.mtp_weight * float(metrics["mtp_loss"])
                    + cfg.router_aux_weight * float(metrics["aux_loss"]),
                    rtol=1e-6)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert set(grads) == set(ref["grads"])
    for name in (*MTP_TOP, "mtp_block.attn.wq_a", "blocks.1.attn.q_norm"):
        assert name in grads
    for name, g in grads.items():
        assert g.abs().max() > 0, name
        assert_allclose(g.numpy(), ref["grads"][name].numpy(), rtol=1e-4,
                        atol=1e-6, err_msg=name)


def test_mtp_targets_weigh_out_the_last_position():
    """Position t's MTP label is the LM label at t + 1; the last position
    repeats the last label at weight 0, so the mean is over B x (S - 1)."""
    labels = torch.arange(10, dtype=torch.int32).reshape(2, 5)
    t, w = T.mtp_targets(labels)
    assert t.tolist() == [[1, 2, 3, 4, 4], [6, 7, 8, 9, 9]]
    assert w.dtype == torch.float32
    assert w.tolist() == [[1, 1, 1, 1, 0]] * 2


@pytest.mark.parametrize("zero", [False, True], ids=["plain", "zero"])
def test_three_train_steps_match_jax(env, ref, zero):
    ts = make_train_step(env["cfg"], optimizer=AdamWConfig(lr=LR), zero=zero,
                         device="cpu")
    params = (ts.shard_params_fn(env["state"]) if zero
              else _port_model(env))
    opt = ts.init_opt(params)
    noise = {}
    for step, b in enumerate(ref["batches"]):
        noise = noise_in_a_step(noise, ts.grad_fn(params, {"tokens": b})[1])
        params, opt, m = ts.step_fn(params, opt, {"tokens": b})
        assert tuple(m) == metric_names(env["cfg"]) == (
            "lm_loss", "aux_loss", "loss", "mtp_loss", "grad_norm")
        for k, want in ref["steps"][step].items():
            assert_allclose(float(m[k]), want, rtol=1e-5,
                            err_msg=f"step {step} {k}")
    got = ts.gather_params_fn(params) if zero else params.state_dict()
    assert set(got) == set(ref["params"])
    check_params_by_step(got, ref["params"], noise)
