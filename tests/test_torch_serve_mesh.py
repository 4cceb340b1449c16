"""Serving on a mesh of ranks: tensor- and data-parallel qwen3.

Holds ``repro_torch.api.compile(cfg, mode="serve", mesh=...)`` to the JAX
package on reduced qwen3-1.7b with ``vocab_size=1000`` (4 q / 2 kv heads,
float32), from the JAX init carried over by ``params_from_jax``. As in
``test_torch_graph_mesh.py`` the JAX side runs once per module in a
subprocess with 8 host devices and Auto mesh axes (the reference's serving
path scatters into mesh-typed caches, which Explicit axes refuse), from the
code below, and writes ``.npz`` results; the port runs in process on the
CPU, every rank a thread.

* On (1, 2), (2, 1), (1, 4) (kv heads < tp) and (2, 2), both backends:
  greedy tokens equal to the JAX ``api.compile(..., mesh=)`` session's and
  to its ``make_serve_step`` loop's, with requests retiring and admitted
  mid-flight; the port's 1 x 1 session gives the same tokens.
* Module checks on (1, 2) and (1, 4) against the JAX functions under
  ``shard_map``: ``kv_to_seq_sharded``'s shards (all_to_all and
  gather-and-slice), ``gqa_decode``'s per-rank output and cache writes,
  the vocab-parallel ``embed_tokens``, every parameter's rank shard under
  ``model_specs``, and ``combine_partials(axis_name=)`` against the stacked
  form. Tolerance: ``rtol=1e-6`` with ``atol`` 1e-6 of the reference's
  largest magnitude, in float32 (the ranks add in rank order, XLA's CPU
  collectives in their own).
* The port alone: sampled streams actors ≡ monolithic on (1, 2) and
  repeatable by seed, collective stats in ``last_stats``, ``cache="paged"``
  on a mesh raising the reference's error, ``stage_meshes=``, an
  indivisible ``cache_len`` or ``group_size`` and a frontend arch's
  classic loop on a mesh refused (reduced mamba2 serves there; MLA + MoE
  and hybrids too, in ``test_torch_deepseek_mesh.py``),
  a stage's ``chunk`` equal to its decode loop on (2, 2), and ``Boxer``'s
  transitions and shortcuts on (2, 2).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.model_zoo import build_model as jax_build  # noqa: E402
from repro.train.steps import plan_from_mesh  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.lowering import StageParams, _shard_copy  # noqa: E402
from repro_torch.core.mesh import spmd  # noqa: E402
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.kernels.flash_decode.ref import combine_partials  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import MeshPlan  # noqa: E402
from repro_torch.models.convert import jax_leaves, params_from_jax  # noqa: E402
from repro_torch.serve.sampler import SamplingSpec  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
CPU = "cpu"
TOL = 1e-6

#: constants both processes read
SHARED = r'''
PROMPT_LEN = 8
GENS = [3, 6, 2, 5, 4, 1]        # unequal: requests retire mid-flight
CACHE_LEN = 24                   # divisible by every tp below
GEOMETRY = dict(num_groups=2, group_size=2, max_prompt_len=PROMPT_LEN,
                max_new_tokens=max(GENS), cache_len=CACHE_LEN)
MESHES = [(1, 2), (2, 1), (1, 4), (2, 2)]
MODULE_MESHES = [(1, 2), (1, 4)]


def tag(shape):
    return f"{shape[0]}x{shape[1]}"
'''
exec(SHARED)

JAX_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
out_dir = sys.argv[2]
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import api
from repro.compat import shard_map
from repro.configs.registry import get_config
from repro.kernels.flash_decode.ref import combine_partials
from repro.models import attention as A, transformer as T
from repro.models.model_zoo import build_model
from repro.train.steps import (greedy_from_logits, make_serve_step,
                               plan_from_mesh)
exec(open(os.path.join(out_dir, "shared.py")).read())
inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                          vocab_size=1000)


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


params = build_model(cfg, plan_from_mesh(mesh_of((1, 1)))).init(
    jax.random.PRNGKey(0))
prompts = list(inp["prompts"])
res = {}

for shape in MESHES:
    mesh = mesh_of(shape)
    for backend in ("actors", "monolithic"):
        kw = dict(stages=2) if backend == "actors" else {}
        sess = api.compile(cfg, mode="serve", backend=backend, params=params,
                           mesh=mesh, **kw, **GEOMETRY)
        outs = sess.generate(list(zip(prompts, GENS)))
        res[f"mid_{tag(shape)}_{backend}"] = np.asarray(
            sess.last_stats["admitted_mid_flight"])
        sess.close()
        for i, o in enumerate(outs):
            res[f"tok_{tag(shape)}_{backend}_{i}"] = np.asarray(o)
    # the reference's own loop: one batch prefill, then greedy decode steps
    ss = make_serve_step(cfg, mesh, cache_len=CACHE_LEN)
    h_last, caches = ss.prefill_fn(params, {"tokens": jnp.asarray(
        np.stack(prompts), jnp.int32)})
    tok = greedy_from_logits(ss.logits_fn(params, h_last), cfg.vocab_size)
    rows, pos = [np.asarray(tok)], jnp.full((len(prompts),), PROMPT_LEN,
                                            jnp.int32)
    for _ in range(max(GENS) - 1):
        logits, caches = ss.decode_fn(params, caches, tok, pos)
        tok = greedy_from_logits(logits, cfg.vocab_size)
        rows.append(np.asarray(tok))
        pos = pos + 1
    res[f"loop_{tag(shape)}"] = np.stack(rows, 1)

p_attn = jax.tree.map(lambda a: a[0], params["body"][0]["attn"])
for shape in MODULE_MESHES:
    mesh, t = mesh_of(shape), tag(shape)
    plan = plan_from_mesh(mesh)
    rep = P()
    # S(head) -> S(seq): the kv heads each rank holds, laid side by side
    kv = lambda k, v: A.kv_to_seq_sharded(k, v, cfg, plan, CACHE_LEN)
    ck, cv = jax.jit(shard_map(
        kv, mesh=mesh, in_specs=(P(None, None, "model"),) * 2,
        out_specs=(P(None, "model"),) * 2, check=False))(
        inp[f"kv_k_{t}"], inp[f"kv_v_{t}"])
    res[f"kv_k_{t}"], res[f"kv_v_{t}"] = np.asarray(ck), np.asarray(cv)

    def dec(p, x, ck, cv, pos):
        y, ck, cv, _ = A.gqa_decode(p, x, ck, cv, pos, cfg, plan)
        return y[None], ck, cv
    seq = P(None, "model")
    y, ck, cv = jax.jit(shard_map(
        dec, mesh=mesh, in_specs=(A.gqa_specs(cfg, plan), rep, seq, seq, rep),
        out_specs=(P("model"), seq, seq), check=False))(
        p_attn, inp["dec_x"], inp["dec_k"], inp["dec_v"], inp["dec_pos"])
    res[f"dec_y_{t}"] = np.asarray(y)
    res[f"dec_k_{t}"], res[f"dec_v_{t}"] = np.asarray(ck), np.asarray(cv)

    res[f"emb_{t}"] = np.asarray(jax.jit(shard_map(
        lambda E, i: T.embed_tokens(E, i, plan), mesh=mesh,
        in_specs=(P("model", None), rep), out_specs=rep, check=False))(
        params["embed"], inp["emb_ids"]))

    specs = T.model_specs(cfg, plan)
    placed = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(
        mesh, s)), params, specs, is_leaf=lambda s: isinstance(s, P))
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        by_dev = {s.device: np.asarray(s.data)
                  for s in leaf.addressable_shards}
        for r, d in enumerate(mesh.devices.flat):
            res[f"shard_{t}_{key}_{r}"] = by_dev[d]

    m, l, acc = inp[f"cp_m_{t}"], inp[f"cp_l_{t}"], inp[f"cp_acc_{t}"]
    res[f"cp_stacked_{t}"] = np.asarray(combine_partials(m, l, acc))
    res[f"cp_axis_{t}"] = np.asarray(jax.jit(shard_map(
        lambda m, l, a: combine_partials(m[0, 0], l[0, 0], a[0, 0],
                                         axis_name="model"),
        mesh=mesh, in_specs=(P(None, "model"),) * 3, out_specs=rep,
        check=False))(m[None], l[None], acc[None]))

try:
    api.compile(cfg, mode="serve", params=params, mesh=mesh_of((1, 2)),
                cache="paged", **GEOMETRY)
except ValueError as exc:
    res["paged_error"] = np.asarray(str(exc))
np.savez(os.path.join(out_dir, "jax.npz"), **res)
print("JAX-OK")
"""


def _cfg():
    return dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                               vocab_size=1000)


def _inputs(cfg):
    """Seeded numpy inputs of both sides."""
    rng = np.random.default_rng(11)
    f32 = np.float32
    KV, hd, d = cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    out = {"prompts": rng.integers(0, cfg.vocab_size,
                                   (len(GENS), PROMPT_LEN)).astype(np.int32)}
    for shape in MODULE_MESHES:
        t, tp = tag(shape), shape[1]
        n_kv = max(KV // tp, 1)
        # the heads rank m holds: its S(head) block, or its group's head
        heads = [(m * KV) // tp + j for m in range(tp) for j in range(n_kv)]
        for name in ("k", "v"):
            full = rng.normal(size=(1, PROMPT_LEN, KV, hd)).astype(f32)
            out[f"kv_{name}_{t}"] = full[:, :, heads]
        # partials of tp cache shards, the last one wholly masked (the
        # kernel's finite sentinel: m = -1e30, l = L, acc = sum of v)
        B, H, L = 2, cfg.num_heads, 6
        m = rng.normal(size=(tp, B, H)).astype(f32)
        m[-1] = -1e30
        lv = rng.uniform(1.0, 3.0, (tp, B, H)).astype(f32)
        lv[-1] = L
        out[f"cp_m_{t}"], out[f"cp_l_{t}"] = m, lv
        out[f"cp_acc_{t}"] = rng.normal(size=(tp, B, H, hd)).astype(f32)
    out["dec_x"] = rng.normal(size=(2, 1, d)).astype(f32)
    for name in ("k", "v"):
        out[f"dec_{name}"] = rng.normal(
            size=(2, CACHE_LEN, KV, hd)).astype(f32)
    out["dec_pos"] = np.array([3, 13], np.int32)   # rank 0's and a later one
    out["emb_ids"] = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def env():
    cfg_t = _cfg()
    cfg_j = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                                vocab_size=1000)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    params = jax.device_get(jax_build(cfg_j, plan_from_mesh(mesh)).init(
        jax.random.PRNGKey(0)))
    return cfg_t, params, params_from_jax(params, cfg_t)


@pytest.fixture(scope="module")
def jax_side(env, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_serve_mesh")
    inputs = _inputs(env[0])
    (out / "shared.py").write_text(SHARED)
    np.savez(out / "inputs.npz", **inputs)
    run_env = dict(os.environ, JAX_PLATFORMS="cpu")
    run_env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", JAX_CODE, SRC, str(out)],
                          env=run_env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0 and "JAX-OK" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:])
    return inputs, dict(np.load(out / "jax.npz"))


def _mesh(shape):
    return Placement(("data", "model"), shape).to_mesh(CPU, timeout=60.0)


def _session(env, backend, mesh, **kw):
    extra = dict(stages=2) if backend == "actors" else {}
    return api.compile(env[0], mode="serve", backend=backend, params=env[2],
                       mesh=mesh, device=CPU, **extra, **GEOMETRY, **kw)


@pytest.fixture(scope="module")
def port_tokens(env, jax_side):
    prompts = list(jax_side[0]["prompts"])
    out = {}
    for shape in [(1, 1)] + MESHES:
        for backend in ("actors", "monolithic"):
            mesh = None if shape == (1, 1) else _mesh(shape)
            with _session(env, backend, mesh) as sess:
                out[(shape, backend)] = (sess.generate(
                    list(zip(prompts, GENS))), dict(sess.last_stats))
    return out


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        torch.as_tensor(got).numpy(), want, rtol=TOL,
        atol=TOL * max(float(np.abs(want).max()), 1e-30), err_msg=what)


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["actors", "monolithic"])
@pytest.mark.parametrize("shape", MESHES, ids=[tag(s) for s in MESHES])
def test_tokens_match_the_jax_session_and_loop(jax_side, port_tokens, shape,
                                               backend):
    _, jx = jax_side
    got, stats = port_tokens[(shape, backend)]
    loop = jx[f"loop_{tag(shape)}"]
    assert [len(o) for o in got] == GENS
    for i, (g, n) in enumerate(zip(got, GENS)):
        want = jx[f"tok_{tag(shape)}_{backend}_{i}"]
        assert np.array_equal(g, want), f"request {i}: port {g} != jax {want}"
        assert np.array_equal(g, loop[i, :n]), f"request {i}: vs the loop"
    assert stats["admitted_mid_flight"] >= 1
    assert stats["admitted_mid_flight"] == int(
        jx[f"mid_{tag(shape)}_{backend}"])
    assert stats["tokens"] == sum(GENS)


@pytest.mark.parametrize("shape", MESHES, ids=[tag(s) for s in MESHES])
def test_backends_and_one_device_agree(port_tokens, shape):
    one, _ = port_tokens[((1, 1), "monolithic")]
    a, sa = port_tokens[(shape, "actors")]
    b, sb = port_tokens[(shape, "monolithic")]
    for x, y, z in zip(a, b, one):
        assert np.array_equal(x, y) and np.array_equal(x, z)
    for key in ("prefill_items", "decode_items", "rounds"):
        assert sa[key] == sb[key]
    # the collectives the ranks made, the same on both backends
    assert sa["collectives"]["calls"] == sb["collectives"]["calls"]
    assert sa["collectives"]["seconds"] >= 0.0
    if shape[1] > 1:
        assert sa["collectives"]["calls"]["pmax"] > 0
        assert sa["collectives"]["bytes"]["psum"] > 0


# ---------------------------------------------------------------------------
# modules against the JAX functions
# ---------------------------------------------------------------------------

def _plan(shape):
    return MeshPlan(("data", "model"), shape)


@pytest.mark.parametrize("shape", MODULE_MESHES,
                         ids=[tag(s) for s in MODULE_MESHES])
def test_kv_to_seq_sharded(env, jax_side, shape):
    """KV = 2 >= tp = 2: the all_to_all; KV = 2 < tp = 4: the group
    gather-and-slice. Each rank's block, contiguous, is the JAX one's."""
    inp, jx = jax_side
    cfg, t, tp = env[0], tag(shape), shape[1]
    plan, mesh = _plan(shape), _mesh(shape)
    n_kv = A.kv_heads_local(cfg, plan)
    k, v = (torch.from_numpy(inp[f"kv_{n}_{t}"]) for n in "kv")

    def rank(r):
        hs = slice(r * n_kv, (r + 1) * n_kv)
        return A.kv_to_seq_sharded(k[:, :, hs], v[:, :, hs], cfg, plan,
                                   CACHE_LEN)
    L = CACHE_LEN // tp
    for r, (ck, cv) in enumerate(spmd(rank, mesh)(list(range(tp)))):
        assert ck.is_contiguous() and cv.is_contiguous()
        assert ck.shape == (1, L, cfg.num_kv_heads, cfg.head_dim)
        _close(ck, jx[f"kv_k_{t}"][:, r * L:(r + 1) * L], f"k rank {r}")
        _close(cv, jx[f"kv_v_{t}"][:, r * L:(r + 1) * L], f"v rank {r}")


def _rank_blocks(env, shape):
    """Each rank's shard of layer 0, cut as the serve lowering cuts it."""
    cfg, _, state = env
    plan = _plan(shape)
    with torch.device("meta"):
        model = T.Transformer(cfg, plan)
    model.load_state_dict(state, assign=True)
    whole = StageParams([model.blocks[0]])
    mesh = _mesh(shape)
    return [_shard_copy(whole, torch.float32, cfg, plan, mesh.coords(r),
                        CPU).blocks[0] for r in range(mesh.size)]


@pytest.mark.parametrize("shape", MODULE_MESHES,
                         ids=[tag(s) for s in MODULE_MESHES])
def test_gqa_decode_per_rank(env, jax_side, shape):
    """The new token's k/v land in the owning shard only; each rank's
    P(sum) output projection equals the JAX rank's, a wholly masked shard
    (pos 3 on every rank but 0) weighing nothing in the combine."""
    inp, jx = jax_side
    cfg, t, tp = env[0], tag(shape), shape[1]
    plan, mesh = _plan(shape), _mesh(shape)
    blocks = _rank_blocks(env, shape)
    L = CACHE_LEN // tp
    x = torch.from_numpy(inp["dec_x"])
    pos = torch.from_numpy(inp["dec_pos"])
    caches = [[torch.from_numpy(inp[f"dec_{n}"][:, r * L:(r + 1) * L]).clone()
               for n in "kv"] for r in range(tp)]

    def rank(r):
        with torch.inference_mode():
            return A.gqa_decode(blocks[r].attn, x, *caches[r], pos, cfg, plan)
    ys = spmd(rank, mesh)(list(range(tp)))
    for r in range(tp):
        _close(ys[r], jx[f"dec_y_{t}"][r], f"output rank {r}")
        _close(caches[r][0], jx[f"dec_k_{t}"][:, r * L:(r + 1) * L],
               f"k cache rank {r}")
        _close(caches[r][1], jx[f"dec_v_{t}"][:, r * L:(r + 1) * L],
               f"v cache rank {r}")
    # the write went where the position lives, nowhere else
    for r in range(tp):
        changed = (caches[r][0] != torch.from_numpy(
            inp["dec_k"][:, r * L:(r + 1) * L])).any(dim=(2, 3))
        owned = [(b, int(p) - r * L) for b, p in enumerate(inp["dec_pos"])
                 if r * L <= p < (r + 1) * L]
        assert sorted(map(tuple, changed.nonzero().tolist())) == owned


@pytest.mark.parametrize("shape", MODULE_MESHES,
                         ids=[tag(s) for s in MODULE_MESHES])
def test_vocab_parallel_embedding(env, jax_side, shape):
    inp, jx = jax_side
    cfg, state = env[0], env[2]
    plan, mesh = _plan(shape), _mesh(shape)
    ids = torch.from_numpy(inp["emb_ids"])
    shards = [T.shard_params(state, cfg, plan, mesh.coords(r))["embed"]
              for r in range(mesh.size)]
    outs = spmd(lambda r: T.embed_tokens(shards[r], ids, plan), mesh)(
        list(range(mesh.size)))
    for out in outs:
        _close(out, jx[f"emb_{tag(shape)}"])
        assert torch.equal(out, outs[0])
    assert torch.equal(outs[0], state["embed"][ids.long()])


@pytest.mark.parametrize("shape", MODULE_MESHES,
                         ids=[tag(s) for s in MODULE_MESHES])
def test_rank_shards_equal_the_jax_shards(env, jax_side, shape):
    """Every leaf of the converted state, cut by the port's ``model_specs``
    for each rank, equals the JAX package's shard of that leaf under its
    ``model_specs`` on the rank's device (body leaves: per period)."""
    _, jx = jax_side
    cfg, state = env[0], env[2]
    plan, mesh = _plan(shape), _mesh(shape)
    per_rank = [T.shard_params(state, cfg, plan, mesh.coords(r))
                for r in range(mesh.size)]
    seen = 0
    for path, names in jax_leaves(cfg):
        key = "/".join(map(str, path))
        for r in range(mesh.size):
            want = jx[f"shard_{tag(shape)}_{key}_{r}"]
            if path[0] != "body":
                want = want[None]
            for i, name in enumerate(names):
                assert np.array_equal(per_rank[r][name].numpy(), want[i]), (
                    name, r)
                seen += 1
    assert seen == len(state) * mesh.size


@pytest.mark.parametrize("shape", MODULE_MESHES,
                         ids=[tag(s) for s in MODULE_MESHES])
def test_combine_partials_across_ranks(jax_side, shape):
    inp, jx = jax_side
    t, tp = tag(shape), shape[1]
    mesh = _mesh(shape)
    m, l, acc = (torch.from_numpy(inp[f"cp_{n}_{t}"])
                 for n in ("m", "l", "acc"))
    outs = spmd(lambda r: combine_partials(m[r], l[r], acc[r],
                                           axis_name="model"), mesh)(
        list(range(tp)))
    stacked = combine_partials(m, l, acc)
    for out in outs:
        assert torch.equal(out, outs[0])
        _close(out, stacked)
        _close(out, jx[f"cp_axis_{t}"])
    _close(stacked, jx[f"cp_stacked_{t}"])
    # the masked shard weighs 0: the combine of the others alone
    _close(outs[0], combine_partials(m[:-1], l[:-1], acc[:-1]))


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def test_sampled_streams_on_a_mesh(env, jax_side):
    prompts = list(jax_side[0]["prompts"])
    reqs = list(zip(prompts, GENS))
    spec = dict(temperature=0.8, top_k=50, top_p=0.95)
    runs = {}
    for backend, seed in (("actors", 1), ("monolithic", 1), ("actors", 2)):
        with _session(env, backend, _mesh((1, 2)),
                      sampling=SamplingSpec(seed=seed, **spec)) as sess:
            runs[(backend, seed)] = sess.generate(reqs)
    a, b = runs[("actors", 1)], runs[("monolithic", 1)]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    with _session(env, "actors", _mesh((1, 2)),
                  sampling=SamplingSpec(seed=1, **spec)) as sess:
        assert all(np.array_equal(x, y)
                   for x, y in zip(sess.generate(reqs), a))
    assert not all(np.array_equal(x, y)
                   for x, y in zip(runs[("actors", 2)], a))
    assert all((o >= 0).all() and (o < 1000).all() for o in a)


def test_paged_on_a_mesh_raises_the_reference_error(env, jax_side):
    want = str(jax_side[1]["paged_error"])
    assert "1x1 mesh" in want
    with pytest.raises(ValueError) as exc:
        _session(env, "actors", _mesh((1, 2)), cache="paged")
    assert str(exc.value) == want


def test_mesh_options_are_checked(env):
    with pytest.raises(ValueError, match="stage_meshes"):
        api.compile(env[0], mode="serve", device=CPU,
                    stage_meshes=[_mesh((1, 2))] * 2, **GEOMETRY)
    with pytest.raises(ValueError, match="divisible by the model-parallel"):
        api.compile(env[0], mode="serve", device=CPU, mesh=_mesh((1, 4)),
                    **dict(GEOMETRY, cache_len=26))
    with pytest.raises(ValueError, match="divisible by the data-parallel"):
        api.compile(env[0], mode="serve", device=CPU, mesh=_mesh((2, 1)),
                    **dict(GEOMETRY, group_size=3))
    # the default cache_len rounds up to a multiple of tp, as the reference
    sess = api.compile(env[0], mode="serve", device=CPU, mesh=_mesh((1, 4)),
                       max_prompt_len=8, max_new_tokens=6)
    assert sess.cache_len == 24 and "tp=4" in sess.describe()
    # the dense reservation over the ranks: each holds 1 / tp of it
    with api.compile(env[0], mode="serve", device=CPU,
                     max_prompt_len=8, max_new_tokens=6,
                     cache_len=24) as one:
        assert sess.cache_bytes() == one.cache_bytes()
    # Mamba stacks serve on a mesh too (they raised naming item 8c before;
    # tests/test_torch_mamba_mesh.py holds them to the JAX sessions), with
    # the paged cache refused there as for dense stacks; hybrids serve
    # there too (tests/test_torch_deepseek_mesh.py), and so does a frontend
    # arch's classic loop (tests/test_torch_frontend_mesh.py holds it to
    # the JAX package), whose cache_len must split over the model axis
    cfg_m = get_config("mamba2-370m").reduced()
    with api.compile(cfg_m, mode="serve", device=CPU, mesh=_mesh((1, 2)),
                     max_prompt_len=8, max_new_tokens=2) as sess:
        assert "tp=2" in sess.describe()
        assert [len(o) for o in sess.generate(
            [(np.arange(5, dtype=np.int32), 2)])] == [2]
    with pytest.raises(ValueError, match="requires a 1x1 mesh"):
        api.compile(cfg_m, mode="serve", device=CPU, mesh=_mesh((1, 2)),
                    cache="paged", max_prompt_len=8, max_new_tokens=2)
    from repro_torch.train.steps import make_serve_step
    ss = make_serve_step(get_config("whisper-medium").reduced(),
                         _plan((1, 2)), cache_len=24, device=CPU)
    caches = ss.init_caches_fn(np.zeros(2, np.int32))
    assert len(caches) == 2 and caches[1][0]["k"].shape[1] == 12
    with pytest.raises(ValueError, match="does not split over tp = 2"):
        make_serve_step(get_config("whisper-medium").reduced(),
                        _plan((1, 2)), cache_len=25, device=CPU)


def test_boxer_transitions_and_shortcuts():
    """``Boxer`` on a (2, 2) mesh: an SBP transition through ``boxing_fn``
    and the model code's shortcuts (psum over ``model`` or ``data``,
    all-gather over ``model``), each against the global tensor."""
    from repro_torch.core.mesh import place
    from repro_torch.models.common import Boxer
    mesh, bx = _mesh((2, 2)), Boxer(_plan((2, 2)))
    x = torch.arange(32.0).reshape(4, 8)
    shards = place(x, mesh, "S(0),S(1)")
    outs = spmd(lambda r: (bx(shards[r], "S(0),S(1)", "B,B"),
                           bx.psum_model(shards[r]), bx.psum_data(shards[r]),
                           bx.allgather_model(shards[r], 1)), mesh)(
        list(range(4)))
    for r, (full, pm, pd, ag) in enumerate(outs):
        d, m = mesh.coords(r)
        rows, cols = slice(2 * d, 2 * d + 2), slice(4 * m, 4 * m + 4)
        assert torch.equal(full, x)
        assert torch.equal(ag, x[rows])
        assert torch.equal(pm, x[rows, :4] + x[rows, 4:])
        assert torch.equal(pd, x[:2, cols] + x[2:, cols])
    one = Boxer(MeshPlan.single_device())
    assert one.psum_model(x) is x and one.allgather_model(x, 0) is x


def test_chunk_is_the_decode_loop_on_a_mesh(env):
    """A stage's ``chunk`` on a (2, 2) mesh is its ``decode`` looped over
    the chunk axis: the same logits and the same per-rank caches, the
    hidden passed between the stages as per-rank lists."""
    with _session(env, "actors", _mesh((2, 2))) as sess:
        stages = sess.sstaged.stages
        B = GEOMETRY["group_size"]
        toks = torch.tensor([[5, 7], [9, 11], [13, 15]], dtype=torch.int32)
        pos0 = torch.tensor([0, 4], dtype=torch.int32)
        adv = torch.tensor([1, 1], dtype=torch.int32)
        with torch.inference_mode():
            chunked = [st.init_caches(B) for st in stages]
            looped = [st.init_caches(B) for st in stages]
            x = toks
            for st, caches in zip(stages, chunked):
                x, _ = st.chunk(st.params, caches, x, pos0, adv)
            steps = []
            for t in range(toks.shape[0]):
                y = toks[t]
                for st, caches in zip(stages, looped):
                    y, _ = st.decode(st.params, caches, y, pos0 + t * adv)
                steps.append(y)
    assert x.shape == (3, B, env[0].padded_vocab())
    assert torch.equal(x, torch.stack(steps))
    for a, b in zip(chunked, looped):
        for ra, rb in zip(a, b):            # ranks
            for la, lb in zip(ra, rb):      # layers
                assert all(torch.equal(la[k], lb[k]) for k in ("k", "v"))
