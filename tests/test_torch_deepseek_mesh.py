"""MLA and MoE on a mesh of ranks: deepseek-v2-lite (and the hybrid jamba)
served with heads and experts split over ``model``.

Holds ``repro_torch.api.compile(cfg, mode="serve", mesh=...)`` to the JAX
package on reduced deepseek-v2-lite-16b with ``vocab_size=1000`` (a dense
layer, then MLA with 4 heads and an MoE of 4 experts top-2 plus 2 shared,
float32), from the JAX init carried over by ``params_from_jax``. As in
``test_torch_serve_mesh.py`` the JAX side runs once per module in a
subprocess with 8 host devices and Auto mesh axes, from the code below,
and writes ``.npz`` results; the port runs in process on the CPU, every
rank a thread.

* On (1, 2), (2, 1), (2, 2) and (1, 4), both backends: greedy tokens equal
  to the JAX mesh session's, with requests retiring and admitted
  mid-flight (at the reduced capacity factor 8 no expert drops a token,
  so the reference's parked slots, which compete for capacity in its
  dense serving, change nothing); the port's 1 x 1 session gives the same
  tokens, and every compile's static check passes.
* Module checks on (1, 2) and (1, 4) against the JAX functions under
  ``shard_map``: each rank's ``moe_forward`` P(sum) partial and its aux at
  capacity factors 8 and 1.0 (where tokens drop), with tokens whose pick
  of the rank's column-0 expert sits beside another rank's pick (a plain
  scatter into the affinity matrix would zero that gate); each rank's
  ``mla_forward`` and ``mla_decode`` partial at its local heads, and the
  replicated latent cache written alike on every rank. Tolerance: float32
  ``rtol=1e-6`` with ``atol`` 1e-6 of the reference's largest magnitude
  for the MoE, its aux and the latent cache, as in
  ``test_torch_serve_mesh.py``; the MLA outputs at ``rtol=1e-5`` with
  ``atol`` 1e-5 of the reference's largest magnitude (the attention's
  softmax is blocked differently in the two packages; measured at most
  5.6e-6 of it).
* Each rank's decode caches have the reference's per-rank shapes, and the
  per-rank weight count (``membound.serve_param_bound``: E / tp expert
  stacks, the replicated latent projection) is what each rank's stage
  holds.
* Reduced jamba (Mamba-2 and an MoE) on (1, 2), both backends: each
  request's tokens equal to the JAX mesh session serving it alone (the
  reference's dense serving lets a parked slot reach the live ones, ROADMAP
  Queue 3; the port keeps parked rows inert).
* ``cache="paged"`` on a mesh raises the reference's error; the launcher
  serves deepseek on a 1x2 mesh.
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
from repro.models.common import MeshPlan as JaxMeshPlan  # noqa: E402
from repro.models.model_zoo import build_model as jax_build  # noqa: E402
from repro.models.model_zoo import \
    make_decode_caches as jax_make_caches  # noqa: E402
from repro.train.steps import plan_from_mesh  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.analysis import membound  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.lowering import StageParams, _shard_copy  # noqa: E402
from repro_torch.core.mesh import spmd  # noqa: E402
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.models.common import MeshPlan  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model_zoo import (cache_specs,  # noqa: E402
                                          make_decode_caches)
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim.zero import local_shape_of  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
CPU = "cpu"
ARCH, JAMBA = "deepseek-v2-lite-16b", "jamba-v0.1-52b"
TOL = 1e-6
MLA_TOL = 1e-5

#: constants both processes read
SHARED = r'''
PROMPT_LEN = 8
GENS = [3, 6, 2, 5, 4, 1]        # unequal: requests retire mid-flight
CACHE_LEN = 24                   # divisible by every tp below
GEOMETRY = dict(num_groups=2, group_size=2, max_prompt_len=PROMPT_LEN,
                max_new_tokens=max(GENS), cache_len=CACHE_LEN)
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
MODULE_MESHES = [(1, 2), (1, 4)]
FACTORS = [8.0, 1.0]
MOE_SHAPE = (2, 9)               # (B, S) of the MoE's input: 18 tokens
MLA_S = 12
DEC_B, DEC_L = 3, 20
JAMBA_GENS = [3, 5, 2, 4, 1, 6]


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
from jax.sharding import PartitionSpec as P
from repro import api
from repro.compat import shard_map
from repro.configs.registry import get_config
from repro.models import attention as A, mlp as MLP
from repro.models.model_zoo import build_model
from repro.train.steps import plan_from_mesh
exec(open(os.path.join(out_dir, "shared.py")).read())
inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(),
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
try:
    api.compile(cfg, mode="serve", params=params, mesh=mesh_of((1, 2)),
                cache="paged", **GEOMETRY)
except ValueError as exc:
    res["paged_error"] = np.asarray(str(exc))

layer = jax.tree.map(lambda a: a[0], jax.device_get(params)["body"][0])
rep, heads = P(), P("model")
for shape in MODULE_MESHES:
    mesh, t = mesh_of(shape), tag(shape)
    plan = plan_from_mesh(mesh)
    for f in FACTORS:
        cfg_f = dataclasses.replace(cfg, capacity_factor=f)

        def moe(p, x, cfg_f=cfg_f):
            y, aux = MLP.moe_forward(p, x, cfg_f, plan)
            return y[None], aux[None]
        y, aux = jax.jit(shard_map(
            moe, mesh=mesh, in_specs=(MLP.moe_specs(cfg, plan), rep),
            out_specs=(heads, heads), check=False))(layer["moe"],
                                                     inp["moe_x"])
        res[f"moe_y_{t}_{f}"], res[f"moe_aux_{t}_{f}"] = (np.asarray(y),
                                                          np.asarray(aux))
    specs = A.mla_specs(cfg, plan)

    def fwd(p, x, pos):
        y, (c, kpe) = A.mla_forward(p, x, cfg, plan, pos)
        return y[None], c[None], kpe[None]
    y, c, kpe = jax.jit(shard_map(
        fwd, mesh=mesh, in_specs=(specs, rep, rep),
        out_specs=(heads,) * 3, check=False))(
        layer["attn"], inp["mla_x"], np.arange(MLA_S))
    res[f"mla_y_{t}"], res[f"mla_c_{t}"], res[f"mla_kpe_{t}"] = map(
        np.asarray, (y, c, kpe))

    def dec(p, x, c, kpe, pos):
        y, c, kpe = A.mla_decode(p, x, c, kpe, pos, cfg, plan)
        return y[None], c[None], kpe[None]
    y, c, kpe = jax.jit(shard_map(
        dec, mesh=mesh, in_specs=(specs, rep, rep, rep, rep),
        out_specs=(heads,) * 3, check=False))(
        layer["attn"], inp["dec_x"], inp["dec_c"], inp["dec_kpe"],
        inp["dec_pos"])
    res[f"dec_y_{t}"], res[f"dec_c_{t}"], res[f"dec_kpe_{t}"] = map(
        np.asarray, (y, c, kpe))

# reduced jamba on (1, 2), each request served alone
cfg_j = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(),
                            vocab_size=1000)
params_j = build_model(cfg_j, plan_from_mesh(mesh_of((1, 1)))).init(
    jax.random.PRNGKey(1))
sess = api.compile(cfg_j, mode="serve", backend="monolithic",
                   params=params_j, mesh=mesh_of((1, 2)), **GEOMETRY)
for i, request in enumerate(zip(prompts, JAMBA_GENS)):
    res[f"jamba_alone_{i}"] = np.asarray(sess.generate([request])[0])
sess.close()
np.savez(os.path.join(out_dir, "jax.npz"), **res)
print("JAX-OK")
"""


def _cfg(arch=ARCH):
    return dataclasses.replace(get_config(arch).reduced(), vocab_size=1000)


def _inputs(cfg):
    """Seeded numpy inputs of both sides."""
    rng = np.random.default_rng(17)
    f32 = np.float32
    d = cfg.d_model
    return {"prompts": rng.integers(0, cfg.vocab_size,
                                    (len(GENS), PROMPT_LEN)).astype(np.int32),
            "moe_x": rng.normal(size=(*MOE_SHAPE, d)).astype(f32),
            "mla_x": rng.normal(size=(2, MLA_S, d)).astype(f32),
            "dec_x": rng.normal(size=(DEC_B, 1, d)).astype(f32),
            "dec_c": rng.normal(size=(DEC_B, DEC_L, cfg.kv_lora_rank)
                                ).astype(f32),
            "dec_kpe": rng.normal(size=(DEC_B, DEC_L, cfg.qk_rope_head_dim)
                                  ).astype(f32),
            "dec_pos": np.array([0, 9, DEC_L - 1], np.int32)}


def _jax_state(arch, seed, cfg_t):
    cfg_j = dataclasses.replace(jax_get_config(arch).reduced(),
                                vocab_size=1000)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    params = jax.device_get(jax_build(cfg_j, plan_from_mesh(mesh)).init(
        jax.random.PRNGKey(seed)))
    return params_from_jax(params, cfg_t)


@pytest.fixture(scope="module")
def env():
    cfg_t, cfg_jamba = _cfg(), _cfg(JAMBA)
    return dict(cfg=cfg_t, state=_jax_state(ARCH, 0, cfg_t),
                jamba_cfg=cfg_jamba, jamba_state=_jax_state(JAMBA, 1,
                                                            cfg_jamba))


@pytest.fixture(scope="module")
def jax_side(env, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_deepseek_mesh")
    inputs = _inputs(env["cfg"])
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


def _plan(shape):
    return MeshPlan(("data", "model"), shape)


def _session(cfg, state, backend, mesh, stages=2, **kw):
    extra = dict(stages=stages) if backend == "actors" else {}
    return api.compile(cfg, mode="serve", backend=backend, params=state,
                       mesh=mesh, device=CPU, **extra, **GEOMETRY, **kw)


@pytest.fixture(scope="module")
def port_tokens(env, jax_side):
    prompts = list(jax_side[0]["prompts"])
    out = {}
    for shape in [(1, 1)] + MESHES:
        for backend in ("actors", "monolithic"):
            mesh = None if shape == (1, 1) else _mesh(shape)
            with _session(env["cfg"], env["state"], backend, mesh) as sess:
                out[(shape, backend)] = (sess.generate(
                    list(zip(prompts, GENS))), dict(sess.last_stats),
                    sess.static_report.verdict)
    return out


def _close(got, want, what="", rtol=TOL, scale=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(
        torch.as_tensor(got).numpy(), want, rtol=rtol,
        atol=scale * max(float(np.abs(want).max()), 1e-30), err_msg=what)


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["actors", "monolithic"])
@pytest.mark.parametrize("shape", MESHES, ids=[tag(s) for s in MESHES])
def test_tokens_match_the_jax_mesh_session(jax_side, port_tokens, shape,
                                           backend):
    _, jx = jax_side
    got, stats, verdict = port_tokens[(shape, backend)]
    assert verdict == "PASS"
    assert [len(o) for o in got] == GENS
    for i, g in enumerate(got):
        want = jx[f"tok_{tag(shape)}_{backend}_{i}"]
        assert np.array_equal(g, want), f"request {i}: port {g} != jax {want}"
    assert stats["admitted_mid_flight"] >= 1
    assert stats["admitted_mid_flight"] == int(
        jx[f"mid_{tag(shape)}_{backend}"])
    assert stats["tokens"] == sum(GENS)


@pytest.mark.parametrize("shape", MESHES, ids=[tag(s) for s in MESHES])
def test_backends_and_one_device_agree(port_tokens, shape):
    one, _, _ = port_tokens[((1, 1), "monolithic")]
    a, sa, _ = port_tokens[(shape, "actors")]
    b, sb, _ = port_tokens[(shape, "monolithic")]
    for x, y, z in zip(a, b, one):
        assert np.array_equal(x, y) and np.array_equal(x, z)
    for key in ("prefill_items", "decode_items", "rounds"):
        assert sa[key] == sb[key]
    # the collectives the ranks made, the same on both backends; at tp > 1
    # the branches' psums (attention, the MoE's one deferred psum, the
    # embedding) and the vocab head's gathers
    assert sa["collectives"]["calls"] == sb["collectives"]["calls"]
    if shape[1] > 1:
        assert sa["collectives"]["calls"]["psum"] > 0
        assert sa["collectives"]["bytes"]["psum"] > 0


def test_paged_on_a_mesh_raises_the_reference_error(env, jax_side):
    want = str(jax_side[1]["paged_error"])
    assert "1x1 mesh" in want
    with pytest.raises(ValueError) as exc:
        _session(env["cfg"], env["state"], "actors", _mesh((1, 2)),
                 cache="paged")
    assert str(exc.value) == want


# ---------------------------------------------------------------------------
# modules against the JAX functions under shard_map
# ---------------------------------------------------------------------------

def _rank_layers(env, shape):
    """Each rank's shard of layer 1 (MLA + MoE), cut as the serve lowering
    cuts it."""
    cfg, state = env["cfg"], env["state"]
    plan = _plan(shape)
    with torch.device("meta"):
        model = Transformer(cfg, plan)
    model.load_state_dict(state, assign=True)
    whole = StageParams([model.blocks[1]])
    mesh = _mesh(shape)
    return mesh, [_shard_copy(whole, torch.float32, cfg, plan, mesh.coords(r),
                              CPU).blocks[0] for r in range(mesh.size)]


def _column0_beside_a_remote_pick(blk, cfg, x, tp):
    """How many tokens pick, for some rank, that rank's column-0 expert
    beside another rank's expert, with the remote pick AFTER the local
    one (where a plain scatter's write of the remote pick's 0 lands
    last)."""
    t = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, idx = mlp.top_k(torch.softmax(t @ blk.moe.router, -1), cfg.top_k)
    E_loc, n = cfg.num_experts // tp, 0
    for m in range(tp):
        lo = m * E_loc
        local = (idx >= lo) & (idx < lo + E_loc)
        n += int((local[:, 0] & (idx[:, 0] == lo) & ~local[:, 1]).sum())
    return n


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("shape", MODULE_MESHES,
                         ids=[tag(s) for s in MODULE_MESHES])
def test_moe_forward_per_rank(env, jax_side, shape, factor):
    """Each rank's partial and aux equal the JAX rank's; the partials sum
    to one device's output (the capacity comes from the global token
    count, so a rank's experts keep what they keep on one device). At
    capacity factor 1.0 tokens drop (cap 9 of 18). The inputs hold tokens
    whose pick of a rank's column-0 expert sits beside another rank's
    pick; with the affinity matrix built by a plain scatter instead of a
    scatter-add, rank outputs would differ."""
    inp, jx = jax_side
    cfg = dataclasses.replace(env["cfg"], capacity_factor=factor)
    t, tp = tag(shape), shape[1]
    plan = _plan(shape)
    mesh, blocks = _rank_layers(env, shape)
    x = torch.from_numpy(inp["moe_x"])
    outs = spmd(lambda r: mlp.moe_forward(blocks[r].moe, x, cfg, plan),
                mesh)(list(range(tp)))
    for r, (y, aux) in enumerate(outs):
        _close(y, jx[f"moe_y_{t}_{factor}"][r], f"partial rank {r}")
        _close(aux, jx[f"moe_aux_{t}_{factor}"][r], f"aux rank {r}")
        assert torch.equal(aux, outs[0][1])
    with torch.device("meta"):
        model = Transformer(cfg, MeshPlan.single_device())
    model.load_state_dict(env["state"], assign=True)
    whole, aux1 = mlp.moe_forward(model.blocks[1].moe, x, cfg)
    _close(sum(y for y, _ in outs), whole.detach(), "sum of the partials",
           rtol=1e-5, scale=1e-5)
    _close(outs[0][1], aux1.detach(), "aux vs one device")
    if factor == 1.0:
        assert mlp.moe_capacity(cfg, MOE_SHAPE[0] * MOE_SHAPE[1]) == 9
    assert _column0_beside_a_remote_pick(model.blocks[1], cfg,
                                         inp["moe_x"], tp) > 0

    def scatters_agree(m):      # a plain scatter's A against the add's
        E_loc = cfg.num_experts // tp
        tt = x.reshape(-1, cfg.d_model)
        gates, idx = mlp.top_k(torch.softmax(tt @ blocks[m].moe.router, -1),
                               cfg.top_k)
        local = (idx >= m * E_loc) & (idx < (m + 1) * E_loc)
        col = torch.where(local, idx - m * E_loc, 0)
        val = torch.where(local, gates, 0.0)
        A_ = torch.zeros((tt.shape[0], E_loc))
        return torch.equal(A_.clone().scatter_(1, col, val),
                           A_.scatter_add_(1, col, val))
    assert not all(scatters_agree(m) for m in range(tp))


@pytest.mark.parametrize("shape", MODULE_MESHES,
                         ids=[tag(s) for s in MODULE_MESHES])
def test_mla_forward_per_rank(env, jax_side, shape):
    """Each rank's output projection at its ``4 / tp`` heads (its S(1)
    columns of ``wq``, ``w_uk``, ``w_uv`` and S(0) rows of ``wo``) is the
    JAX rank's P(sum) partial; the latent ``c`` and rope key ``kpe`` are
    the same on every rank (replicated), and the partials sum to one
    device's output."""
    inp, jx = jax_side
    cfg, t, tp = env["cfg"], tag(shape), shape[1]
    plan = _plan(shape)
    mesh, blocks = _rank_layers(env, shape)
    x = torch.from_numpy(inp["mla_x"])
    pos = torch.arange(MLA_S)
    outs = spmd(lambda r: A.mla_forward(blocks[r].attn, x, cfg, plan, pos),
                mesh)(list(range(tp)))
    for r, (y, (c, kpe)) in enumerate(outs):
        _close(y, jx[f"mla_y_{t}"][r], f"partial rank {r}", MLA_TOL,
               MLA_TOL)
        _close(c, jx[f"mla_c_{t}"][r], f"c rank {r}")
        _close(kpe, jx[f"mla_kpe_{t}"][r], f"kpe rank {r}")
        assert torch.equal(c, outs[0][1][0]) and torch.equal(
            kpe, outs[0][1][1])
    with torch.device("meta"):
        model = Transformer(cfg, MeshPlan.single_device())
    model.load_state_dict(env["state"], assign=True)
    whole, _ = A.mla_forward(model.blocks[1].attn, x, cfg,
                             MeshPlan.single_device(), pos)
    _close(sum(y for y, _ in outs), whole, "sum of the partials", MLA_TOL,
           MLA_TOL)


@pytest.mark.parametrize("shape", MODULE_MESHES,
                         ids=[tag(s) for s in MODULE_MESHES])
def test_mla_decode_per_rank(env, jax_side, shape):
    """One absorbed decode step on each rank at its local heads: the
    partial equals the JAX rank's, and every rank writes the new token's
    latent and rope key into its replicated cache in place, at its
    position only, alike."""
    inp, jx = jax_side
    cfg, t, tp = env["cfg"], tag(shape), shape[1]
    plan = _plan(shape)
    mesh, blocks = _rank_layers(env, shape)
    x, pos = (torch.from_numpy(inp[k]) for k in ("dec_x", "dec_pos"))
    caches = [[torch.from_numpy(inp[k]).clone() for k in ("dec_c",
                                                         "dec_kpe")]
              for _ in range(tp)]

    def rank(r):
        with torch.inference_mode():
            return A.mla_decode(blocks[r].attn, x, *caches[r], pos, cfg, plan)
    ys = spmd(rank, mesh)(list(range(tp)))
    for r in range(tp):
        _close(ys[r], jx[f"dec_y_{t}"][r], f"partial rank {r}", MLA_TOL,
               MLA_TOL)
        _close(caches[r][0], jx[f"dec_c_{t}"][r], f"c rank {r}")
        _close(caches[r][1], jx[f"dec_kpe_{t}"][r], f"kpe rank {r}")
        assert all(torch.equal(a, b) for a, b in zip(caches[r], caches[0]))
        changed = (caches[r][0] != torch.from_numpy(inp["dec_c"])).any(-1)
        assert sorted(map(tuple, changed.nonzero().tolist())) == [
            (b, int(p)) for b, p in enumerate(inp["dec_pos"])]


@pytest.mark.parametrize("shape", MESHES, ids=[tag(s) for s in MESHES])
def test_decode_caches_and_weights_per_rank(env, shape):
    """Each rank's group cache has the shapes of the reference's
    ``make_decode_caches`` for its plan and local batch (the latent whole,
    replicated over ``model``), and those of its ``cache_specs`` over the
    global cache; ``membound.serve_param_bound`` counts the E / tp expert
    stacks and the replicated latent projection a rank's stage holds,
    exactly."""
    cfg, plan = env["cfg"], _plan(shape)
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                               vocab_size=1000)
    B = GEOMETRY["group_size"]
    ref = jax.eval_shape(lambda: jax_make_caches(
        jcfg, JaxMeshPlan(("data", "model"), shape), B // plan.dp,
        CACHE_LEN))
    ref = list(ref["prologue"]) + [
        {k: v.shape[1:] for k, v in c.items()} for c in ref["body"]]
    with torch.device("meta"):
        mine = make_decode_caches(cfg, plan, B // plan.dp, CACHE_LEN)
        whole = make_decode_caches(cfg, MeshPlan.single_device(), B,
                                   CACHE_LEN)
    specs = cache_specs(cfg, plan, ("data",))
    for got, want, full, sp in zip(mine, ref, whole, specs):
        assert set(got) == set(want) == {"c", "kpe"}
        for k, tens in got.items():
            shp = tuple(getattr(want[k], "shape", want[k]))
            assert tuple(tens.shape) == shp, (shape, k)
            assert tuple(tens.shape) == local_shape_of(full[k].shape, sp[k],
                                                       plan)
        assert got["c"].shape[1] == CACHE_LEN
    with _session(cfg, env["state"], "actors", _mesh(shape)) as sess:
        bound = membound.serve_param_bound(sess.sstaged)
        E_loc = cfg.num_experts // plan.tp
        for s, st in enumerate(sess.sstaged.stages):
            held = [sum(p.nbytes for p in rank.parameters())
                    for rank in st.params]
            assert held == [bound[f"stage{s}"]] * len(held), (s, held)
            for rank in st.params:
                for b in rank.blocks:
                    if hasattr(b, "moe"):
                        assert b.moe.w_gate.shape[0] == E_loc
                        assert b.attn.wkv_a.shape == (
                            cfg.d_model, cfg.kv_lora_rank
                            + cfg.qk_rope_head_dim)


# ---------------------------------------------------------------------------
# the hybrid, and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["actors", "monolithic"])
def test_jamba_serves_on_a_mesh(env, jax_side, backend):
    """Reduced jamba (ssm/dense, attn/moe: one stack unit, so one stage)
    on (1, 2): its SSM heads, GQA heads and experts split over ``model``;
    each request's tokens equal
    the JAX mesh session's serving it alone (the reference's parked-row
    fault, ROADMAP Queue 3), and the backends agree."""
    inp, jx = jax_side
    reqs = list(zip(inp["prompts"], JAMBA_GENS))
    with _session(env["jamba_cfg"], env["jamba_state"], backend,
                  _mesh((1, 2)), stages=1) as sess:
        assert "tp=2 (heads, experts" in sess.describe()
        assert sess.static_report.verdict == "PASS"
        got = sess.generate(reqs)
        assert sess.last_stats["admitted_mid_flight"] >= 1
    for i, g in enumerate(got):
        want = jx[f"jamba_alone_{i}"]
        assert np.array_equal(g, want), f"request {i}: port {g} != jax {want}"


def test_launcher_serves_deepseek_on_a_mesh(capsys):
    outs = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "3", "--prompt-len", "6",
                              "--gen", "4", "--mesh", "1x2"])
    assert [len(o) for o in outs] == [4, 3, 4]
    out = capsys.readouterr().out
    assert "serve ok" in out and "tp=2" in out
