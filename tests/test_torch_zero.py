"""ZeRO (paper §6.4): the flat-shard layout and ``make_train_step(zero=True)``.

The flat-layout helpers of ``repro_torch.optim.zero`` against
``repro.optim.zero`` on the same numpy inputs, bitwise (they are pure
layout and casts): shard/gather round trips with padding at dp 1, 2 and 4,
a rank's rows against the reference's global-view block, the cast before
the reshape, the shapes and signatures, and ``zero_stage_update`` against
dense AdamW (bitwise the port's own; within ``rtol=1e-6`` of the
reference's, whose fused CPU program may round its last bit apart).

``make_train_step(zero=True)`` on reduced qwen3-1.7b (2 layers, d_model
256, 4 q / 2 kv heads, vocab 1024, float32) on (1, 1), (1, 2), (2, 1),
(2, 2), (1, 4) and ``fsdp=True`` on (2, 2), from the JAX init carried over
by ``params_from_jax``, on the same ``SyntheticLM`` batches of 4 x 32, 3
AdamW steps. The JAX side runs once per module in a subprocess with 8 host
devices and Auto mesh axes (as ``tests/test_torch_train_mesh.py``):

* loss and ``grad_norm`` within 1e-5 relative of the reference's
  ``make_train_step(zero=True)`` on the same mesh;
* the gathered params within ``rtol=1e-5, atol=2e-5`` of its
  ``gather_params_fn`` after the first step and after three. AdamW moves
  each element by about lr = 3e-4 times ``g / (|g| + eps)``, so an element
  whose gradient is float32 rounding noise moves by an arbitrary share of
  lr from the first step on (measured up to 9.4e-6 after one step, on 2 of
  32,768 elements of a ``wk``); the reference's own meshes end up to
  1.58e-5 apart (``tests/test_torch_train_mesh.py``, which holds its params
  at the same ``atol``);
* losses within 1e-6 relative of the port's own ``zero=False`` step on the
  same mesh.

A collective inside the backward of a gather written as an autograd
Function raises, which is why the gather is a tape step.
"""
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.common import MeshPlan as JaxMeshPlan  # noqa: E402
from repro.optim import zero as jz  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.mesh import CollectiveError, spmd  # noqa: E402
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.core.sbp import ndsbp  # noqa: E402
from repro_torch.models.common import MeshPlan  # noqa: E402
from repro_torch.optim import zero as tz  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, AdamWState,  # noqa: E402
                                     adamw_math, adamw_update)
from repro_torch.train.steps import ZeroParams, make_train_step  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
CPU = "cpu"


def _np(t):
    return np.asarray(t)


# ---------------------------------------------------------------------------
# the flat layout against repro.optim.zero
# ---------------------------------------------------------------------------

def _tensors(seed=11):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(3, 5)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32),
              "s": rng.normal(size=(1,)).astype(np.float32)}
    grads = {n: (rng.normal(size=p.shape) * 2).astype(np.float32)
             for n, p in params.items()}
    return params, grads


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_shard_gather_round_trip_with_padding(dp):
    params, _ = _tensors()
    for n, p in params.items():
        got = tz.shard_flat(torch.from_numpy(p), dp=dp)
        want = jz.shard_flat(jnp.asarray(p), dp=dp)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), _np(want), err_msg=n)
        assert not got.reshape(-1)[p.size:].any()        # zero padding
        back = tz.gather_flat(got, shape=p.shape)
        np.testing.assert_array_equal(back.numpy(), p, err_msg=n)
        np.testing.assert_array_equal(
            back.numpy(), _np(jz.gather_flat(want, shape=p.shape,
                                             dtype="float32")))
        # a rank's rows are the global view's block at its data index
        plan = MeshPlan(("data", "model"), (dp, 1))
        for i in range(dp):
            np.testing.assert_array_equal(
                tz.shard_master_local(torch.from_numpy(p), plan, i).numpy(),
                _np(want)[i:i + 1], err_msg=f"{n} rank {i}")
    if dp == 1:
        p = params["w"]
        got = tz.shard_master_local(torch.from_numpy(p), MeshPlan())
        want = jz.shard_master_local(jnp.asarray(p), JaxMeshPlan.single_device())
        np.testing.assert_array_equal(got.numpy(), _np(want))
        np.testing.assert_array_equal(
            tz.gather_master_local(got, p.shape, torch.float32,
                                   MeshPlan()).numpy(),
            _np(jz.gather_master_local(want, p.shape, jnp.float32,
                                       JaxMeshPlan.single_device())))


def test_the_cast_comes_before_the_reshape():
    """Fig 14: the gathered copy is the compute dtype, bitwise the
    reference's (round to nearest even in both)."""
    p = np.random.default_rng(0).normal(size=(4, 4)).astype(np.float32)
    got = tz.gather_flat(tz.shard_flat(torch.from_numpy(p), dp=2),
                         shape=(4, 4), dtype="bfloat16")
    want = jz.gather_flat(jz.shard_flat(jnp.asarray(p), dp=2), shape=(4, 4),
                          dtype="bfloat16")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  _np(want).astype(np.float32))
    m = tz.shard_master_local(torch.from_numpy(p), MeshPlan())
    out = tz.gather_master_local(m, (4, 4), torch.bfloat16, MeshPlan())
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, torch.from_numpy(p).to(torch.bfloat16))


def test_shapes_and_signatures_match_the_reference():
    assert [tz._chunk_size(n, d) for n, d in ((8, 2), (7, 2), (1, 4),
                                              (12, 1))] == \
        [jz._chunk_size(n, d) for n, d in ((8, 2), (7, 2), (1, 4), (12, 1))]
    plan, jplan = (MeshPlan(("data", "model"), (2, 4)),
                   JaxMeshPlan(("data", "model"), (2, 4)))
    from jax.sharding import PartitionSpec as P
    for shape, sbp, spec in (((8, 12), "S(0),B", P("data", None)),
                             ((8, 12), "B,S(1)", P(None, "model")),
                             ((8, 12), "B,B", P(None, None))):
        assert tz.local_shape_of(shape, sbp, plan) == \
            jz.local_shape_of(shape, spec, jplan)
    plan = MeshPlan(("data", "model"), (2, 1))
    shapes = tz.master_shapes({"w": (7, 1)}, {"w": ndsbp("B,B")}, plan)
    want = jz.master_shapes(
        {"w": jax.ShapeDtypeStruct((7, 1), jnp.bfloat16)},
        {"w": P(None, None)}, JaxMeshPlan(("data", "model"), (2, 1)))
    assert shapes["w"] == want["w"].shape == (2, 1, 4)
    st = tz.zero_state_shapes({"w": (6, 2)}, {"w": ndsbp("B,B")}, plan)
    assert isinstance(st, tz.ZeroState) and st.mu == st.nu == {
        "w": (2, 1, 6)}
    assert tz.master_specs({"w": ndsbp("B,B")}, plan)["w"] == \
        ndsbp("S(0),S(1)")


def test_model_combine_sums_only_the_disjoint_leaves():
    """The reference sums every model-replicated leaf (its varying masters
    split each one's gradient); here the "f" steps already give the norms'
    whole gradient on each rank, so only the disjoint leaves are summed:
    the reference's named set (which it uses on its plain path) and MLA's
    latent leaves, which its ZeRO path sums as replicated leaves."""
    plan = MeshPlan(("data", "model"), (1, 2))
    specs = {"blocks.0.attn.wq": ndsbp("B,S(1)"),
             "blocks.0.ln1": ndsbp("B,B"),
             "blocks.0.attn.wk": ndsbp("B,B"),
             "blocks.0.attn.q_norm": ndsbp("B,B")}
    assert tz.model_combine_tree(specs, plan) == {
        "blocks.0.attn.wq": "none", "blocks.0.ln1": "none",
        "blocks.0.attn.wk": "sum", "blocks.0.attn.q_norm": "sum"}
    assert tz.MODEL_SUM_LEAVES == jz.MODEL_SUM_LEAVES | {
        "wkv_a", "kv_norm", "wq_a"}
    grads = {"w": torch.ones(2, 2)}
    assert tz.combine_model_grads(grads, {"w": "sum"},
                                  MeshPlan(("data", "model"), (2, 1))) \
        is grads


def test_zero_stage_update_matches_dense_adamw():
    params, grads = _tensors()
    lr, b1, b2, eps, wd = 1e-2, 0.9, 0.999, 1e-8, 0.1
    masters = {n: tz.shard_flat(torch.from_numpy(p), dp=2)
               for n, p in params.items()}
    st = tz.init_zero_flat(masters)
    assert st.mu["w"] is not st.nu["w"] and not st.mu["w"].any()
    g = {n: torch.from_numpy(v) for n, v in grads.items()}
    st2 = tz.zero_stage_update(masters, g, st, lr, dp=2, beta1=b1,
                               beta2=b2, eps=eps, weight_decay=wd)
    assert int(st2.step) == 1
    jm = {n: jz.shard_flat(jnp.asarray(p), dp=2) for n, p in params.items()}
    jm2, jst2 = jz.zero_stage_update(
        jm, {n: jnp.asarray(v) for n, v in grads.items()},
        jz.init_zero_flat(jm), lr, dp=2, beta1=b1, beta2=b2, eps=eps,
        weight_decay=wd)
    step = torch.ones((), dtype=torch.int32)
    for n, p in params.items():
        p32 = torch.from_numpy(p)
        dense, dmu, _ = adamw_math(p32, g[n], torch.zeros_like(p32),
                                   torch.zeros_like(p32), step, lr, b1, b2,
                                   eps, wd)
        got = tz.gather_flat(masters[n], shape=p.shape)
        assert torch.equal(got, dense), n                # layout-invariant
        assert torch.equal(tz.gather_flat(st2.mu[n], shape=p.shape), dmu)
        assert_allclose(masters[n].numpy(), _np(jm2[n]), rtol=1e-6,
                        atol=1e-7, err_msg=n)
        assert_allclose(st2.nu[n].numpy(), _np(jst2.nu[n]), rtol=1e-6,
                        err_msg=n)


def test_padding_stays_zero_through_updates():
    p = torch.arange(7, dtype=torch.float32)             # pads 7 -> 8
    masters = {"w": tz.shard_flat(p, dp=2)}
    st = tz.init_zero_flat(masters)
    for _ in range(3):
        st = tz.zero_stage_update(masters, {"w": torch.ones(7)}, st, 1e-2,
                                  dp=2, beta1=0.9, beta2=0.999, eps=1e-8,
                                  weight_decay=0.1)
    for t in (masters["w"], st.mu["w"], st.nu["w"]):
        assert t.reshape(-1)[7] == 0.0
    assert int(st.step) == 3


def test_zero_adamw_update_is_plain_adamw_at_one_device():
    """On one device ZeRO is AdamW on a flat view: the same norm, params
    and moments, bit for bit (the reference's counterpart test is red,
    ROADMAP Queue 3; the port's norms agree)."""
    params, grads = _tensors(7)
    cfg = AdamWConfig(lr=1e-2, grad_clip=1.0)
    plan = MeshPlan()
    masters = {n: tz.shard_master_local(torch.from_numpy(p), plan)
               for n, p in params.items()}
    gflat = {n: tz.shard_master_local(torch.from_numpy(g), plan)
             for n, g in grads.items()}
    zst, znorm = tz.zero_adamw_update(cfg, masters, gflat,
                                      tz.init_zero_state_local(masters),
                                      plan, {n: 1 for n in params})
    dense = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    ast = AdamWState(torch.zeros((), dtype=torch.int32),
                     {n: torch.zeros_like(p) for n, p in dense.items()},
                     {n: torch.zeros_like(p) for n, p in dense.items()})
    ast, pnorm = adamw_update(cfg, dense, {n: torch.from_numpy(g)
                                           for n, g in grads.items()}, ast)
    assert float(znorm) > cfg.grad_clip                 # the clip engaged
    assert torch.equal(znorm, pnorm)
    assert int(zst.step) == int(ast.step) == 1
    for n, p in params.items():
        for got, want in ((masters[n], dense[n]), (zst.mu[n], ast.mu[n]),
                          (zst.nu[n], ast.nu[n])):
            assert torch.equal(tz.gather_master_local(
                got, p.shape, torch.float32, plan), want), n


def test_a_collective_inside_a_gathers_backward_raises():
    """A gather written as an autograd node would run its reduce-scatter
    inside the backward, where the card's one autograd thread would wait
    for the other rank: the mesh refuses it, on the CPU too. The ZeRO step
    keeps the gather on the tape instead."""
    plan = MeshPlan(("data", "model"), (2, 1))

    class GatherNode(torch.autograd.Function):
        @staticmethod
        def forward(ctx, m):
            return tz.gather_master_local(m, (3, 2), torch.float32, plan)

        @staticmethod
        def backward(ctx, g):
            return tz.scatter_grad_local(g, plan)

    def rank(m):
        leaf = m.clone().requires_grad_(True)
        return torch.autograd.grad(GatherNode.apply(leaf).sum(), leaf)
    mesh = Placement(("data", "model"), (2, 1)).to_mesh(CPU, timeout=30.0)
    with pytest.raises(CollectiveError, match="inside an autograd backward"):
        spmd(rank, mesh)([torch.ones(1, 1, 3), torch.ones(1, 1, 3)])


def test_gather_and_scatter_on_two_ranks():
    """The tape step's forward and transpose on (2, 1): the rows gathered
    in data order, the cotangent summed over the ranks and split back."""
    plan = MeshPlan(("data", "model"), (2, 1))
    mesh = Placement(("data", "model"), (2, 1)).to_mesh(CPU, timeout=30.0)
    p = torch.arange(7, dtype=torch.float32).reshape(7, 1)
    rows = [tz.shard_master_local(p, plan, i) for i in range(2)]
    g = [torch.full((7, 1), 1.0), torch.full((7, 1), 2.0)]
    outs = spmd(lambda m, c: (tz.gather_master_local(m, (7, 1), torch.float32,
                                                     plan),
                              tz.scatter_grad_local(c, plan)), mesh)(rows, g)
    for r, (full, scat) in enumerate(outs):
        assert torch.equal(full, p)
        want = torch.tensor([3.0] * 7 + [0.0])[r * 4:(r + 1) * 4]
        assert torch.equal(scat.reshape(-1), want)
    assert mesh.stats.calls == {"all_gather": 1, "psum_scatter": 1}


# ---------------------------------------------------------------------------
# make_train_step(zero=True) against the JAX package
# ---------------------------------------------------------------------------

SHARED = r'''
LR, STEPS, B, S = 3e-4, 3, 4, 32
MESHES = [((1, 1), False), ((1, 2), False), ((2, 1), False), ((2, 2), False),
          ((1, 4), False), ((2, 2), True)]


def tag(shape, fsdp=False):
    return f"{shape[0]}x{shape[1]}" + ("_fsdp" if fsdp else "")
'''
exec(SHARED)

JAX_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
out_dir = sys.argv[2]
import numpy as np
import jax
import jax.numpy as jnp
from repro.configs.registry import get_config
from repro.data.pipeline import SyntheticLM
from repro.models.model_zoo import build_model
from repro.optim.adamw import AdamWConfig
from repro.train.steps import make_train_step, plan_from_mesh
from repro_torch.configs.registry import get_config as port_config
from repro_torch.models.convert import params_from_jax
exec(open(os.path.join(out_dir, "shared.py")).read())
cfg = get_config("qwen3-1.7b").reduced()
cfg_t = port_config("qwen3-1.7b").reduced()
res = {}


def put(prefix, tree):
    for n, v in params_from_jax(jax.device_get(tree), cfg_t).items():
        res[f"{prefix}/{n}"] = v.numpy()


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


np0 = jax.device_get(build_model(cfg, plan_from_mesh(mesh_of((1, 1)))).init(
    jax.random.PRNGKey(0)))
put("p0", np0)
src = SyntheticLM(cfg.vocab_size, B, S)
batches = [src(i) for i in range(STEPS)]
res["batches"] = np.stack(batches)
for shape, fsdp in MESHES:
    t = tag(shape, fsdp)
    ts = make_train_step(cfg, mesh_of(shape), optimizer=AdamWConfig(lr=LR),
                         zero=True, fsdp=fsdp)
    p = ts.shard_params_fn(jax.tree.map(jnp.array, np0))
    opt = ts.init_opt(p)
    losses, norms = [], []
    for k, b in enumerate(batches):
        p, opt, m = ts.step_fn(p, opt, {"tokens": b})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if k == 0:
            put(f"params1_{t}", ts.gather_params_fn(p))
    res[f"loss_{t}"], res[f"norm_{t}"] = np.array(losses), np.array(norms)
    put(f"params_{t}", ts.gather_params_fn(p))
np.savez(os.path.join(out_dir, "jax.npz"), **res)
print("JAX-OK")
"""


def _cfg():
    return get_config("qwen3-1.7b").reduced()


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_zero")
    (out / "shared.py").write_text(SHARED)
    run_env = dict(os.environ, JAX_PLATFORMS="cpu")
    run_env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", JAX_CODE, SRC, str(out)],
                          env=run_env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0 and "JAX-OK" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:])
    jx = dict(np.load(out / "jax.npz"))

    def tree(prefix):
        return {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in jx.items()
                if k.startswith(prefix + "/")}
    return SimpleNamespace(jx=jx, tree=tree)


def _run(shape, fsdp, zero, jax_side):
    ts = make_train_step(_cfg(), MeshPlan(("data", "model"), shape),
                         optimizer=AdamWConfig(lr=LR), zero=zero, fsdp=fsdp,
                         device=CPU)
    params = ts.init_params(0)
    params.load_state_dict(jax_side.tree("p0"))
    opt = ts.init_opt(params)
    metrics, first = [], None
    for k, b in enumerate(jax_side.jx["batches"]):
        params, opt, m = ts.step_fn(params, opt, {"tokens": b})
        metrics.append({n: float(v) for n, v in m.items()})
        if k == 0:
            first = params.state_dict()
    return SimpleNamespace(ts=ts, params=params, opt=opt, metrics=metrics,
                           first=first)


@pytest.fixture(scope="module")
def port_runs(jax_side):
    return {tag(s, f): SimpleNamespace(zero=_run(s, f, True, jax_side),
                                       plain=_run(s, f, False, jax_side))
            for s, f in MESHES}


MESH_IDS = [tag(s, f) for s, f in MESHES]


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_zero_step_matches_the_jax_zero_step(jax_side, port_runs, mesh):
    t = tag(*mesh)
    run = port_runs[t].zero
    assert run.ts.zero and isinstance(run.params, ZeroParams)
    assert all(int(o.step) == STEPS for o in run.opt)
    assert_allclose([m["loss"] for m in run.metrics],
                    jax_side.jx[f"loss_{t}"], rtol=1e-5)
    assert_allclose([m["grad_norm"] for m in run.metrics],
                    jax_side.jx[f"norm_{t}"], rtol=1e-5)
    for key, got in (("params1", run.first),
                     ("params", run.params.state_dict())):
        want = jax_side.tree(f"{key}_{t}")
        assert set(got) == set(want)
        for name, w in want.items():
            assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-5,
                            atol=2e-5, err_msg=f"{key} {name}")


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_zero_step_matches_the_plain_step(port_runs, mesh):
    run = port_runs[tag(*mesh)]
    assert not run.plain.ts.zero
    assert_allclose([m["loss"] for m in run.zero.metrics],
                    [m["loss"] for m in run.plain.metrics], rtol=1e-6)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_each_rank_holds_its_rows(port_runs, mesh):
    """Masters and moments (1, 1, chunk) float32 a leaf a rank, the data
    group's rows summing to the local shard (padding aside), and the
    gathers and reduce-scatters one a leaf each way a step."""
    run = port_runs[tag(*mesh)].zero
    params, plan = run.params, run.ts.plan
    for r, mine in enumerate(params.ranks):
        for n, m in mine.items():
            chunk = -(-int(np.prod(params.shapes[n])) // plan.dp)
            assert m.shape == (1, 1, chunk) and m.dtype == torch.float32
            assert run.opt[r].mu[n].shape == m.shape
    held = params.numel()
    replicas = sum(int(np.prod(s)) for s in params.shapes.values()) * \
        params.mesh.size
    assert held * plan.dp >= replicas > (held - len(params.shapes)
                                         * params.mesh.size) * plan.dp
    mesh_ = run.ts.mesh
    mesh_.stats.reset()
    run.ts.step_fn(params, run.opt, {"tokens": np.zeros((4, 33), np.int32)})
    calls = mesh_.stats.calls
    if plan.dp > 1:             # counted once per data group
        n = len(params.shapes) * params.mesh.size // plan.dp
        assert calls["all_gather"] == calls["psum_scatter"] == n


def test_zero_at_one_device_needs_no_collective(port_runs):
    run = port_runs["1x1"].zero
    run.ts.mesh.stats.reset()
    run.ts.step_fn(run.params, run.opt,
                   {"tokens": np.zeros((4, 33), np.int32)})
    assert run.ts.mesh.size == 1
    assert run.ts.mesh.stats.calls == {}


def test_shard_and_gather_params_fns_round_trip(jax_side):
    ts = make_train_step(_cfg(), MeshPlan(("data", "model"), (2, 2)),
                         device=CPU)
    p0 = jax_side.tree("p0")
    zp = ts.shard_params_fn(p0)
    back = ts.gather_params_fn(zp)
    for n, v in p0.items():
        assert torch.equal(back[n], v), n
    # the plain path's params convert too
    plain = make_train_step(_cfg(), MeshPlan(("data", "model"), (2, 2)),
                            zero=False, device=CPU).init_params(0)
    plain.load_state_dict(p0)
    for n, v in ts.gather_params_fn(ts.shard_params_fn(plain)).items():
        assert torch.equal(v, p0[n]), n


def test_zero_grad_fn_gives_the_plain_gradients(jax_side):
    """The data mean of the reduce-scattered rows, joined: the plain
    path's gradients on (2, 2)."""
    batch = {"tokens": jax_side.jx["batches"][0]}
    got = {}
    for zero in (True, False):
        ts = make_train_step(_cfg(), MeshPlan(("data", "model"), (2, 2)),
                             zero=zero, device=CPU)
        params = ts.init_params(0)
        params.load_state_dict(jax_side.tree("p0"))
        got[zero] = ts.grad_fn(params, batch)
    assert abs(float(got[True][0]) - float(got[False][0])) <= 1e-6 * abs(
        float(got[False][0]))
    for n, g in got[False][1].items():
        torch.testing.assert_close(got[True][1][n], g, rtol=1e-5, atol=1e-7)
