"""Training on a mesh of ranks: tensor- and data-parallel ``make_train_step``.

Holds ``make_train_step(cfg, MeshPlan(("data", "model"), (D, M)))`` to the
JAX package on reduced qwen3-1.7b (2 layers, d_model 256, 4 q / 2 kv heads,
vocab 1024, float32), from the JAX init carried over by
``params_from_jax``, on the same ``SyntheticLM`` batches of 4 x 32 (seed
0). As in ``test_torch_serve_mesh.py`` the JAX side runs once per module in
a subprocess with 8 host devices and Auto mesh axes, from the code below,
and writes ``.npz`` results; the port runs in process on the CPU, every
rank a thread, and the ``core/mesh.py`` guard refuses any collective
inside an autograd backward throughout.

On (1, 2), (2, 1), (2, 2), (1, 4) (kv heads < tp) and ``fsdp=True`` on
(2, 2), with the tolerances below (measured on the CPU beside each):

* step 0's loss within 1e-5 relative of the JAX step on the same mesh
  (measured at most 1.3e-7);
* every gradient leaf, assembled from the ranks, within ``rtol=1e-4,
  atol=1e-6`` of the JAX 1 x 1 ``value_and_grad``, as in
  ``test_torch_train.py`` (measured at most 4.5e-7 abs);
* three AdamW steps: losses within 1e-5 relative of the JAX mesh run
  (measured at most 1.3e-7), and the assembled params within ``rtol=1e-4,
  atol=2e-5`` (measured at most 1.72e-5 abs). The first AdamW step moves
  each element by about lr = 3e-4 times ``g / (|g| + eps)``, so an element
  whose gradient is rounding noise moves by an arbitrary share of lr: on
  these batches the JAX package's own mesh runs end up to 1.58e-5 from its
  1 x 1 run, and the port's 1 x 1 run 1.03 times the ``atol=1e-5`` limit
  from JAX's, so the limit sits above that floor;
* ``grad_norm`` within 1e-5 relative of the port's own 1 x 1 value and of
  the JAX ``zero=True`` step on that mesh (measured at most 1.2e-7).

The reference's plain path reports dp times the true ``grad_norm``
(ROADMAP Queue 3); a test pins that, as ``test_torch_mesh.py`` pins the
reference's scrambled transitions. Module checks against the JAX functions
under ``shard_map(check=True)`` at ``rtol=1e-5`` with ``atol`` 1e-6 of the
reference's largest magnitude (measured at most 0.29 of that limit): the
vocab-parallel ``lm_loss`` with its gradients for ``h`` and ``unembed``,
the psums of the model-disjoint leaves (``wk``, ``wv``, ``q_norm``,
``k_norm``) at (1, 4), and ``embed_tokens``' gradient on each vocab shard.
The port alone: the guard, an indivisible batch, the launcher on a 1x2
mesh, remat on and off, the collectives a step makes, and checkpoints both
ways.
"""
import dataclasses
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

from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import mesh as M  # noqa: E402
from repro_torch.core.mesh import CollectiveError, spmd  # noqa: E402
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.core.tape import (LocalProgram, Step,  # noqa: E402
                                   taped_backward, taped_forward)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import (MeshPlan, branch_psum_step,  # noqa: E402
                                       grad_sync_step)
from repro_torch.models.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
CPU = "cpu"

#: constants both processes read
SHARED = r'''
LR, STEPS, B, S = 3e-4, 3, 4, 32
MESHES = [((1, 2), False), ((2, 1), False), ((2, 2), False), ((1, 4), False),
          ((2, 2), True)]
MODULE_MESHES = [(1, 2), (1, 4)]


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
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.configs.registry import get_config
from repro.data.pipeline import SyntheticLM
from repro.models import attention as A, transformer as T
from repro.models.model_zoo import build_model
from repro.optim.adamw import AdamWConfig
from repro.train.steps import make_train_step, plan_from_mesh
from repro_torch.configs.registry import get_config as port_config
from repro_torch.models.convert import params_from_jax
exec(open(os.path.join(out_dir, "shared.py")).read())
inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
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
fresh = lambda: jax.tree.map(jnp.array, np0)
put("p0", np0)
src = SyntheticLM(cfg.vocab_size, B, S)
batches = [src(i) for i in range(STEPS)]
res["batches"] = np.stack(batches)
bundle = build_model(cfg, plan_from_mesh(mesh_of((1, 1))))
(loss, _), grads = jax.jit(jax.value_and_grad(bundle.loss_fn, has_aux=True))(
    fresh(), {"tokens": jnp.asarray(batches[0])})
res["loss_1x1"] = np.asarray(loss)
put("grads_1x1", grads)

for shape, fsdp in MESHES:
    mesh, t = mesh_of(shape), tag(shape, fsdp)
    for zero in (False, True):
        ts = make_train_step(cfg, mesh, optimizer=AdamWConfig(lr=LR),
                             zero=zero, fsdp=fsdp)
        p = ts.shard_params_fn(fresh()) if zero else fresh()
        opt = ts.init_opt(p)
        losses, norms = [], []
        for b in batches:
            p, opt, m = ts.step_fn(p, opt, {"tokens": b})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        kind = "zero" if zero else "plain"
        res[f"loss_{kind}_{t}"] = np.array(losses)
        res[f"norm_{kind}_{t}"] = np.array(norms)
        if not zero:
            put(f"params_{t}", p)

w_ones = jnp.ones(inp["labels"].shape, jnp.float32)
p_attn = jax.tree.map(lambda a: a[0], np0["body"][0]["attn"])
for shape in MODULE_MESHES:
    mesh, t = mesh_of(shape), tag(shape)
    plan = plan_from_mesh(mesh)
    rep, cols, rows = P(), P(None, "model"), P("model", None)

    def loss_fn(U, h, labels):
        return jax.value_and_grad(
            lambda U, h: T.lm_loss(U, h, labels, w_ones, plan, cfg),
            argnums=(0, 1))(U, h)
    loss, (dU, dh) = jax.jit(shard_map(
        loss_fn, mesh=mesh, in_specs=(cols, rep, rep),
        out_specs=(rep, (cols, rep)), check=True))(
        np0["unembed"], inp["h"], inp["labels"])
    res[f"lm_loss_{t}"], res[f"lm_dU_{t}"] = np.asarray(loss), np.asarray(dU)
    res[f"lm_dh_{t}"] = np.asarray(dh)

    def emb_grad(E, ids, cot):
        return jax.grad(lambda E: (T.embed_tokens(E, ids, plan) * cot).sum())(E)
    res[f"emb_dE_{t}"] = np.asarray(jax.jit(shard_map(
        emb_grad, mesh=mesh, in_specs=(rows, rep, rep), out_specs=rows,
        check=True))(np0["embed"], inp["ids"], inp["emb_cot"]))

    if shape == (1, 4):
        specs = A.gqa_specs(cfg, plan)

        def attn_grad(p, x, cot):
            def f(p):
                y, _ = A.gqa_forward(p, x, cfg, plan, jnp.arange(x.shape[1]))
                return (jax.lax.psum(y, "model") * cot).sum()
            return jax.grad(f)(p)
        g = jax.jit(shard_map(attn_grad, mesh=mesh,
                              in_specs=(specs, rep, rep), out_specs=specs,
                              check=True))(p_attn, inp["x"], inp["attn_cot"])
        for k, v in jax.device_get(g).items():
            res[f"attn_d{k}_{t}"] = np.asarray(v)
np.savez(os.path.join(out_dir, "jax.npz"), **res)
print("JAX-OK")
"""


def _cfg():
    return get_config("qwen3-1.7b").reduced()


def _inputs(cfg):
    """Seeded numpy inputs of the module checks."""
    rng = np.random.default_rng(21)
    f32 = np.float32
    d = cfg.d_model
    return {"h": rng.normal(size=(B, S, d)).astype(f32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "ids": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "emb_cot": rng.normal(size=(B, S, d)).astype(f32),
            "x": rng.normal(size=(B, S, d)).astype(f32),
            "attn_cot": rng.normal(size=(B, S, d)).astype(f32)}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_train_mesh")
    inputs = _inputs(_cfg())
    (out / "shared.py").write_text(SHARED)
    np.savez(out / "inputs.npz", **inputs)
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
    return SimpleNamespace(inputs=inputs, jx=jx, tree=tree)


def _plan(shape, fsdp=False):
    plan = MeshPlan(("data", "model"), shape)
    return dataclasses.replace(plan, model_axis="__fsdp_none__") if fsdp \
        else plan


def _train_step(shape=(1, 1), fsdp=False, zero=False, **kw):
    return make_train_step(_cfg(), MeshPlan(("data", "model"), shape),
                           optimizer=AdamWConfig(lr=LR), zero=zero,
                           fsdp=fsdp, device=CPU, **kw)


def _params(ts, jax_side):
    params = ts.init_params(0)
    params.load_state_dict(jax_side.tree("p0"))
    return params


@pytest.fixture(scope="module")
def port_runs(jax_side):
    """Every mesh's gradients on batch 0 and three AdamW steps, and the
    same steps on one device."""
    batches = jax_side.jx["batches"]
    out = {}
    for shape, fsdp in [((1, 1), False)] + MESHES:
        ts = _train_step(shape, fsdp)
        params = _params(ts, jax_side)
        loss, grads = ts.grad_fn(params, {"tokens": batches[0]})
        opt = ts.init_opt(params)
        metrics = []
        for b in batches:
            params, opt, m = ts.step_fn(params, opt, {"tokens": b})
            metrics.append({k: float(v) for k, v in m.items()})
        out[tag(shape, fsdp)] = SimpleNamespace(
            loss=float(loss), grads=grads, metrics=metrics,
            params=params.state_dict(), opt=opt)
    return out


def _worst(got, want, rtol, atol):
    """The largest share of its allclose limit any element reaches."""
    got, want = np.asarray(got), np.asarray(want)
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


# ---------------------------------------------------------------------------
# the step on each mesh against the JAX package
# ---------------------------------------------------------------------------

MESH_IDS = [tag(s, f) for s, f in MESHES]


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_step0_loss_matches_the_jax_step_on_the_mesh(jax_side, port_runs,
                                                    mesh):
    t = tag(*mesh)
    run = port_runs[t]
    assert set(run.metrics[0]) == {"lm_loss", "aux_loss", "loss",
                                   "grad_norm"}
    assert run.metrics[0]["aux_loss"] == 0.0
    assert run.metrics[0]["lm_loss"] == run.metrics[0]["loss"]
    assert_allclose(run.metrics[0]["loss"], jax_side.jx[f"loss_plain_{t}"][0],
                    rtol=1e-5)
    assert_allclose(run.loss, jax_side.jx["loss_1x1"], rtol=1e-5)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_assembled_gradients_match_jax_one_device(jax_side, port_runs, mesh):
    got = port_runs[tag(*mesh)].grads
    want = jax_side.tree("grads_1x1")
    assert set(got) == set(want)
    for name, g in got.items():
        assert g.abs().max() > 0, name
        assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                        err_msg=name)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_three_adamw_steps_match_the_jax_mesh_run(jax_side, port_runs, mesh):
    t = tag(*mesh)
    run = port_runs[t]
    assert all(int(o.step) == STEPS for o in run.opt)
    assert_allclose([m["loss"] for m in run.metrics],
                    jax_side.jx[f"loss_plain_{t}"], rtol=1e-5)
    want = jax_side.tree(f"params_{t}")
    assert set(run.params) == set(want)
    for name, w in want.items():
        assert_allclose(run.params[name].numpy(), w.numpy(), rtol=1e-4,
                        atol=2e-5, err_msg=name)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_grad_norm_is_the_true_norm(jax_side, port_runs, mesh):
    """The port's pre-clip norm on a mesh is one device's, and the JAX
    ZeRO path's on that mesh (which normalises its data sum)."""
    t = tag(*mesh)
    norms = [m["grad_norm"] for m in port_runs[t].metrics]
    assert_allclose(norms, [m["grad_norm"] for m in port_runs["1x1"].metrics],
                    rtol=1e-5)
    assert_allclose(norms, jax_side.jx[f"norm_zero_{t}"], rtol=1e-5)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_reference_plain_grad_norm_is_dp_times_the_true_one(jax_side,
                                                            port_runs, mesh):
    """Pins a fault of the reference (ROADMAP Queue 3): its plain path's
    ``grad_norm`` is dp times the true one, because a data-replicated
    param's gradient arrives summed over ``data`` under ``shard_map``
    (``repro/train/steps.py:187-188``) and ``plain_dp_adamw_update`` divides
    by dp and psums it again (``repro/optim/zero.py:309-313``). The clip
    at 1.0 hides it from the update. When the reference is fixed this pin
    fails: then hold the port to the reference's norm instead."""
    t = tag(*mesh)
    dp = _plan(*mesh).dp
    true = [m["grad_norm"] for m in port_runs[t].metrics]
    ref = jax_side.jx[f"norm_plain_{t}"]
    assert_allclose(ref, dp * np.asarray(true), rtol=1e-5,
                    err_msg="the reference's plain-path grad_norm is no "
                    "longer dp x the true one: its fault is fixed")
    assert min(true) > 1.0        # the clip at 1.0 rescales either norm


# ---------------------------------------------------------------------------
# modules against the JAX functions under shard_map
# ---------------------------------------------------------------------------

def _mesh(shape):
    return Placement(("data", "model"), shape).to_mesh(CPU, timeout=60.0)


def _run_program(program, per_rank_values, diff, wanted, mesh):
    """Each rank's taped forward and backward of ``program`` (seed 1 on its
    ``loss``): ``[(loss, grads)]`` in rank order."""
    def rank(values):
        (loss,), tape = taped_forward(program, diff, values)
        return loss, taped_backward(tape, {"loss": torch.ones_like(loss)},
                                    wanted)
    return spmd(rank, mesh)(per_rank_values)


def _close(got, want, what=""):
    want = np.asarray(want)
    assert_allclose(torch.as_tensor(got).numpy(), want, rtol=1e-5,
                    atol=1e-6 * max(float(np.abs(want).max()), 1e-30),
                    err_msg=what)


@pytest.mark.parametrize("shape", MODULE_MESHES,
                         ids=[tag(s) for s in MODULE_MESHES])
def test_vocab_parallel_lm_loss_and_its_gradients(jax_side, shape):
    """The loss on vocab shards (xent stats at each shard's offset, the
    pmax held fixed, s and z psummed) and its gradients: each rank's
    ``unembed`` block and the whole ``h`` (the "f" sums the shards'
    parts)."""
    inp, jx, t = jax_side.inputs, jax_side.jx, tag(shape)
    plan, mesh = _plan(shape), _mesh(shape)
    U = jax_side.tree("p0")["unembed"]
    h = torch.from_numpy(inp["h"])
    tokens = torch.from_numpy(np.concatenate(
        [np.zeros((B, 1), np.int32), inp["labels"]], 1))
    program = LocalProgram(
        [grad_sync_step("h", "#h.f", plan), *T.loss_steps("#h.f", plan)],
        ("h", "unembed", "tokens"), ("loss",), ("loss",))
    Vl = U.shape[1] // shape[1]
    outs = _run_program(program, [[h, U[:, r * Vl:(r + 1) * Vl].clone(),
                                   tokens] for r in range(mesh.size)],
                        {"h", "unembed"}, ("h", "unembed"), mesh)
    for r, (loss, (dh, dU)) in enumerate(outs):
        _close(loss, jx[f"lm_loss_{t}"], f"loss rank {r}")
        _close(dh, jx[f"lm_dh_{t}"], f"dh rank {r}")
        _close(dU, jx[f"lm_dU_{t}"][:, r * Vl:(r + 1) * Vl], f"dU rank {r}")


@pytest.mark.parametrize("shape", MODULE_MESHES,
                         ids=[tag(s) for s in MODULE_MESHES])
def test_vocab_parallel_embedding_gradient_on_each_shard(jax_side, shape):
    inp, jx, t = jax_side.inputs, jax_side.jx, tag(shape)
    plan, mesh = _plan(shape), _mesh(shape)
    E = jax_side.tree("p0")["embed"]
    Vl = E.shape[0] // shape[1]
    program = LocalProgram(
        [Step(lambda e, i: T.embed_local(e, i, plan), ("embed", "ids"),
              ("#e",)),
         branch_psum_step("#e", "#e.sum", plan),
         Step(lambda e, c: (e * c).sum(), ("#e.sum", "cot"), ("loss",))],
        ("embed", "ids", "cot"), ("loss",), ("loss",))
    ids, cot = (torch.from_numpy(inp[k]) for k in ("ids", "emb_cot"))
    outs = _run_program(program, [[E[r * Vl:(r + 1) * Vl].clone(), ids, cot]
                                  for r in range(mesh.size)],
                        {"embed"}, ("embed",), mesh)
    for r, (_, (dE,)) in enumerate(outs):
        _close(dE, jx[f"emb_dE_{t}"][r * Vl:(r + 1) * Vl], f"rank {r}")


def test_model_disjoint_leaves_are_summed_over_model(jax_side):
    """At (1, 4), two ranks to each of the 2 kv heads: each rank's gradient
    of ``wk``, ``wv``, ``q_norm`` and ``k_norm`` is its own part (``wk``
    and ``wv`` nonzero on its group's columns only); their psum over
    ``model`` is JAX's gradient, and the split leaves need none."""
    shape = (1, 4)
    inp, jx, t = jax_side.inputs, jax_side.jx, tag(shape)
    cfg, plan, mesh = _cfg(), _plan(shape), _mesh(shape)
    state = {k[len("blocks.0.attn."):]: v for k, v in jax_side.tree(
        "p0").items() if k.startswith("blocks.0.attn.")}
    names = sorted(state)

    def attention(x, *ws):
        p = SimpleNamespace(**dict(zip(names, ws)))
        return A.gqa_forward(p, x, cfg, plan,
                             torch.arange(x.shape[1]))[0]
    program = LocalProgram(
        [grad_sync_step("x", "#x.f", plan),
         Step(attention, ("#x.f", *names), ("#a",)),
         branch_psum_step("#a", "#a.sum", plan),
         Step(lambda a, c: (a * c).sum(), ("#a.sum", "cot"), ("loss",))],
        ("x", "cot", *names), ("loss",), ("loss",))
    specs = T.block_specs(cfg, plan, ("attn", "dense"))
    x, cot = (torch.from_numpy(inp[k]) for k in ("x", "attn_cot"))
    shards = [[x, cot, *(state[n][M.shard_slices(
        state[n].shape, specs["attn." + n], plan.axis_sizes,
        mesh.coords(r))].clone() for n in names)] for r in range(mesh.size)]
    outs = _run_program(program, shards, set(names), names, mesh)
    summed = spmd(lambda g: [M.psum(v, "model") if n in
                             A.MODEL_GRAD_SUM_LEAVES else v
                             for n, v in zip(names, g)], mesh)(
        [o[1] for o in outs])
    hd, group = cfg.head_dim, shape[1] // cfg.num_kv_heads
    assert {"wk", "wv", "q_norm", "k_norm"} <= A.MODEL_GRAD_SUM_LEAVES
    for r in range(mesh.size):
        mine = dict(zip(names, outs[r][1]))
        for n in ("wk", "wv"):
            cols = mine[n].abs().sum(0).reshape(cfg.num_kv_heads, hd).sum(1)
            assert cols.nonzero().flatten().tolist() == [r // group], n
        for n, g in zip(names, summed[r]):
            want = jx[f"attn_d{n}_{t}"]
            if n not in A.MODEL_GRAD_SUM_LEAVES:    # split over model
                want = want[M.shard_slices(want.shape, specs["attn." + n],
                                           plan.axis_sizes, mesh.coords(r))]
            _close(g, want, f"{n} rank {r}")


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def test_a_collective_inside_a_backward_raises():
    """The guard that stands for the card's one autograd thread: a psum
    called from inside a backward raises on the CPU too."""
    class PsumInBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, v):
            return v.clone()

        @staticmethod
        def backward(ctx, g):
            return M.psum(g, "model")

    def body(x):
        v = x.clone().requires_grad_(True)
        return torch.autograd.grad(PsumInBackward.apply(v).sum(), v)
    with pytest.raises(CollectiveError, match="inside an autograd backward"):
        spmd(body, _mesh((1, 2)))([torch.ones(3), torch.ones(3)])


def test_an_indivisible_batch_raises(jax_side):
    ts = _train_step((2, 1))
    params = ts.init_params(0)
    with pytest.raises(ValueError, match="dp = 2"):
        ts.step_fn(params, ts.init_opt(params),
                   {"tokens": jax_side.jx["batches"][0][:3]})


def test_remat_on_and_off_give_the_same_gradients(jax_side):
    batch = {"tokens": jax_side.jx["batches"][0]}
    got = {}
    for remat in (True, False):
        ts = _train_step((1, 2), remat=remat)
        got[remat] = ts.grad_fn(_params(ts, jax_side), batch)
    assert got[True][0] == got[False][0]
    for name, g in got[True][1].items():
        torch.testing.assert_close(g, got[False][1][name], rtol=0, atol=0)


def test_a_step_makes_the_collectives_counted(jax_side):
    """(1, 2), 2 layers: psums 2 a layer and 3 more forward (embedding, s,
    z), 2 a layer and 1 more backward (the f's), 4 a layer after it (wk,
    wv, q_norm, k_norm), the norm and the metrics; one pmax. The ranks own
    their shards: no two share storage."""
    ts = _train_step((1, 2))
    params = _params(ts, jax_side)
    opt = ts.init_opt(params)
    ts.mesh.stats.reset()
    ts.step_fn(params, opt, {"tokens": jax_side.jx["batches"][0]})
    L = _cfg().num_layers
    assert ts.mesh.stats.calls == {"psum": 8 * L + 6, "pmax": 1}
    ptrs = [t.untyped_storage().data_ptr() for r in params.ranks
            for t in r.values()]
    assert len(set(ptrs)) == len(ptrs)


def test_launcher_trains_on_a_1x2_mesh():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--mesh", "1x2", "--steps", "5", "--batch", "4",
         "--seq", "32"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert "(improved)" in res.stdout, res.stdout


def test_mesh_checkpoints_restore_across_packages(jax_side, tmp_path):
    """A (2, 2) mesh's params, assembled, restore in the JAX package; a
    JAX checkpoint restores into the ranks' shards."""
    cfg = _cfg()
    ts = _train_step((2, 2))
    params = _params(ts, jax_side)
    opt = ts.init_opt(params)
    params, opt, _ = ts.step_fn(params, opt,
                                {"tokens": jax_side.jx["batches"][0]})
    tree = {"params": params_to_jax(params.state_dict(), cfg)}
    ckpt.save_checkpoint(str(tmp_path / "port"), tree, step=1,
                         meta={"arch": cfg.name})
    like = jax.tree.map(jnp.zeros_like, tree)
    got, step = jax_ckpt.load_checkpoint(str(tmp_path / "port"), like)
    assert step == 1
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(tree)[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b)

    want = jax_side.tree(f"params_{tag((2, 2))}")
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"),
                             {"params": params_to_jax(want, cfg)}, step=3)
    got_t, step = ckpt.load_checkpoint(str(tmp_path / "jax"), tree)
    assert step == 3
    params.load_state_dict(params_from_jax(got_t["params"], cfg))
    for name, t in params.state_dict().items():
        torch.testing.assert_close(t, want[name], rtol=0, atol=0)
