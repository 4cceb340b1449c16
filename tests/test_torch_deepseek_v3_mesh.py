"""deepseek-v3-671b on meshes of ranks: its multi-token prediction (MTP)
trained, and its MLA with a q LoRA served, with heads and experts split
over ``model``.

Holds ``make_train_step(cfg, MeshPlan(("data", "model"), (D, M)))`` to the
JAX package on reduced deepseek-v3-671b (a dense layer, then MLA with a q
LoRA of rank 64 over an MoE of 4 experts top-2 plus 1 shared, MTP on,
vocab 1000 padded to 1024, float32), from the JAX init carried over by
``params_from_jax``, on the same ``SyntheticLM`` batches of 4 x 16 (seed
0). As in ``test_torch_deepseek_mesh_train.py`` the JAX side runs once per
module in subprocesses with 8 host devices and Auto mesh axes, from the
code below (two at once, each with half the JAX runs), and writes
``.npz`` results; the port runs in process on the
CPU, every rank a thread.

On (1, 2), (2, 1) and (2, 2), plain and ZeRO, three AdamW steps against
the JAX ``make_train_step`` on the same mesh (at 1 x 1 both port paths
are held to its ZeRO step in ``tests/test_torch_deepseek_v3.py``): the
port's ZeRO step against the JAX ZeRO step, its plain step against the
JAX plain step on (2, 2) and the JAX ZeRO step on (1, 2) and (2, 1). The
two JAX paths make the same update (AdamW divides out the clip factor
that the plain path's dp-times norm changes) and differ in the norm they
report, which the (2, 2) case pins; one JAX plain compile, not three,
and two processes at once keep the JAX side near half a minute.

* each step's ``loss``, ``lm_loss``, ``aux_loss`` and ``mtp_loss`` within
  1e-5 relative (on a data mesh each data rank routes its own rows and
  averages its own MTP loss, as the reference does);
* ``grad_norm`` within 1e-5 relative of the JAX ZeRO step's on that mesh
  (the true norm: the JAX plain path reports dp times it on a data axis,
  ROADMAP Queue 3);
* the params after the three steps within ``rtol=1e-4, atol=5e-5``, but
  for the elements whose gradient is rounding noise in some step (below
  1e-6 of that step's largest |g|, from the run's own gradients, which
  ``tests/test_torch_deepseek_v3.py`` and the cases below hold to the JAX
  package's; ``torch_frontend_parity.check_params_by_step``), held within
  lr: on (2, 2) one ``blocks.0.mlp.w_gate`` element, its step-0 gradient
  1.4e-8 (3e-8 of the largest) and its next two 1.9e-3 and 3.0e-3, ends
  5.9e-5 from the JAX run, where the JAX package's own plain and ZeRO
  runs end 3.2e-6 apart.

The port alone: on (1, 2), plain and ZeRO, every gradient leaf equals one
device's within ``rtol=1e-4, atol=1e-6``: the MTP norms ``mtp_norm_h`` and
``mtp_norm_e`` whole on every rank (they sit before an "f"), the
row-parallel ``mtp_proj`` and the MTP block's q LoRA and latent leaves
summed over ``model`` once; the collectives a step makes. Serving on (1,
2): tokens identical to the JAX mesh session on the actors and the
monolithic engine.
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

jax = pytest.importorskip("jax")

from repro_torch import api  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.models.common import (MODEL_GRAD_SUM_LEAVES,  # noqa: E402
                                       MeshPlan)
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from torch_frontend_parity import (check_params_by_step,  # noqa: E402
                                   noise_in_a_step)
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
CPU = "cpu"
ARCH = "deepseek-v3-671b"

#: constants both processes read
SHARED = r'''
LR, STEPS, B, S = 3e-4, 3, 4, 16
MESHES = [(1, 2), (2, 1), (2, 2)]
#: the JAX runs: ZeRO on every mesh, plain on (2, 2)
JAX_RUNS = [(s, True) for s in MESHES] + [((2, 2), False)]
#: the JAX side's processes, run at once: process i trains JAX_RUNS[i::2]
#: and process 0 also serves (about half a minute each)
JAX_PROCS = 2
KEYS = ("loss", "lm_loss", "aux_loss", "mtp_loss", "grad_norm")
SERVE_MESH = (1, 2)
PROMPT_LEN = 8
GENS = [3, 6, 2, 5, 4, 1]
GEOMETRY = dict(num_groups=2, group_size=2, max_prompt_len=PROMPT_LEN,
                max_new_tokens=max(GENS), cache_len=24)


def tag(shape, zero):
    return f"{shape[0]}x{shape[1]}_{'zero' if zero else 'plain'}"
'''
exec(SHARED)

JAX_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
out_dir, proc = sys.argv[2], int(sys.argv[3])
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from repro import api
from repro.configs.registry import get_config
from repro.data.pipeline import SyntheticLM
from repro.models.model_zoo import build_model
from repro.optim.adamw import AdamWConfig
from repro.train.steps import make_train_step, plan_from_mesh
from repro_torch.configs.registry import get_config as port_config
from repro_torch.models.convert import params_from_jax
exec(open(os.path.join(out_dir, "shared.py")).read())
arch = "deepseek-v3-671b"
cfg = dataclasses.replace(get_config(arch).reduced(), vocab_size=1000)
cfg_t = dataclasses.replace(port_config(arch).reduced(), vocab_size=1000)
res = {}


def put(prefix, tree):
    for n, v in params_from_jax(jax.device_get(tree), cfg_t).items():
        res[f"{prefix}/{n}"] = v.numpy()


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


one = build_model(cfg, plan_from_mesh(mesh_of((1, 1))))
np0 = jax.device_get(one.init(jax.random.PRNGKey(0)))
fresh = lambda: jax.tree.map(jnp.array, np0)
put("p0", np0)
src = SyntheticLM(cfg.vocab_size, B, S)
batches = [src(i) for i in range(STEPS)]
res["batches"] = np.stack(batches)
for shape, zero in JAX_RUNS[proc::JAX_PROCS]:
    ts = make_train_step(cfg, mesh_of(shape), optimizer=AdamWConfig(lr=LR),
                         zero=zero)
    p = ts.shard_params_fn(fresh()) if zero else fresh()
    opt = ts.init_opt(p)
    ms = []
    for b in batches:
        p, opt, m = ts.step_fn(p, opt, {"tokens": b})
        ms.append([float(m[k]) for k in KEYS])
    res[f"metrics_{tag(shape, zero)}"] = np.array(ms)
    put(f"params_{tag(shape, zero)}", ts.gather_params_fn(p) if zero else p)
if proc == 0:
    prompts = np.random.default_rng(17).integers(
        0, cfg.vocab_size, (len(GENS), PROMPT_LEN)).astype(np.int32)
    res["prompts"] = prompts
    sess = api.compile(cfg, mode="serve", backend="monolithic",
                       params=fresh(), mesh=mesh_of(SERVE_MESH), **GEOMETRY)
    for i, o in enumerate(sess.generate(list(zip(prompts, GENS)))):
        res[f"tok_{i}"] = np.asarray(o)
    sess.close()
np.savez(os.path.join(out_dir, f"jax{proc}.npz"), **res)
print("JAX-OK")
"""


def _cfg(**kw):
    return dataclasses.replace(get_config(ARCH).reduced(), vocab_size=1000,
                               **kw)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_deepseek_v3_mesh")
    (out / "shared.py").write_text(SHARED)
    run_env = dict(os.environ, JAX_PLATFORMS="cpu")
    run_env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", JAX_CODE, SRC, str(out),
                               str(i)], env=run_env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(JAX_PROCS)]
    jx = {}
    for i, proc in enumerate(procs):
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0 and "JAX-OK" in stdout, (
            stdout[-3000:] + stderr[-3000:])
        jx.update(np.load(out / f"jax{i}.npz"))

    def tree(prefix):
        return {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in jx.items()
                if k.startswith(prefix + "/")}
    return SimpleNamespace(jx=jx, tree=tree)


def _train_step(shape=(1, 1), zero=False, cfg=None):
    return make_train_step(cfg or _cfg(), MeshPlan(("data", "model"), shape),
                           optimizer=AdamWConfig(lr=LR), zero=zero,
                           device=CPU)


def _params(ts, state):
    if ts.zero:
        return ts.shard_params_fn(state)
    params = ts.init_params(0)
    params.load_state_dict(state)
    return params


#: the port's runs: plain and ZeRO on every mesh
RUNS = [(s, z) for s in MESHES for z in (False, True)]


def jax_run(shape, zero):
    """The JAX run a port run is held to (see the module doc)."""
    return tag(shape, zero if (shape, zero) in JAX_RUNS else True)


@pytest.fixture(scope="module")
def port_runs(jax_side):
    """Every run's three AdamW steps (metrics, params after, and which
    elements' gradients were rounding noise in a step, ``noise``), and
    batch 0's gradients on one device and on (1, 2)."""
    batches = jax_side.jx["batches"]
    p0 = jax_side.tree("p0")
    out = {}
    for shape, zero in [((1, 1), False)] + RUNS:
        ts = _train_step(shape, zero)
        params = _params(ts, p0)
        grads, noise = None, {}
        opt = ts.init_opt(params)
        metrics = []
        for b in batches:
            _, g = ts.grad_fn(params, {"tokens": b})
            grads = g if grads is None else grads
            noise = noise_in_a_step(noise, g)
            params, opt, m = ts.step_fn(params, opt, {"tokens": b})
            assert tuple(m) == ("lm_loss", "aux_loss", "loss", "mtp_loss",
                                "grad_norm")
            metrics.append([float(m[k]) for k in KEYS])
        out[shape, zero] = SimpleNamespace(
            grads=grads, noise=noise, metrics=np.array(metrics),
            params=(ts.gather_params_fn(params) if zero
                    else params.state_dict()))
    return out


IDS = [tag(s, z) for s, z in RUNS]


@pytest.mark.parametrize("shape,zero", RUNS, ids=IDS)
def test_three_adamw_steps_match_the_jax_mesh_run(jax_side, port_runs,
                                                  shape, zero):
    run = port_runs[shape, zero]
    want = jax_side.jx[f"metrics_{jax_run(shape, zero)}"]
    assert (run.metrics[:, 3] > 0).all() and (run.metrics[:, 2] > 0).all()
    np.testing.assert_allclose(run.metrics[:, :4], want[:, :4], rtol=1e-5)
    # the true norm: the JAX ZeRO step's (its plain path reports dp times)
    np.testing.assert_allclose(
        run.metrics[:, 4], jax_side.jx[f"metrics_{tag(shape, True)}"][:, 4],
        rtol=1e-5)
    # loss = lm_loss + mtp_weight * mtp_loss + router_aux_weight * aux_loss
    cfg = _cfg()
    loss, lm, aux, mtp = run.metrics[0, :4]
    np.testing.assert_allclose(
        loss, lm + cfg.mtp_weight * mtp + cfg.router_aux_weight * aux,
        rtol=1e-6)
    params = jax_side.tree(f"params_{jax_run(shape, zero)}")
    assert set(run.params) == set(params)
    check_params_by_step(run.params, params, run.noise)


def test_the_plain_path_keeps_the_true_norm_on_a_data_mesh(jax_side,
                                                           port_runs):
    """The JAX plain path's ``grad_norm`` on a data axis is dp times the
    true one (ROADMAP Queue 3); the port's plain path reports the true
    norm, its ZeRO step's."""
    shape = (2, 2)
    jax_plain = jax_side.jx[f"metrics_{tag(shape, False)}"][:, 4]
    jax_zero = jax_side.jx[f"metrics_{tag(shape, True)}"][:, 4]
    np.testing.assert_allclose(jax_plain, shape[0] * jax_zero, rtol=1e-4)
    for shape in ((2, 1), (2, 2)):
        np.testing.assert_allclose(port_runs[shape, False].metrics[:, 4],
                                   port_runs[shape, True].metrics[:, 4],
                                   rtol=1e-6)


def _same_grads(got, want):
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


@pytest.mark.parametrize("zero", [False, True], ids=["plain", "zero"])
def test_mtp_gradients_on_a_model_axis_are_one_devices(port_runs, zero):
    """On (1, 2) the batch is one device's, so every gradient is one
    device's: ``mtp_norm_h`` and ``mtp_norm_e`` come out whole on every
    rank (an "f" follows the concatenation), ``mtp_proj``'s rows are each
    rank's own, and the MTP block's q LoRA and latent leaves (``wq_a``,
    ``q_norm``, ``wkv_a``, ``kv_norm``) are summed over ``model`` once."""
    one = port_runs[(1, 1), False].grads
    got = port_runs[(1, 2), zero].grads
    for leaf in ("wq_a", "q_norm", "wkv_a", "kv_norm"):
        assert leaf in MODEL_GRAD_SUM_LEAVES
        assert f"mtp_block.attn.{leaf}" in one
    for name in ("mtp_norm_h", "mtp_norm_e", "mtp_proj"):
        assert name.rsplit(".", 1)[-1] not in MODEL_GRAD_SUM_LEAVES
        assert one[name].abs().max() > 0, name
    _same_grads(got, one)


def test_a_step_makes_the_collectives_counted(jax_side):
    """(1, 2), 2 layers (1 of them MoE) and the MTP module: psums 2 a
    layer and 3 more forward (embedding, s, z), 2 a layer and 1 more
    backward (the f's), the model sums of the replicated leaves each rank
    uses in part (``wq_a``, ``q_norm``, ``wkv_a`` and ``kv_norm`` a layer,
    the router an MoE layer), the norm and the metrics; one pmax. MTP adds
    6 psums forward (the next tokens' embedding, the projection, its
    block's two branches, s and z), 4 backward (the f's of the
    concatenation, of its block's two branches and of its loss), its
    block's 4 model sums and a pmax."""
    cfg = _cfg()
    ts = _train_step((1, 2))
    params = _params(ts, jax_side.tree("p0"))
    opt = ts.init_opt(params)
    ts.mesh.stats.reset()
    ts.step_fn(params, opt, {"tokens": jax_side.jx["batches"][0]})
    L, n_moe = cfg.num_layers, cfg.num_layers - cfg.first_dense_layers
    assert ts.mesh.stats.calls == {"psum": 8 * L + n_moe + 6 + 14,
                                   "pmax": 2}


def test_serving_on_a_model_axis_matches_the_jax_mesh_session(jax_side):
    """On (1, 2) the q LoRA's ``wq_a`` and ``q_norm`` are replicated and
    ``wq_b`` split by head; the served tokens equal the JAX mesh session's
    on the actors (2 stages) and the monolithic engine, and the stages
    hold no MTP leaf."""
    jx = jax_side.jx
    reqs = list(zip(jx["prompts"], GENS))
    want = [jx[f"tok_{i}"] for i in range(len(GENS))]
    mesh = Placement(("data", "model"), SERVE_MESH).to_mesh(CPU, timeout=60.0)
    for backend in ("actors", "monolithic"):
        kw = dict(stages=2) if backend == "actors" else {}
        with api.compile(_cfg(), mode="serve", backend=backend,
                         params=jax_side.tree("p0"), mesh=mesh, device=CPU,
                         **kw, **GEOMETRY) as sess:
            got = sess.generate(reqs)
            names = {n for st in sess.sstaged.stages for rank in st.params
                     for n, _ in rank.named_parameters()}
        assert [len(o) for o in got] == GENS
        for i, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(g, w), f"{backend} request {i}: {g} != {w}"
        assert not any("mtp" in n for n in names)
        assert any(n.endswith("attn.wq_a") for n in names)
