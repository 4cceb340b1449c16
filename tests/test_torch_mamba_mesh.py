"""Serving Mamba-2 on a mesh of ranks: tensor- and data-parallel mamba2.

Holds ``repro_torch.api.compile("mamba2-370m"-reduced, mode="serve",
mesh=...)`` to the JAX package on reduced mamba2 (2 SSM layers, d_model
256, 16 heads of 32, d_state 32, chunk 32, float32) with ``vocab_size=1000``
(1024 padded logit columns), from the JAX init carried over by
``params_from_jax``. As in ``test_torch_serve_mesh.py`` the JAX side runs
once per module in a subprocess with 8 host devices and Auto mesh axes
(the reference's serving path scatters into mesh-typed caches, which
Explicit axes refuse), from the code below, and writes ``.npz`` results;
the port runs in process on the CPU, every rank a thread.

On (1, 2), (2, 1), (2, 2) and (1, 4):

* greedy tokens, with unequal prompts and generations and requests
  admitted mid-flight, equal to the JAX monolithic session's on the same
  mesh serving each request alone, on both of the port's backends, which
  agree bitwise (tokens and stats). Alone, because the reference's dense
  serving lets the dummy decode of a parked slot advance the SSM state of
  a slot admitted in that round (its paged serving, which it refuses on a
  mesh, does not); the port keeps parked rows inert on a mesh as on one
  device, and a request served alone meets no such slot;
* the prefill logits of a prompt through a one-stage serve program
  within ``rtol=1e-5`` with ``atol`` 1e-5 of the largest logit of the JAX
  monolithic session's stage on that mesh (float32; the ranks sum their
  heads' parts in rank order, XLA in its own). At tp > 1 they differ from
  one device's: the gated norm before ``out_proj`` runs over each rank's
  local channels (a GroupNorm with tp groups), in the reference as in the
  port;
* every cache leaf on every rank has the shape its ``cache_specs``
  signature gives (the group cache and an admission prefill's), and the
  signatures are the reference's;
* the SSD scan runs at each rank's ``16 / tp`` local heads.

The port alone: ``cache="paged"`` on a mesh raises the reference's error,
and the launcher serves reduced mamba2 on a 1x2 mesh.
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
from repro.models.model_zoo import cache_specs as jax_cache_specs  # noqa: E402
from repro.train.steps import plan_from_mesh  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.lowering import lower_serve_stages  # noqa: E402
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.core.sbp import Split  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import mamba as port_mamba  # noqa: E402
from repro_torch.models.common import MeshPlan  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model_zoo import (cache_specs,  # noqa: E402
                                          make_decode_caches)
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim.zero import local_shape_of  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
CPU = "cpu"
TOL = 1e-5

#: constants both processes read
SHARED = r'''
PROMPT_LENS = [5, 8, 3, 8, 5, 3]    # unequal; 3 = d_conv - 1
GENS = [3, 6, 2, 5, 4, 1]           # unequal: requests retire mid-flight
CACHE_LEN = 24
GEOMETRY = dict(num_groups=2, group_size=2, max_prompt_len=8,
                max_new_tokens=max(GENS), cache_len=CACHE_LEN)
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
LOGIT_PROMPTS = 1                   # prompts whose prefill logits are held


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
from repro import api
from repro.configs.registry import get_config
from repro.models.model_zoo import build_model
from repro.train.steps import plan_from_mesh
exec(open(os.path.join(out_dir, "shared.py")).read())
inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
cfg = dataclasses.replace(get_config("mamba2-370m").reduced(),
                          vocab_size=1000)


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


params = build_model(cfg, plan_from_mesh(mesh_of((1, 1)))).init(
    jax.random.PRNGKey(0))
prompts = [inp[f"prompt_{i}"] for i in range(len(GENS))]
res = {}
for shape in [(1, 1)] + MESHES:
    mesh = mesh_of(shape)
    sess = api.compile(cfg, mode="serve", backend="monolithic",
                       params=params, mesh=mesh, **GEOMETRY)
    outs = sess.generate(list(zip(prompts, GENS)))
    res[f"mid_{tag(shape)}"] = np.asarray(
        sess.last_stats["admitted_mid_flight"])
    for i, o in enumerate(outs):
        res[f"tok_{tag(shape)}_{i}"] = np.asarray(o)
    for i, request in enumerate(zip(prompts, GENS)):
        res[f"alone_{tag(shape)}_{i}"] = np.asarray(
            sess.generate([request])[0])
    # the session's own one-stage program (its prefill already compiled)
    st = sess.sstaged.stages[0]
    for i in range(LOGIT_PROMPTS):
        x, _ = st.prefill(st.params, jnp.asarray(prompts[i][None]),
                          jnp.full((1,), prompts[i].size - 1, jnp.int32))
        res[f"logits_{tag(shape)}_{i}"] = np.asarray(x)
    sess.close()
try:
    api.compile(cfg, mode="serve", params=params, mesh=mesh_of((1, 2)),
                cache="paged", **GEOMETRY)
except ValueError as exc:
    res["paged_error"] = np.asarray(str(exc))
np.savez(os.path.join(out_dir, "jax.npz"), **res)
print("JAX-OK")
"""


def _cfg():
    return dataclasses.replace(get_config("mamba2-370m").reduced(),
                               vocab_size=1000)


@pytest.fixture(scope="module")
def env():
    cfg_t = _cfg()
    cfg_j = dataclasses.replace(jax_get_config("mamba2-370m").reduced(),
                                vocab_size=1000)
    assert cfg_t.padded_vocab() == 1024 and cfg_t.ssm_heads == 16
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    params = jax.device_get(jax_build(cfg_j, plan_from_mesh(mesh)).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg_t.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    return cfg_t, params_from_jax(params, cfg_t), prompts


@pytest.fixture(scope="module")
def jax_side(env, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_mamba_mesh")
    (out / "shared.py").write_text(SHARED)
    np.savez(out / "inputs.npz",
             **{f"prompt_{i}": p for i, p in enumerate(env[2])})
    run_env = dict(os.environ, JAX_PLATFORMS="cpu")
    run_env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", JAX_CODE, SRC, str(out)],
                          env=run_env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0 and "JAX-OK" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:])
    return dict(np.load(out / "jax.npz"))


def _mesh(shape):
    return Placement(("data", "model"), shape).to_mesh(CPU, timeout=60.0)


def _model(env):
    with torch.device("meta"):
        model = Transformer(env[0], MeshPlan.single_device())
    model.load_state_dict(env[1], assign=True)
    return model


@pytest.fixture(scope="module")
def port_runs(env):
    """Both backends on every mesh (and one device): tokens and stats."""
    out = {}
    for shape in [(1, 1)] + MESHES:
        mesh = None if shape == (1, 1) else _mesh(shape)
        for backend in ("actors", "monolithic"):
            extra = dict(stages=2) if backend == "actors" else {}
            with api.compile(env[0], mode="serve", backend=backend,
                             params=env[1], mesh=mesh, device=CPU, **extra,
                             **GEOMETRY) as sess:
                out[(shape, backend)] = (sess.generate(
                    list(zip(env[2], GENS))), dict(sess.last_stats))
    return out


def _stage(env, shape):
    """A one-stage serve program of the model on ``shape``'s mesh."""
    return lower_serve_stages(env[0], _model(env), num_stages=1,
                              cache_len=CACHE_LEN, max_prompt_len=8,
                              group_size=2,
                              mesh=None if shape == (1, 1)
                              else _mesh(shape)).stages[0]


@pytest.mark.parametrize("backend", ["actors", "monolithic"])
@pytest.mark.parametrize("shape", MESHES, ids=[tag(s) for s in MESHES])
def test_tokens_match_the_jax_session(jax_side, port_runs, shape, backend):
    got, stats = port_runs[(shape, backend)]
    assert [len(o) for o in got] == GENS
    for i, g in enumerate(got):
        want = jax_side[f"alone_{tag(shape)}_{i}"]
        assert np.array_equal(g, want), f"request {i}: port {g} != jax {want}"
    assert stats["admitted_mid_flight"] >= 1
    assert stats["admitted_mid_flight"] == int(jax_side[f"mid_{tag(shape)}"])
    assert stats["tokens"] == sum(GENS)


@pytest.mark.parametrize("shape", MESHES, ids=[tag(s) for s in MESHES])
def test_actors_match_monolithic_bitwise(port_runs, shape):
    a, sa = port_runs[(shape, "actors")]
    b, sb = port_runs[(shape, "monolithic")]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for key in ("prefill_items", "decode_items", "rounds"):
        assert sa[key] == sb[key]
    assert sa["collectives"]["calls"] == sb["collectives"]["calls"]
    if shape[1] > 1:             # each SSM branch's psum over model
        assert sa["collectives"]["calls"]["psum"] > 0


@pytest.mark.parametrize("shape", [(1, 1)] + MESHES,
                         ids=[tag(s) for s in [(1, 1)] + MESHES])
def test_prefill_logits_match_the_jax_stage(env, jax_side, shape):
    st = _stage(env, shape)
    for i in range(LOGIT_PROMPTS):
        p = env[2][i]
        with torch.inference_mode():
            x, _ = st.prefill(st.params, torch.from_numpy(p[None]),
                              p.size - 1)
        want = jax_side[f"logits_{tag(shape)}_{i}"]
        np.testing.assert_allclose(
            x.numpy(), want, rtol=TOL,
            atol=TOL * float(np.abs(want).max()), err_msg=f"prompt {i}")


def test_model_axis_changes_the_logits_as_the_reference(jax_side):
    """The gated norm over local channels: tp = 2 and tp = 4 give other
    logits than one device in the reference, and dp alone does not."""
    one = jax_side["logits_1x1_0"]
    assert np.array_equal(jax_side["tok_2x1_0"], jax_side["tok_1x1_0"])
    np.testing.assert_allclose(jax_side["logits_2x1_0"], one, rtol=TOL,
                               atol=TOL * float(np.abs(one).max()))
    for t in ("1x2", "1x4"):
        gap = np.abs(jax_side[f"logits_{t}_0"] - one).max()
        assert gap > 1e-3 * np.abs(one).max(), t


def _dims(sbp, axis_names):
    """An NdSbp as ``{tensor dim: mesh axis}``."""
    return {c.axis: n for c, n in zip(sbp, axis_names)
            if isinstance(c, Split)}


def _jax_dims(spec):
    """A reference PartitionSpec as ``{tensor dim: mesh axis}``."""
    out = {}
    for d, entry in enumerate(spec):
        for n in (entry if isinstance(entry, tuple) else (entry,)):
            if n is not None:
                out[d] = n
    return out


@pytest.mark.parametrize("batch_axes", [("data",), ()], ids=["group",
                                                            "prefill"])
def test_cache_specs_are_the_reference(env, batch_axes):
    for shape in MESHES:
        plan = MeshPlan(("data", "model"), shape)
        mine = cache_specs(env[0], plan, batch_axes)
        ref = jax_cache_specs(_jax_cfg(), JaxMeshPlan(("data", "model"),
                                                      shape), batch_axes)
        ref = [dict(c) for c in ref["prologue"]] + [
            {k: type(v)(*v[1:]) for k, v in c.items()} for c in ref["body"]]
        assert len(mine) == env[0].num_layers and len(ref) == 1
        for layer in mine:
            assert set(layer) == {"h", "tail_x", "tail_bc"}
            for k, sbp in layer.items():
                assert _dims(sbp, plan.axis_names) == _jax_dims(ref[0][k]), \
                    (shape, k)


def _jax_cfg():
    return dataclasses.replace(jax_get_config("mamba2-370m").reduced(),
                               vocab_size=1000)


@pytest.mark.parametrize("shape", MESHES, ids=[tag(s) for s in MESHES])
def test_cache_leaves_have_their_specs_shapes(env, shape):
    """The group cache (2 slots) and an admission prefill's slot caches on
    every rank: each leaf the local shape of its ``cache_specs`` signature
    over the global cache."""
    cfg, plan = env[0], MeshPlan(("data", "model"), shape)
    st = _stage(env, shape)
    p = env[2][1]
    with torch.inference_mode():
        group = st.init_caches(2)
        _, slot = st.prefill(st.params, torch.from_numpy(p[None]),
                             p.size - 1)
    for caches, batch, axes in ((group, 2, ("data",)), (slot, 1, ())):
        whole = make_decode_caches(cfg, MeshPlan.single_device(), batch,
                                   CACHE_LEN, device="meta")
        specs = cache_specs(cfg, plan, axes)
        assert len(caches) == plan.tp * plan.dp
        for r, rank in enumerate(caches):
            for layer, ref, sp in zip(rank, whole, specs):
                for k, t in layer.items():
                    assert tuple(t.shape) == local_shape_of(
                        ref[k].shape, sp[k], plan), (r, k)
        nh_l = cfg.ssm_heads // plan.tp
        assert caches[0][0]["h"].shape[1] == nh_l


def test_ssd_scan_runs_at_local_heads(env, monkeypatch):
    """Each rank's prefill scans its ``16 / tp`` heads; on (1, 4), 4."""
    seen = []

    def spy(x, *args, **kw):
        seen.append(x.shape[2])
        return scan(x, *args, **kw)
    scan = port_mamba.ssd_scan
    monkeypatch.setattr(port_mamba, "ssd_scan", spy)
    st = _stage(env, (1, 4))
    with torch.inference_mode():
        st.prefill(st.params, torch.from_numpy(env[2][0][None]),
                   env[2][0].size - 1)
    assert seen == [4] * (4 * env[0].num_layers)


def test_paged_cache_on_a_mesh_raises_the_reference_error(env, jax_side):
    with pytest.raises(ValueError) as exc:
        api.compile(env[0], mode="serve", params=env[1], device=CPU,
                    mesh=_mesh((1, 2)), cache="paged", **GEOMETRY)
    assert str(exc.value) == str(jax_side["paged_error"])


def test_launcher_serves_mamba2_on_a_mesh(capsys):
    outs = launch_serve.main(["--arch", "mamba2-370m", "--smoke", "--device",
                              "cpu", "--mesh", "1x2", "--requests", "3",
                              "--prompt-len", "6", "--gen", "4"])
    assert [len(o) for o in outs] == [4, 3, 4]
    out = capsys.readouterr().out
    assert "tp=2" in out and "serve ok" in out
