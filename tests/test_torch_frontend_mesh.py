"""The classic serve loop on a mesh of ranks: ``make_serve_step`` and
``launch/serve.py:classic_loop`` with heads split over ``model`` and rows
over ``data``, held to the JAX package on the CPU.

Reduced whisper-medium (an encoder-decoder: 2 encoder and 2 decoder
layers, 4 q and 2 kv heads of 64, 64 frames) and pixtral-12b (an embed
frontend), float32, from the JAX params of ``PRNGKey(0)`` carried over by
``params_from_jax``; a batch of 4 prompts of 16 tokens (or patch
embeddings) drawn as the classic loop draws them (numpy seed 0). As in
``test_torch_deepseek_mesh.py`` the JAX side runs once per module in a
subprocess with 8 host devices and Auto mesh axes (which the reference's
serving needs), from the code below, and writes ``.npz`` results; its
``make_serve_step`` is built once per arch and mesh and shared with its
``classic_loop``. The port runs in process on the CPU, every rank a
thread.

On (1, 2), (2, 1) and (2, 2), for both archs, and on (1, 2) for reduced
qwen3-1.7b, deepseek-v2-lite-16b (MLA + MoE, its latent cache replicated)
and mamba2-370m (SSM heads split):

* the prefill's last hidden (assembled: rows over ``data``) within
  float32 ``rtol=2e-4, atol=2e-5`` (XLA and PyTorch sum in other orders,
  as ``tests/torch_frontend_parity.py``);
* each rank's cache leaves equal to the JAX global cache's block of that
  rank under ``cache_specs`` (k/v by sequence, the cross cache and SSM
  state by head, the latent replicated), the attention caches in bf16
  within one bf16 step (``rtol=2**-7``), the SSM state at float32's;
* the first token's logits (rows over ``data``, vocab blocks over
  ``model``) within ``rtol=2e-4`` and ``atol`` 2e-5 of the logits' largest
  magnitude, and two decode steps' from the JAX prefill's caches (each
  rank's block; fed the JAX run's greedy tokens) likewise. From the
  port's own caches a last-bit float32 difference can round a bf16 cache
  entry to its neighbour (3 of deepseek's latent entries), which the MoE
  amplifies: a decode logit 2e-3 off at a scale of 3.8, at 1 x 1 as on
  the mesh; the caches test above holds that rounding to one step;
* the port's ``classic_loop`` ids (4 new tokens) identical to the JAX
  ``classic_loop``'s on the same mesh shape, also for ``--classic`` qwen3
  on (2, 1).

The ring (``make_serve_step(..., ring=True)``) on a mesh has its own
cases in ``test_torch_ring.py``.
"""
import argparse
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import mesh as M  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.common import MeshPlan  # noqa: E402
from repro_torch.models.model_zoo import cache_specs  # noqa: E402
from repro_torch.train.steps import make_serve_step  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
CPU = "cpu"
F32 = dict(rtol=2e-4, atol=2e-5)

#: constants both processes read
SHARED = r'''
B, S, GEN = 4, 16, 4             # the classic loop's batch, prompt, tokens
MESHES = [(1, 2), (2, 1), (2, 2)]
FRONTENDS = ["whisper-medium", "pixtral-12b"]
TOKEN_ARCHS = ["qwen3-1.7b", "deepseek-v2-lite-16b", "mamba2-370m"]
CASES = ([(a, s) for a in FRONTENDS for s in MESHES]
         + [(a, (1, 2)) for a in TOKEN_ARCHS])
LOOPS = [(a, s) for a in FRONTENDS for s in MESHES] + [("qwen3-1.7b",
                                                        (2, 1))]


def tag(shape):
    return f"{shape[0]}x{shape[1]}"


def cache_len(shape):
    """The classic loop's: prompt + gen + 8, up to a multiple of M."""
    m = shape[1]
    return -(-(S + GEN + 8) // m) * m
'''
exec(SHARED)

JAX_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
out_dir = sys.argv[2]
import argparse
import numpy as np
import jax
import jax.numpy as jnp
from repro.configs.registry import get_config
from repro.launch import serve as jax_serve
from repro.models.model_zoo import build_model
from repro.train import steps as jax_steps
from repro_torch.configs.registry import get_config as port_config
from repro_torch.models.convert import unstack_layers
exec(open(os.path.join(out_dir, "shared.py")).read())
inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
res = {}


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


# one make_serve_step an arch, mesh and cache length, which the classic
# loop's own call gets too (it imports the name when it runs)
built, real = {}, jax_steps.make_serve_step


def make_serve_step(cfg, mesh, cache_len=0, **kw):
    key = (cfg.name, mesh.devices.shape, cache_len)
    if key not in built:
        built[key] = real(cfg, mesh, cache_len=cache_len, **kw)
    return built[key]


jax_steps.make_serve_step = make_serve_step
one = {}
for arch, shape in CASES:
    cfg, t = get_config(arch).reduced(), tag(shape)
    mesh = mesh_of(shape)
    plan = jax_steps.plan_from_mesh(mesh)
    params = build_model(cfg, plan).init(jax.random.PRNGKey(0))
    if arch not in one:
        one[arch] = build_model(cfg, jax_steps.plan_from_mesh(
            mesh_of((1, 1)))).init(jax.random.PRNGKey(0))
    # the classic loop's params on the mesh are the 1 x 1 init's
    assert all(bool((a == b).all()) for a, b in zip(
        jax.tree.leaves(params), jax.tree.leaves(one[arch])))
    ss = make_serve_step(cfg, mesh, cache_len=cache_len(shape))
    batch = {k.split("/")[1]: jnp.asarray(v) for k, v in inp.items()
             if k.startswith(arch + "/")}
    h, caches = ss.prefill_fn(params, batch)
    res[f"h_{arch}_{t}"] = np.asarray(h)
    for li, c in enumerate(unstack_layers(jax.device_get(caches),
                                          port_config(arch).reduced())):
        for k, v in c.items():
            res[f"cache_{arch}_{t}/{li}/{k}"] = np.asarray(v, np.float32)
    # the classic loop's own calls: its decode then reuses this compile
    logits = ss.logits_fn(params, h)
    res[f"logits_{arch}_{t}_0"] = np.asarray(logits)
    pos = jnp.full((B,), S, jnp.int32)
    for i in range(2):
        tok = jax_steps.greedy_from_logits(logits, cfg.vocab_size)
        res[f"tok_{arch}_{t}_{i}"] = np.asarray(tok)
        logits, caches = ss.decode_fn(params, caches, tok, pos)
        res[f"logits_{arch}_{t}_{i + 1}"] = np.asarray(logits)
        pos = pos + 1

real_stack = np.stack
for arch, shape in LOOPS:
    caught = []

    def stack(arrays, axis=0, **kw):
        out = real_stack(arrays, axis=axis, **kw)
        caught.append(out)
        return out
    np.stack = stack
    args = argparse.Namespace(batch=B, prompt_len=S, gen=GEN, cache_len=0)
    jax_serve.classic_loop(get_config(arch).reduced(), args, mesh_of(shape))
    np.stack = real_stack
    (ids,) = [a for a in caught if a.shape == (B, GEN + 1)]
    res[f"ids_{arch}_{tag(shape)}"] = ids
np.savez(os.path.join(out_dir, "jax.npz"), **res)
print("JAX-OK")
"""


def _inputs():
    """Each arch's prefill batch, drawn as the classic loop draws it
    (numpy seed 0)."""
    out = {}
    for arch in FRONTENDS + TOKEN_ARCHS:
        batch = launch_serve.classic_batch(get_config(arch).reduced(), B, S,
                                           np.random.default_rng(0))
        out.update({f"{arch}/{k}": v for k, v in batch.items()})
    return out


def _state(arch):
    """The JAX params of ``PRNGKey(0)`` (the classic loop's) as a port
    ``state_dict``."""
    from repro.configs.registry import get_config as jax_config
    from repro.models.model_zoo import build_model as jax_build
    from repro.models.common import MeshPlan as JaxMeshPlan
    from repro_torch.models.convert import params_from_jax
    params = jax_build(jax_config(arch).reduced(), JaxMeshPlan(
        ("data", "model"), (1, 1))).init(jax.random.PRNGKey(0))
    return params_from_jax(jax.device_get(params),
                           get_config(arch).reduced())


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_frontend_mesh")
    inputs = _inputs()
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


@pytest.fixture(scope="module")
def states():
    return {arch: _state(arch) for arch in FRONTENDS + TOKEN_ARCHS}


def _plan(shape):
    return MeshPlan(("data", "model"), shape)


def _jax_blocks(jx, arch, shape, like, mesh):
    """The JAX prefill's caches cut into each rank's block under
    ``cache_specs``, in the dtypes of the port's (``like``)."""
    specs = cache_specs(get_config(arch).reduced(), _plan(shape),
                        ("data",))

    def block(r, li, key, sp, dtype):
        whole = jx[f"cache_{arch}_{tag(shape)}/{li}/{key}"]
        cut = whole[M.shard_slices(whole.shape, sp, shape, mesh.coords(r))]
        # a copy: decode writes its caches in place
        return torch.from_numpy(np.array(cut)).to(dtype)
    return [[{k: block(r, li, k, sp[k], t.dtype) for k, t in c.items()}
             for li, (c, sp) in enumerate(zip(rank, specs))]
            for r, rank in enumerate(like)]


@pytest.fixture(scope="module")
def port_runs(jax_side, states):
    """Each case's prefill (hidden, the ranks' caches), first-token logits
    and two decode steps fed the JAX run's greedy tokens, from the JAX
    prefill's caches (each rank's block)."""
    inputs, jx = jax_side
    out = {}
    for arch, shape in CASES:
        cfg, t = get_config(arch).reduced(), tag(shape)
        ss = make_serve_step(cfg, _plan(shape), cache_len=cache_len(shape),
                             device=CPU)
        params = ss.shard_params_fn(states[arch])
        batch = {k.split("/")[1]: v for k, v in inputs.items()
                 if k.startswith(arch + "/")}
        h, caches = ss.prefill_fn(params, batch)
        logits = [ss.logits_fn(params, h)]
        decode = _jax_blocks(jx, arch, shape, caches, ss.mesh)
        pos = torch.full((B,), S, dtype=torch.int32)
        for i in range(2):
            tok = torch.from_numpy(jx[f"tok_{arch}_{t}_{i}"])
            step, decode = ss.decode_fn(params, decode, tok, pos)
            logits.append(step)
            pos = pos + 1
        out[arch, shape] = dict(h=h, caches=caches, logits=logits,
                                mesh=ss.mesh)
    return out


IDS = [f"{a}-{tag(s)}" for a, s in CASES]


def _scaled(want):
    return dict(rtol=F32["rtol"],
                atol=F32["atol"] * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_prefill_hidden_matches_the_jax_mesh_step(jax_side, port_runs, arch,
                                                  shape):
    got = port_runs[arch, shape]["h"]
    want = jax_side[1][f"h_{arch}_{tag(shape)}"]
    assert tuple(got.shape) == want.shape == (B, 1, get_config(
        arch).reduced().d_model)
    assert_allclose(got.numpy(), want, **_scaled(want))


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_each_ranks_caches_are_its_block_of_the_jax_caches(jax_side,
                                                           port_runs, arch,
                                                           shape):
    """Every rank's every cache leaf is the JAX global cache's block of
    that rank under ``cache_specs`` over the data axes."""
    jx = jax_side[1]
    cfg, t = get_config(arch).reduced(), tag(shape)
    run = port_runs[arch, shape]
    mesh = run["mesh"]
    specs = cache_specs(cfg, _plan(shape), ("data",))
    seen = set()
    for r, rank in enumerate(run["caches"]):
        assert len(rank) == cfg.num_layers
        for li, (cache, sp) in enumerate(zip(rank, specs)):
            assert set(cache) == set(sp)
            for key, got in cache.items():
                want = jx[f"cache_{arch}_{t}/{li}/{key}"]
                block = want[M.shard_slices(want.shape, sp[key], shape,
                                            mesh.coords(r))]
                assert tuple(got.shape) == block.shape, (r, li, key)
                tol = (dict(rtol=2 ** -7, atol=1e-6)
                       if got.dtype == torch.bfloat16 else F32)
                assert_allclose(got.float().numpy(), block, **tol,
                                err_msg=f"rank {r} layer {li} {key}")
                seen.add(key)
    want_keys = {"whisper-medium": {"k", "v", "xk", "xv"},
                 "pixtral-12b": {"k", "v"}, "qwen3-1.7b": {"k", "v"},
                 "deepseek-v2-lite-16b": {"c", "kpe"},
                 "mamba2-370m": {"h", "tail_x", "tail_bc"}}[arch]
    assert seen == want_keys


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_first_token_and_two_decode_steps_match(jax_side, port_runs, arch,
                                                shape):
    jx = jax_side[1]
    for i, got in enumerate(port_runs[arch, shape]["logits"]):
        want = jx[f"logits_{arch}_{tag(shape)}_{i}"]
        assert tuple(got.shape) == want.shape
        assert_allclose(got.numpy(), want, **_scaled(want),
                        err_msg=f"step {i}")


@pytest.mark.parametrize("arch,shape", LOOPS,
                         ids=[f"{a}-{tag(s)}" for a, s in LOOPS])
def test_classic_loop_ids_match_the_jax_classic_loop(jax_side, states, arch,
                                                     shape, capsys):
    """``classic_loop`` on the ``--mesh`` of the same shape, serving the
    JAX loop's params (the 1 x 1 init of ``PRNGKey(0)``, which its mesh
    init equals): the same ids, and the loop's own lines."""
    args = argparse.Namespace(batch=B, prompt_len=S, gen=GEN, cache_len=0,
                              seed=0, device=CPU, mesh=tag(shape))
    gen = launch_serve.classic_loop(get_config(arch).reduced(), args,
                                    params=states[arch])
    np.testing.assert_array_equal(gen, jax_side[1][
        f"ids_{arch}_{tag(shape)}"])
    assert "serve ok (classic loop)" in capsys.readouterr().out


def test_shard_batch_false_replicates_rows_and_keeps_the_caches_whole():
    """``shard_batch=False`` (the long_500k plan's) on (2, 2): each rank
    holds every row (caches of the whole batch, the model axis still
    splitting the sequence), and the logits equal the row-split step's."""
    cfg = get_config("qwen3-1.7b").reduced()
    split = make_serve_step(cfg, _plan((2, 2)), cache_len=32, device=CPU)
    whole = make_serve_step(cfg, _plan((2, 2)), cache_len=32, device=CPU,
                            shard_batch=False)
    assert set(map(str, whole.batch_specs.values())) == {"(B, B)"}
    params = split.init_params(1)
    batch = launch_serve.classic_batch(cfg, B, S, np.random.default_rng(3))
    got = {}
    for name, ss in (("split", split), ("whole", whole)):
        h, caches = ss.prefill_fn(params, batch)
        rows = caches[0][0]["k"].shape[0]
        assert rows == (B if name == "whole" else B // 2)
        assert caches[0][0]["k"].shape[1] == 16
        logits, _ = ss.decode_fn(params, caches, torch.arange(B).int(),
                                 torch.full((B,), S, dtype=torch.int32))
        got[name] = (ss.logits_fn(params, h), logits)
    for a, b in zip(got["split"], got["whole"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_cache_len_must_split_and_the_loop_rounds_it(capsys):
    cfg = get_config("whisper-medium").reduced()
    with pytest.raises(ValueError, match="does not split over tp = 4"):
        make_serve_step(cfg, _plan((1, 4)), cache_len=30, device=CPU)
    # 6 + 2 + 8 = 16 -> 16; with --cache-len 13 -> 16 on four ranks
    gen = launch_serve.main(["--arch", "whisper-medium", "--smoke",
                             "--device", CPU, "--mesh", "1x4", "--batch",
                             "2", "--prompt-len", "6", "--gen", "2",
                             "--cache-len", "13"])
    assert gen.shape == (2, 3)
    assert "serve ok (classic loop)" in capsys.readouterr().out
    wide = dataclasses.replace(cfg, num_heads=6)
    with pytest.raises(ValueError, match="do not split over tp = 4"):
        make_serve_step(wide, _plan((1, 4)), cache_len=32, device=CPU)
