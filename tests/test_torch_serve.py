"""The port's ServeSession against the JAX package's, token for token.

Both packages serve ``qwen3-1.7b.reduced()`` with ``vocab_size=1000``
(padded to 1024 logit columns, so greedy selection must mask 24 junk
columns) from the same JAX-initialised params, built as
``tests/test_serve_pipeline.py`` builds its sessions: 5 requests of unequal
generation lengths through 2 groups of 1 slot (so requests retire and are
admitted mid-flight), then prompts of unequal lengths. Greedy decode must
be token-identical across the packages and across the port's backends.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import api as jax_api  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.model_zoo import build_model as jax_build  # noqa: E402
from repro.train.steps import plan_from_mesh  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_decode import kernel as fd_kernel  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

PROMPT_LEN = 8
GENS = [3, 6, 2, 5, 4]          # unequal generation lengths
CACHE_LEN = 24
GEOMETRY = dict(num_groups=2, group_size=1, max_prompt_len=PROMPT_LEN,
                max_new_tokens=max(GENS), cache_len=CACHE_LEN)


def _mesh():
    """The reference's 1x1 mesh with Auto axes. jax 0.9 makes Explicit axes
    by default, and the reference's serving path scatters a slot into its
    mesh-typed group caches, which only Auto axes accept."""
    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((1, 1), ("data", "model"), **kw)


@pytest.fixture(scope="module")
def env():
    cfg_j = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                                vocab_size=1000)
    cfg_t = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                                vocab_size=1000)
    mesh = _mesh()
    params = jax_build(cfg_j, plan_from_mesh(mesh)).init(jax.random.PRNGKey(0))
    state = params_from_jax(jax.device_get(params), cfg_t)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 1000, (PROMPT_LEN,)).astype(np.int32)
               for _ in GENS]
    return cfg_j, cfg_t, mesh, params, state, prompts


def _jax_session(env, backend):
    cfg_j, _, mesh, params, _, _ = env
    kw = dict(stages=2) if backend == "actors" else {}
    return jax_api.compile(cfg_j, mode="serve", backend=backend,
                           params=params, mesh=mesh, **kw, **GEOMETRY)


def _port_session(env, backend):
    kw = dict(stages=2) if backend == "actors" else {}
    return api.compile(env[1], mode="serve", backend=backend,
                       params=env[4], device="cpu", **kw, **GEOMETRY)


@pytest.fixture(scope="module")
def sessions(env):
    out = {}
    for backend in ("actors", "monolithic"):
        out[("jax", backend)] = _jax_session(env, backend)
        out[("port", backend)] = _port_session(env, backend)
    yield out
    for s in out.values():
        s.close()


@pytest.fixture(scope="module")
def unequal_gens(env, sessions):
    """Every session's tokens for the unequal-generation request set."""
    reqs = list(zip(env[5], GENS))
    return {key: (s.generate(reqs), dict(s.last_stats))
            for key, s in sessions.items()}


@pytest.mark.parametrize("backend", ["actors", "monolithic"])
def test_port_matches_jax_token_for_token(env, unequal_gens, backend):
    want, _ = unequal_gens[("jax", backend)]
    got, stats = unequal_gens[("port", backend)]
    assert [len(o) for o in got] == GENS
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), f"request {i}: port {g} != jax {w}"
    assert stats["admitted_mid_flight"] >= 1
    assert stats["tokens"] == sum(GENS)
    # padded-vocab columns never leak into the output
    assert all((o >= 0).all() and (o < env[1].vocab_size).all() for o in got)


def test_port_actors_match_port_monolithic(unequal_gens):
    a, sa = unequal_gens[("port", "actors")]
    b, sb = unequal_gens[("port", "monolithic")]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for key in ("prefill_items", "decode_items", "rounds"):
        assert sa[key] == sb[key]
    assert sa["prefill_items"] == len(GENS)


@pytest.mark.parametrize("backend", ["actors", "monolithic"])
def test_unequal_prompt_lengths_match_jax(env, sessions, backend):
    """Prompts of different lengths run at their natural length."""
    p = env[5]
    reqs = [(p[0][:5], 3), (p[1], 4), (p[2][:7], 2), (p[3][:1], 3)]
    want = sessions[("jax", backend)].generate(reqs)
    got = sessions[("port", backend)].generate(reqs)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert all((o < env[1].vocab_size).all() for o in got)


def test_cpu_serving_launches_no_kernel(env, sessions, unequal_gens):
    assert fa_kernel.launches == 0 and fd_kernel.launches == 0


def test_history_and_describe(sessions, unequal_gens):
    sess = sessions[("port", "actors")]
    rep = sess.describe()
    assert "mode=serve" in rep and "backend=actors" in rep
    assert "stage 0" in rep and "stage 1" in rep
    assert "static analysis: PASS (passes: deadlock, memory;" in rep
    assert "static peak bytes [stage1]" in rep
    assert {h["kind"] for h in sess.history} == {"round", "generate"}


def test_compile_without_device_raises_without_card(env, monkeypatch):
    """device=None means the card; with none present compile raises and
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.compile(env[1], mode="serve", params=env[4], **GEOMETRY)
