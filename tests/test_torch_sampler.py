"""The port's sampler against the JAX package's.

The port cannot reproduce ``jax.random``'s streams, so sampled tokens are
held to the reference where the draw is forced (``temperature=0``, and
``top_k=1`` at any temperature: exact, token for token, on reduced qwen3
with ``vocab_size=1000`` as ``tests/test_torch_serve.py`` serves it), and
otherwise to the reference's filter rule (the kept set is equal; every
token the JAX ``SamplerStream`` draws lies in the port's kept set), to the
distribution (a chi-square test of 20,000 draws on a 16-token vocab, p-value
floor 1e-3 at a fixed seed) and to the port's own reproducibility (a seed
repeats its tokens, actors ≡ monolithic).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import api as jax_api  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.model_zoo import build_model as jax_build  # noqa: E402
from repro.serve import sampler as jsampler  # noqa: E402
from repro.train.steps import plan_from_mesh  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.sampler import (SamplerStream,  # noqa: E402
                                       SamplingSpec, filter_logits)
from torch_threads import one_intra_op_thread  # noqa: E402,F401

PROMPT_LEN = 8
GENS = [3, 6, 2, 5, 4]
GEOMETRY = dict(num_groups=2, group_size=1, max_prompt_len=PROMPT_LEN,
                max_new_tokens=max(GENS), cache_len=24)
SAMPLED = SamplingSpec(temperature=0.8, top_k=50, top_p=0.95, seed=1)


def _mesh():
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
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, mesh=mesh, params=params,
                state=state, reqs=list(zip(prompts, GENS)))


def _port(env, backend="monolithic", **kw):
    extra = dict(stages=2) if backend == "actors" else {}
    with api.compile(env["cfg_t"], mode="serve", backend=backend,
                     params=env["state"], device="cpu", **extra, **GEOMETRY,
                     **kw) as sess:
        return sess.generate(env["reqs"])


def _jax(env, **kw):
    sess = jax_api.compile(env["cfg_j"], mode="serve", backend="monolithic",
                           params=env["params"], mesh=env["mesh"],
                           **GEOMETRY, **kw)
    return sess.generate(env["reqs"])


@pytest.fixture(scope="module")
def jax_greedy(env):
    return _jax(env)


def _same(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        assert np.array_equal(x, y), f"request {i}: {x} != {y}"


@pytest.mark.parametrize("bad, match", [
    (dict(temperature=-0.5), "temperature"),
    (dict(top_k=-1), "top_k"),
    (dict(top_k=2.0), "top_k"),
    (dict(top_p=0.0), "top_p"),
    (dict(top_p=1.5), "top_p"),
    (dict(seed="1"), "seed"),
])
def test_sampling_spec_validation(bad, match):
    with pytest.raises(ValueError, match=match) as want:
        jsampler.SamplingSpec(**bad)
    with pytest.raises(ValueError, match=match) as got:
        SamplingSpec(**bad)
    assert str(got.value) == str(want.value)


def test_compile_takes_only_a_sampling_spec(env):
    with pytest.raises(ValueError, match="SamplingSpec"):
        api.compile(env["cfg_t"], mode="serve", params=env["state"],
                    device="cpu", sampling="nucleus", **GEOMETRY)


@pytest.mark.parametrize("spec", [
    SamplingSpec(temperature=0.0, seed=3),
    SamplingSpec(temperature=1.3, top_k=1, seed=4),
    SamplingSpec(temperature=0.5, top_k=1, top_p=0.5, seed=5),
], ids=["greedy", "top1", "top1-nucleus"])
@pytest.mark.parametrize("backend", ["actors", "monolithic"])
def test_forced_draws_match_jax(env, jax_greedy, spec, backend):
    """temperature=0 is the greedy path; top_k=1 leaves one token whatever
    the temperature: both are the JAX session's tokens."""
    got = _port(env, backend, sampling=spec)
    _same(got, jax_greedy)
    want = _jax(env, sampling=jsampler.SamplingSpec(**dataclasses.asdict(
        spec)))
    _same(got, want)


def test_temperature_zero_is_the_greedy_path(env):
    _same(_port(env, sampling=SamplingSpec(temperature=0.0)), _port(env))


def _reference_kept(logits, spec, vocab_size):
    """The kept set by the reference's rule (``sampler.py:61-75``), in jnp."""
    z = jnp.where(jnp.arange(logits.shape[-1]) >= vocab_size, -jnp.inf,
                  jnp.asarray(logits, jnp.float32))
    z = z / spec.temperature
    if 0 < spec.top_k < vocab_size:
        kth = jax.lax.top_k(z, spec.top_k)[0][..., -1:]
        z = jnp.where(z < kth, -jnp.inf, z)
    if spec.top_p < 1.0:
        sz = -jnp.sort(-z, axis=-1)
        probs = jax.nn.softmax(sz, axis=-1)
        keep = jnp.cumsum(probs, axis=-1) - probs < spec.top_p
        thr = jnp.min(jnp.where(keep, sz, jnp.inf), axis=-1, keepdims=True)
        z = jnp.where(z < thr, -jnp.inf, z)
    return np.isfinite(np.asarray(z))


FILTERS = [SamplingSpec(0.8, 50, 0.95, 1), SamplingSpec(1.0, 0, 0.5, 2),
           SamplingSpec(2.0, 7, 1.0, 3), SamplingSpec(0.3, 0, 1.0, 4),
           SamplingSpec(1.0, 3, 0.2, 5)]


@pytest.mark.parametrize("spec", FILTERS, ids=str)
def test_kept_set_matches_reference_rule(spec):
    V, Vp = 1000, 1024
    logits = np.random.default_rng(11).normal(
        scale=3.0, size=(16, Vp)).astype(np.float32)
    got = torch.isfinite(filter_logits(torch.from_numpy(logits), spec, V))
    want = _reference_kept(logits, spec, V)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.any(dim=-1).all() and not got[:, V:].any()
    # every token the JAX stream draws lies in the port's kept set
    stream = jsampler.SamplerStream(
        jsampler.SamplingSpec(**dataclasses.asdict(spec)), V)
    for _ in range(20):
        toks = np.asarray(stream.sample(jnp.asarray(logits)))
        assert got.numpy()[np.arange(16), toks].all()


def test_draws_follow_the_filtered_softmax():
    """Chi-square of 20,000 draws from one row against the filtered
    softmax, on a 16-token vocab (13 real, 3 padded columns); p > 1e-3 at
    this fixed seed."""
    stats = pytest.importorskip("scipy.stats")
    spec = SamplingSpec(temperature=0.7, top_k=10, top_p=0.97, seed=123)
    logits = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 16)).astype(np.float32))
    z = filter_logits(logits, spec, 13)[0].double()
    kept = torch.isfinite(z)
    probs = torch.softmax(z, dim=-1)
    draws = SamplerStream(spec, 13, "cpu").sample(logits.expand(20000, 16))
    counts = torch.bincount(draws.long(), minlength=16)
    assert counts[~kept].sum() == 0
    n = int(draws.numel())
    res = stats.chisquare(counts[kept].numpy(),
                          (probs[kept] * n).numpy())
    assert res.pvalue > 1e-3, res


def test_seed_repeats_and_another_seed_differs():
    logits = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 64)).astype(np.float32))
    a, b = (SamplerStream(SamplingSpec(seed=9), 60, "cpu") for _ in range(2))
    c = SamplerStream(SamplingSpec(seed=10), 60, "cpu")
    ta = [a.sample(logits) for _ in range(5)]
    tb = [b.sample(logits) for _ in range(5)]
    tc = [c.sample(logits) for _ in range(5)]
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))
    assert not all(torch.equal(x, y) for x, y in zip(ta, tc))
    # the stream advances: one stream's draws are not all alike
    assert not all(torch.equal(ta[0], x) for x in ta[1:])


@pytest.fixture(scope="module")
def sampled(env):
    return {backend: _port(env, backend, sampling=SAMPLED)
            for backend in ("actors", "monolithic")}


def test_sampled_actors_match_monolithic(env, sampled, jax_greedy):
    _same(sampled["actors"], sampled["monolithic"])
    assert all((o >= 0).all() and (o < 1000).all()
               for o in sampled["actors"])
    # the sampler changed something: not the greedy tokens
    assert any(not np.array_equal(x, y)
               for x, y in zip(sampled["monolithic"], jax_greedy))


def test_sampled_seed_repeats_and_differs(env, sampled):
    _same(_port(env, sampling=SAMPLED), sampled["monolithic"])
    other = _port(env, sampling=dataclasses.replace(SAMPLED, seed=2))
    assert any(not np.array_equal(x, y)
               for x, y in zip(other, sampled["monolithic"]))


def test_sampled_paged_chunked_actors_match_monolithic(env):
    """Chunked prefill draws once, at its final chunk: the same stream on
    both backends."""
    kw = dict(sampling=SAMPLED, cache="paged", page_len=4, num_pages=8,
              prefill_chunk=3)
    _same(_port(env, "actors", **kw), _port(env, **kw))


def test_describe_names_the_sampler(env):
    sess = api.compile(env["cfg_t"], mode="serve", params=env["state"],
                       device="cpu", sampling=SAMPLED, **GEOMETRY)
    with sess:
        assert ("sampling: temperature=0.8 top_k=50 top_p=0.95 seed=1"
                in sess.describe())
