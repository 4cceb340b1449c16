"""The port's paged serving against the JAX package's: the page pool, the
four paged index programs, chunked prefill, shared-prefix pages and the
analytic cache bytes.

The geometry is ``tests/test_paged_serve.py``'s: reduced qwen2.5-3b with
``vocab_size=1000`` (padded to 1024 logit columns), 8-token prompts, 5
requests of unequal generation lengths through 2 groups of 1 slot,
``cache_len`` 24, ``page_len`` 4 and 8 pages, so pages are recycled. Both
packages serve the same JAX-initialised params (carried across by
``models/convert.py``) on a 1x1 mesh with Auto axes, with which the
reference's paged path runs (jax 0.9 makes Explicit axes by default, and
then the reference's cache scatters raise). Greedy tokens are held exact:
the port paged ≡ the port dense ≡ the JAX dense ``ServeSession``; the
index programs are plain copies, so they are held bitwise.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import api as jax_api  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.model_zoo import build_model as jax_build  # noqa: E402
from repro.models.model_zoo import make_decode_caches as jax_caches  # noqa: E402
from repro.serve import paged_cache as jpc  # noqa: E402
from repro.train.steps import plan_from_mesh  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_decode import kernel as fd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.models.common import MeshPlan  # noqa: E402
from repro_torch.models.convert import (params_from_jax,  # noqa: E402
                                        unstack_layers)
from repro_torch.models.model_zoo import make_decode_caches  # noqa: E402
from repro_torch.serve.admission import AdmissionScheduler  # noqa: E402
from repro_torch.serve.paged_cache import (PagedCacheSpec,  # noqa: E402
                                           PagedStageCache, PagePool)
from repro_torch.runtime.pipeline import (DecodeWork,  # noqa: E402
                                          PrefillChunkWork)
from torch_threads import one_intra_op_thread  # noqa: E402,F401

PROMPT_LEN = 8
GENS = [3, 6, 2, 5, 4]
CACHE_LEN = 24
PAGE_LEN = 4
NUM_PAGES = 8
PAGED = dict(cache="paged", page_len=PAGE_LEN, num_pages=NUM_PAGES)


def _mesh():
    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((1, 1), ("data", "model"), **kw)


def _env(arch: str, seed: int):
    cfg_j = dataclasses.replace(jax_get_config(arch).reduced(),
                                vocab_size=1000)
    cfg_t = dataclasses.replace(get_config(arch).reduced(), vocab_size=1000)
    mesh = _mesh()
    params = jax_build(cfg_j, plan_from_mesh(mesh)).init(
        jax.random.PRNGKey(0))
    state = params_from_jax(jax.device_get(params), cfg_t)
    rng = np.random.default_rng(seed)
    return SimpleNamespace(cfg_j=cfg_j, cfg_t=cfg_t, mesh=mesh,
                           params=params, state=state, rng=rng)


@pytest.fixture(scope="module")
def env():
    e = _env("qwen2.5-3b", 0)
    e.prompts = [e.rng.integers(0, 1000, (PROMPT_LEN,)).astype(np.int32)
                 for _ in GENS]
    return e


def _geo(**over):
    kw = dict(num_groups=2, group_size=1, max_prompt_len=PROMPT_LEN,
              max_new_tokens=max(GENS), cache_len=CACHE_LEN)
    kw.update(over)
    return kw


def _jax(env, backend="monolithic", **kw):
    extra = dict(stages=2) if backend == "actors" else {}
    return jax_api.compile(env.cfg_j, mode="serve", backend=backend,
                           params=env.params, mesh=env.mesh, **extra,
                           **_geo(**kw))


def _port(env, backend="monolithic", **kw):
    extra = dict(stages=2) if backend == "actors" else {}
    return api.compile(env.cfg_t, mode="serve", backend=backend,
                       params=env.state, device="cpu", **extra,
                       **_geo(**kw))


def _serve(session, reqs):
    with session:
        out = session.generate(reqs)
    return out, dict(session.last_stats)


def _same(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert np.array_equal(x, y), f"request {i}: {x} != {y}"


@pytest.fixture(scope="module")
def streams(env):
    """Every session's tokens for the unequal-generation request set."""
    reqs = list(zip(env.prompts, GENS))
    return {
        "jax dense": _serve(_jax(env), reqs),
        "port dense": _serve(_port(env), reqs),
        "port paged monolithic": _serve(_port(env, **PAGED), reqs),
        "port paged actors": _serve(_port(env, "actors", **PAGED), reqs),
        "jax chunked": _serve(_jax(env, prefill_chunk=3, **PAGED), reqs),
        "port chunked monolithic": _serve(
            _port(env, prefill_chunk=3, **PAGED), reqs),
        "port chunked actors": _serve(
            _port(env, "actors", prefill_chunk=3, **PAGED), reqs),
    }


# ---------------------------------------------------------------------------
# the page pool: a copy of the reference's numpy bookkeeping
# ---------------------------------------------------------------------------

def _pool_trace(mod, seed: int):
    """A seeded sequence of allocs (some sharing a live row's pages) and
    frees through ``mod.PagePool``; every observable after each step."""
    spec = mod.PagedCacheSpec(page_len=4, num_pages=10, max_requests=4,
                              pages_per_req=6)
    pool = mod.PagePool(spec)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(40):
        sid = int(rng.integers(0, 5))        # 4 is out of range
        if rng.random() < 0.4:
            try:
                pool.free(min(sid, 3))
                out.append(("free", sid))
            except Exception as e:  # noqa: BLE001 -- errors are compared
                out.append(("error", type(e).__name__, str(e)))
        else:
            n_own = int(rng.integers(0, 8))
            donors = [s for s in range(4) if (pool.page_table[s] >= 0).any()]
            shared = []
            if donors and rng.random() < 0.5:
                d = donors[int(rng.integers(0, len(donors)))]
                row = pool.page_table[d]
                shared = [int(p) for p in row[:int(rng.integers(1, 3))]
                          if p >= 0]
            try:
                w = pool.alloc(sid, n_own, shared)
                out.append(("alloc", w.tolist()))
            except Exception as e:  # noqa: BLE001
                out.append(("error", type(e).__name__, str(e)))
        out.append((pool.page_table.tolist(), pool.ref_counts.tolist(),
                    pool.free_count(), pool.used_pages(), pool.peak_pages,
                    pool.rows([-1, 0, 2]).tolist()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_page_pool_matches_reference(seed):
    from repro_torch.serve import paged_cache as tpc
    want, got = _pool_trace(jpc, seed), _pool_trace(tpc, seed)
    assert got == want
    assert any(step[0] == "error" for step in got)      # errors exercised


def test_spec_geometry_must_match_cache_len():
    spec = PagedCacheSpec(page_len=4, num_pages=8, max_requests=2,
                          pages_per_req=5)
    with pytest.raises(ValueError, match="cache_len"):
        PagedStageCache(stage=None, group_size=1, cache_len=24, spec=spec)


# ---------------------------------------------------------------------------
# the four paged index programs against the reference's _build_paged_ops
# ---------------------------------------------------------------------------

OPS_B, OPS_L = 3, 24
OPS_SPEC = dict(page_len=4, num_pages=20, max_requests=4, pages_per_req=6)


@pytest.fixture(scope="module", params=["qwen2.5-3b", "mamba2-370m"])
def ops_env(request):
    """Both packages' paged state of one stage over the whole reduced
    stack, filled with the same seeded values."""
    arch = request.param
    cfg_j = jax_get_config(arch).reduced()
    cfg_t = get_config(arch).reduced()
    plan_t = MeshPlan.single_device()
    jspec = jpc.PagedCacheSpec(**OPS_SPEC)
    tspec = PagedCacheSpec(**OPS_SPEC)
    stage = SimpleNamespace(
        device=torch.device("cpu"),
        init_caches=lambda batch, device=None: make_decode_caches(
            cfg_t, plan_t, batch, OPS_L, device))
    cache = PagedStageCache(stage, OPS_B, OPS_L, tspec)
    rng = np.random.default_rng(7)
    for layer in cache.pages():
        for t in layer.values():
            t.copy_(torch.from_numpy(
                rng.normal(size=t.shape).astype(np.float32)))
    template = jax.eval_shape(lambda: jax_caches(
        cfg_j, plan_from_mesh(_mesh()), OPS_B, OPS_L))
    pages = [{k: t.numpy() for k, t in layer.items()}
             for layer in cache.pages()]
    slabs = _stack_like(template, pages)
    fns = jpc._build_paged_ops(jspec, OPS_B, OPS_L)
    return SimpleNamespace(cfg_j=cfg_j, cache=cache, slabs=slabs, fns=fns,
                           rng=rng, template=template)


def _stack_like(template, per_layer):
    """Per-layer numpy arrays (slabs or windows) -> the reference's
    ``{"prologue", "body"}`` tree of ``template``'s structure (body leaves
    stacked over periods)."""
    n_pro = len(template["prologue"])
    n_slots = len(template["body"])
    pro = [{k: jnp.asarray(per_layer[i][k]) for k in template["prologue"][i]}
           for i in range(n_pro)]
    body = []
    for j, blk in enumerate(template["body"]):
        n_per = next(iter(blk.values())).shape[0]
        body.append({k: jnp.asarray(np.stack(
            [per_layer[n_pro + i * n_slots + j][k] for i in range(n_per)]))
            for k in blk})
    return {"prologue": pro, "body": body}


def _layers(tree, cfg_j):
    return [{k: np.asarray(v) for k, v in layer.items()}
            for layer in unstack_layers(jax.device_get(tree), cfg_j)]


def _assert_slabs_equal(e):
    got = [{k: t.numpy() for k, t in layer.items()}
           for layer in e.cache.pages()]
    want = _layers(e.slabs, e.cfg_j)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i}.{k}")
    # the zero sentinel rows stay zero whatever was dropped onto the trash
    for layer in e.cache.slabs:
        for k, t in layer.items():
            assert not t[-2].any(), f"zero sentinel of {k} was written"


def _rows(rng, spec):
    """Page-table rows with unmapped entries; no page is named twice (two
    writes to one position would land in either order)."""
    n = OPS_B * spec["pages_per_req"]
    rows = rng.permutation(spec["num_pages"])[:n].reshape(
        OPS_B, -1).astype(np.int32)
    rows[rng.random(rows.shape) < 0.3] = -1
    rows[1] = -1                       # a parked slot: nothing mapped
    return rows


def _i32(a):
    return torch.as_tensor(np.asarray(a, np.int32))


def _window_np(e):
    """Seeded dense-window values in the group cache's shapes."""
    return [{k: e.rng.normal(size=leaf.shape).astype(np.float32)
             for k, leaf in layer.items()}
            for layer in unstack_layers(
                jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                             e.template), e.cfg_j)]


def test_paged_gather_matches_reference(ops_env):
    e = ops_env
    rows = _rows(e.rng, OPS_SPEC)
    sids = np.array([2, -1, 0], np.int32)
    got = e.cache._fns["gather"](e.cache.slabs, _i32(rows), _i32(sids))
    want = _layers(e.fns["gather"](e.slabs, rows, sids), e.cfg_j)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    # the parked slot (unmapped row, sid -1) reads zeros
    for g in got:
        for t in g.values():
            assert not t[1].any()


def test_paged_scatters_match_reference(ops_env):
    """scatter_decode, scatter_prefill (shared entries masked) and
    scatter_chunk drop unmapped writes exactly as the reference's."""
    e = ops_env
    rng = e.rng
    # decode: one position per slot, a parked slot at cache_len - 1
    rows = _rows(rng, OPS_SPEC)
    sids = np.array([3, -1, 1], np.int32)
    pos = np.array([5, OPS_L - 1, 17], np.int32)
    win = _window_np(e)
    e.cache._fns["scatter_decode"](
        e.cache.slabs, _i32(rows), _i32(sids), _i32(pos),
        [{k: torch.from_numpy(v) for k, v in w.items()} for w in win])
    e.slabs = e.fns["scatter_decode"](e.slabs, rows, sids, pos,
                                      _stack_like(e.template, win))
    _assert_slabs_equal(e)
    # prefill of a 10-token prompt into a write row with two shared (-1)
    # entries; the port's caches hold 10 positions, the reference's are
    # padded to cache_len with zeros
    write_row = np.array([-1, -1, 4, 7, 8, -1], np.int32)
    S = 10
    one = [{k: v[:1] for k, v in w.items()} for w in _window_np(e)]
    port_one, ref_one = [], []
    for layer in one:
        p, r = {}, {}
        for k, v in layer.items():
            if k in ("k", "v"):
                r[k] = v.copy()
                r[k][:, S:] = 0
                p[k] = torch.from_numpy(v[:, :S].copy())
            else:
                r[k], p[k] = v, torch.from_numpy(v)
        port_one.append(p)
        ref_one.append(r)
    e.cache._fns["scatter_prefill"](e.cache.slabs, _i32(write_row), 2,
                                    port_one)
    e.slabs = e.fns["scatter_prefill"](
        e.slabs, write_row, jnp.int32(2),
        _stack_like(e.template, ref_one))
    _assert_slabs_equal(e)
    # a 3-token chunk of slot 0; slots 1 and 2 parked (adv 0, rows -1)
    rows = np.full((OPS_B, OPS_SPEC["pages_per_req"]), -1, np.int32)
    rows[0] = [5, 6, -1, 2, 0, 1]
    sids_out = np.array([1, -1, -1], np.int32)
    pos0 = np.array([3, OPS_L - 1, OPS_L - 1], np.int32)
    adv = np.array([1, 0, 0], np.int32)
    win = _window_np(e)
    e.cache._fns["scatter_chunk"](
        3, e.cache.slabs, _i32(rows), _i32(sids_out), _i32(pos0), _i32(adv),
        [{k: torch.from_numpy(v) for k, v in w.items()} for w in win])
    e.slabs = e.fns["scatter_chunk"](
        3, e.slabs, rows, sids_out, pos0, adv,
        _stack_like(e.template, win))
    _assert_slabs_equal(e)


# ---------------------------------------------------------------------------
# token identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["port dense", "port paged monolithic",
                                 "port paged actors"])
def test_paged_tokens_match_dense_and_jax(env, streams, key):
    want, _ = streams["jax dense"]
    got, stats = streams[key]
    _same(got, want)
    assert [len(o) for o in got] == GENS
    if "paged" in key:
        assert 0 < stats["peak_pages"] <= NUM_PAGES
        assert stats["shared_pages"] == 0         # disjoint prompts
        # more pages were mapped over the run than the pool holds
        spec = PagedCacheSpec(PAGE_LEN, NUM_PAGES, 2, CACHE_LEN // PAGE_LEN)
        assert sum(spec.pages_needed(PROMPT_LEN + g - 1)
                   for g in GENS) > NUM_PAGES


def test_paged_describe(env):
    sess = _port(env, **PAGED)
    rep = sess.describe()
    assert "cache: paged (8 pages x page_len=4, 6 pages/request" in rep
    assert "share_prefix=True" in rep


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["port chunked monolithic",
                                 "port chunked actors"])
def test_chunked_tokens_match_jax_chunked(streams, key):
    want, jstats = streams["jax chunked"]
    got, stats = streams[key]
    _same(got, want)
    assert stats["rounds"] == jstats["rounds"]
    # 8-token prompts at chunk 3 take 3 chunk rounds before their first
    # token: more rounds than unchunked
    assert stats["rounds"] > streams["port paged monolithic"][1]["rounds"]
    assert stats["chunk_items"] == 3 * len(GENS)
    assert stats["chunk_tokens"] == PROMPT_LEN * len(GENS)
    assert stats["prefill_items"] == 0


def test_chunks_interleave_with_decode():
    """A long prompt admitted mid-flight does not stall live decoding:
    rounds carrying its chunks still carry decode work."""
    spec = PagedCacheSpec(page_len=PAGE_LEN, num_pages=NUM_PAGES,
                          max_requests=2, pages_per_req=6)
    prompts = [np.arange(2, dtype=np.int32), np.arange(8, dtype=np.int32)]
    sched = AdmissionScheduler(prompts, [6, 2], num_groups=2, group_size=1,
                               cache_len=CACHE_LEN, device="cpu",
                               pool=PagePool(spec), prefill_chunk=3)
    work, meta = sched.plan_round()     # prefill r0 + 1st chunk of r1
    assert [type(w).__name__ for w in work] == ["PrefillWork",
                                                "PrefillChunkWork"]
    sched.absorb(meta[0], np.asarray([5]))
    sched.absorb(meta[1], None)
    work, meta = sched.plan_round()
    assert {type(w).__name__ for w in work} == {"DecodeWork",
                                                "PrefillChunkWork"}
    chunk = [w for w in work if isinstance(w, PrefillChunkWork)][0]
    assert not chunk.final and int(chunk.pos0[0]) == 3
    assert int(chunk.sids_in[0]) == 1 and int(chunk.adv[0]) == 1
    dec = [w for w in work if isinstance(w, DecodeWork)][0]
    assert dec.rows.dtype == torch.int32 and int(dec.sids[0]) == 0


def test_prefill_chunk_requires_paged(env):
    with pytest.raises(ValueError, match="prefill_chunk"):
        _port(env, prefill_chunk=3)


def test_chunk_on_a_dense_cache_raises():
    from repro_torch.runtime.pipeline import DenseStageCache
    with pytest.raises(RuntimeError, match="requires cache='paged'"):
        DenseStageCache(stage=None, group_size=1).run_chunk(None, None)


# ---------------------------------------------------------------------------
# shared-prefix pages
# ---------------------------------------------------------------------------

def test_shared_prefix_matches_jax(env):
    """With a long-lived donor, later identical prompts map its page-aligned
    prefix: the port shares as many pages as the JAX session and still
    emits the dense tokens."""
    p = env.prompts[0]
    reqs = [(p, 6), (p, 3), (p, 3), (p, 4)]
    dense, _ = _serve(_port(env), reqs)
    want, jstats = _serve(_jax(env, cache="paged", page_len=PAGE_LEN,
                               num_pages=16), reqs)
    got, stats = _serve(_port(env, cache="paged", page_len=PAGE_LEN,
                              num_pages=16), reqs)
    _same(got, dense)
    _same(got, want)
    assert stats["shared_pages"] == jstats["shared_pages"] > 0


# ---------------------------------------------------------------------------
# SSM paged serving
# ---------------------------------------------------------------------------

def test_ssm_paged_matches_dense_and_jax():
    """Recurrent state (SSM h, conv tails) lives in the per-request row
    pool, not the page slabs; paged actors still give the dense tokens."""
    e = _env("mamba2-370m", 2)
    reqs = [(e.rng.integers(0, 1000, (n,)).astype(np.int32), g)
            for n, g in ((5, 3), (8, 2), (6, 4))]
    geo = dict(max_prompt_len=8, max_new_tokens=4)
    want, _ = _serve(_jax(e, **geo), reqs)
    dense, _ = _serve(_port(e, **geo), reqs)
    got, stats = _serve(_port(e, "actors", cache="paged", page_len=4,
                              num_pages=10, **geo), reqs)
    _same(dense, want)
    _same(got, want)
    assert stats["peak_pages"] > 0


# ---------------------------------------------------------------------------
# cache bytes, validation, kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_cache_bytes_match_jax(env, cache):
    kw = dict(group_size=2)
    if cache == "paged":
        kw.update(cache="paged", page_len=PAGE_LEN, num_pages=8)
    assert _port(env, **kw).cache_bytes() == _jax(env, **kw).cache_bytes()


def test_paged_pool_halves_cache_bytes(env):
    dense = _port(env, group_size=2).cache_bytes()
    paged = _port(env, group_size=2, cache="paged", page_len=PAGE_LEN,
                  num_pages=8).cache_bytes()
    assert paged * 2 <= dense


def test_default_num_pages_matches_dense_capacity(env):
    spec = _port(env, cache="paged", page_len=PAGE_LEN).cache_spec
    assert spec.num_pages * spec.page_len == 2 * 1 * CACHE_LEN


@pytest.mark.parametrize("bad, match", [
    (dict(cache="paged", page_len=5), "page_len"),
    (dict(cache="paged", page_len=PAGE_LEN, num_pages=2), "num_pages"),
    (dict(page_len=4), "cache='paged'"),
    (dict(num_pages=8), "cache='paged'"),
    (dict(prefill_chunk=3), "cache='paged'"),
    (dict(cache="virtual"), "dense.*paged|paged.*dense"),
    (dict(cache="paged", prefill_chunk=0), "prefill_chunk"),
])
def test_paged_validation(env, bad, match):
    with pytest.raises(ValueError, match=match):
        _port(env, **bad)


def test_cpu_paged_serving_launches_no_kernel(env, streams):
    fa_kernel.launches = fd_kernel.launches = ssd_kernel.launches = 0
    _serve(_port(env, prefill_chunk=3, **PAGED),
           list(zip(env.prompts[:2], GENS[:2])))
    assert fa_kernel.launches == 0 and fd_kernel.launches == 0
    assert ssd_kernel.launches == 0
