"""The sliding-window decode, ring cache or not, held to the JAX package on
the CPU.

* The ring (``make_serve_step(..., sliding_window=W, ring=True)``, cache_len
  ``W``): ``init_caches_fn``, then 40 decode steps from rows at positions
  0, 5, 524,270 and 8,180, against the JAX ``make_serve_step(...,
  ring=True)``'s ``decode_fn`` on reduced qwen3-1.7b, qwen2.5-3b (QKV bias,
  2 kv heads) and pixtral-12b: every step's logits within 1e-4, the
  greedy tokens identical (each side fed its own), and every layer's slot
  position table ``pos`` bitwise equal, across the wrap.
* The window without the ring: a prefill and 8 decode steps against the
  JAX ``make_serve_step(..., sliding_window=W)`` (the same archs and
  whisper-medium): the first token's logits within 1e-4, the decode
  steps' within 1e-4 of the logits' scale, greedy tokens identical. The
  prefill caches are bfloat16 (the reference's prefill cache dtype, in a
  float32 config too), where a last-bit float32 difference can round an
  entry to the neighbouring bf16 value: over 8 steps that moves a logit
  by up to 3.5e-4 at a scale of 4.0, with or without the window. The
  ring's caches are float32 (``init_caches_fn``, the config's dtype), so
  its logits are held at 1e-4 whole.
* Within the port, the ring of ``W`` slots decodes as a linear cache of 64
  positions with the same window (teacher-forced, 48 steps, 1e-5).
* ``launch/specs.py`` equals the reference's for every arch and shape:
  ``serve_plan_for``'s dicts, and the batch stand-ins' keys, shapes and
  dtypes.
* The kernel's algorithm over a ring in plain PyTorch
  (``split_partials_ref(k_positions=)`` folded by ``combine_splits``)
  equals ``flash_decode_partial_ref`` at 1, 4 and 16 splits: a wrapped
  ring, holes of -1, and a row whose every key is masked.
* The ring on a mesh: ``make_serve_step(..., ring=True)`` on (1, 2) and
  (2, 2), ``shard_batch`` true and false, from ``init_caches_fn``, 24
  decode steps from rows at positions 0, 3, 524,272 and 8,192 (every
  token's slot on shard 0 for the first 5 steps, shard 1 all empty),
  against the JAX ring step on the same mesh (a subprocess with 8 host
  devices and Auto axes): every step's logits within 1e-4, the greedy
  tokens identical, each rank's slot table bitwise the JAX table's block
  of it. Within the port, (1, 2) decodes as one device does.
* The errors by name (the ring's prefill, a ring whose cache_len is not its
  window), and a pin of the reference's red surface:
  its ring ``prefill_fn`` fails with a pytree structure error (its
  out_specs carry ``pos``; its prefill builds none).

The JAX steps run on a 1 x 1 mesh with Auto axes, as the port's other
parity tests build it (jax 0.9 makes Explicit ones by default).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs.registry import ARCHITECTURES as JAX_ARCHS  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.train.steps import make_serve_step as jax_serve_step  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.configs.registry import ARCHITECTURES, get_config  # noqa: E402
from repro_torch.core import mesh as M  # noqa: E402
from repro_torch.kernels.flash_decode import kernel as fd  # noqa: E402
from repro_torch.kernels.flash_decode.ref import (  # noqa: E402
    NEG_INF, flash_decode_partial_ref, ring_positions)
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.serve import classic_batch  # noqa: E402
from repro_torch.models.common import MeshPlan  # noqa: E402
from repro_torch.models.convert import unstack_layers  # noqa: E402
from repro_torch.models.model_zoo import cache_specs  # noqa: E402
from repro_torch.train.steps import make_serve_step  # noqa: E402

from torch_frontend_parity import build, mesh  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

RING_ARCHS = ("qwen3-1.7b", "qwen2.5-3b", "pixtral-12b")
WINDOW = 16
#: the ring rows' first positions: from the start, a few in, near the
#: long_500k plan's end (wraps at 524,272 = 32,767 x 16), and just before
#: a wrap at 8,192
STARTS = (0, 5, 524_270, 8_180)
RING_STEPS = 40
#: the window without the ring: prompt, cache and decode steps
PROMPT, CACHE_LEN, WINDOW_STEPS = 32, 48, 8
TOL = dict(rtol=1e-4, atol=1e-4)


def greedy(logits, vocab: int) -> np.ndarray:
    return np.argmax(np.asarray(logits, np.float32)[:, :vocab],
                     -1).astype(np.int32)


@pytest.fixture(scope="module", params=RING_ARCHS)
def ring_run(request):
    """One arch's ring decode in both packages: 40 steps from ``STARTS``,
    the first token from a numpy seed, then each side's greedy token."""
    env = build(request.param)
    cfg, cfg_j, model = env["cfg"], env["cfg_j"], env["model"]
    first = np.random.default_rng(7).integers(
        0, cfg.vocab_size, len(STARTS)).astype(np.int32)
    pos0 = np.asarray(STARTS, np.int32)

    js = jax_serve_step(cfg_j, mesh(), cache_len=WINDOW,
                        sliding_window=WINDOW, ring=True)
    caches = js.init_caches_fn(jnp.asarray(first))
    jax_logits, jax_toks, tok = [], [], first
    for i in range(RING_STEPS):
        jax_toks.append(tok)
        logits, caches = js.decode_fn(env["params"], caches,
                                      jnp.asarray(tok), jnp.asarray(pos0 + i))
        jax_logits.append(np.asarray(logits))
        tok = greedy(jax_logits[-1], cfg.vocab_size)
    jax_pos = [np.array(c["pos"]) for c in unstack_layers(
        jax.device_get(caches), cfg)]

    ss = make_serve_step(cfg, cache_len=WINDOW, sliding_window=WINDOW,
                         ring=True, device="cpu")
    tc = ss.init_caches_fn(torch.as_tensor(first))
    logits_t, toks_t, tok = [], [], first
    for i in range(RING_STEPS):
        toks_t.append(tok)
        logits, tc = ss.decode_fn(model, tc, torch.as_tensor(tok),
                                  torch.as_tensor(pos0 + i))
        logits_t.append(logits.numpy())
        tok = greedy(logits_t[-1], cfg.vocab_size)
    return dict(cfg=cfg, jax_logits=jax_logits, jax_toks=jax_toks,
                jax_pos=jax_pos, logits=logits_t, toks=toks_t, caches=tc)


def test_ring_decode_logits_match_jax(ring_run):
    for i, (got, want) in enumerate(zip(ring_run["logits"],
                                        ring_run["jax_logits"])):
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"step {i}")


def test_ring_decode_greedy_tokens_match_jax(ring_run):
    np.testing.assert_array_equal(np.stack(ring_run["toks"]),
                                  np.stack(ring_run["jax_toks"]))


def test_ring_position_tables_match_jax_bitwise(ring_run):
    """Every layer's ``pos`` table equals the JAX one bit for bit, and
    holds the last ``WINDOW`` positions of each row in slots ``p % W``:
    past the wrap for every row, at positions up to 524,309."""
    last = np.asarray(STARTS) + RING_STEPS - 1
    want = ring_positions(torch.as_tensor(STARTS), torch.as_tensor(last),
                          WINDOW).numpy()
    assert len(ring_run["caches"]) == len(ring_run["jax_pos"])
    for layer, (c, jp) in enumerate(zip(ring_run["caches"],
                                        ring_run["jax_pos"])):
        assert c["pos"].dtype == torch.int32 and jp.dtype == np.int32
        np.testing.assert_array_equal(c["pos"].numpy(), jp,
                                      err_msg=f"layer {layer}")
        np.testing.assert_array_equal(c["pos"].numpy(), want)
    assert want.max() == STARTS[2] + RING_STEPS - 1


@pytest.fixture(scope="module",
                params=RING_ARCHS + ("whisper-medium",))
def window_run(request):
    """One arch's windowed prefill and 8 decode steps in both packages,
    each side fed its own greedy tokens."""
    env = build(request.param)
    cfg, cfg_j, model = env["cfg"], env["cfg_j"], env["model"]
    batch = classic_batch(cfg, 2, PROMPT, np.random.default_rng(11))
    pos0 = np.full((2,), PROMPT, np.int32)

    js = jax_serve_step(cfg_j, mesh(), cache_len=CACHE_LEN,
                        sliding_window=WINDOW)
    h, caches = js.prefill_fn(env["params"],
                              {k: jnp.asarray(v) for k, v in batch.items()})
    jax_out = [np.asarray(js.logits_fn(env["params"], h))]
    for i in range(WINDOW_STEPS):
        logits, caches = js.decode_fn(
            env["params"], caches,
            jnp.asarray(greedy(jax_out[-1], cfg.vocab_size)),
            jnp.asarray(pos0 + i))
        jax_out.append(np.asarray(logits))

    ss = make_serve_step(cfg, cache_len=CACHE_LEN, sliding_window=WINDOW,
                         device="cpu")
    h, tc = ss.prefill_fn(model, batch)
    out = [ss.logits_fn(model, h).numpy()]
    for i in range(WINDOW_STEPS):
        logits, tc = ss.decode_fn(
            model, tc, torch.as_tensor(greedy(out[-1], cfg.vocab_size)),
            torch.as_tensor(pos0 + i))
        out.append(logits.numpy())
    return dict(cfg=cfg, jax_out=jax_out, out=out)


def test_window_prefill_and_decode_match_jax(window_run):
    vocab = window_run["cfg"].vocab_size
    for i, (got, want) in enumerate(zip(window_run["out"],
                                        window_run["jax_out"])):
        # step 0 the prefill's (float32 activations), then the decode
        # steps over the bf16 caches, at the logits' scale
        atol = TOL["atol"] * (1.0 if i == 0 else float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=TOL["rtol"], atol=atol,
                                   err_msg=f"step {i}")
        np.testing.assert_array_equal(greedy(got, vocab),
                                      greedy(want, vocab))


def test_ring_decodes_as_a_linear_window():
    """The ring of ``WINDOW`` slots against a linear cache of 64 positions
    with the same window, from position 0, teacher-forced 48 steps: the
    same keys in other slots, so the same logits within 1e-5."""
    cfg = get_config("qwen3-1.7b").reduced()
    ring = make_serve_step(cfg, cache_len=WINDOW, sliding_window=WINDOW,
                           ring=True, device="cpu")
    lin = make_serve_step(cfg, cache_len=64, sliding_window=WINDOW,
                          device="cpu")
    model = ring.init_params(3)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (48, 2))
    rc = ring.init_caches_fn(torch.zeros(2, dtype=torch.int32))
    lc = lin.init_caches_fn(torch.zeros(2, dtype=torch.int32))
    assert "pos" in rc[0] and "pos" not in lc[0]
    for i in range(48):
        tok = torch.as_tensor(toks[i], dtype=torch.int32)
        pos = torch.full((2,), i, dtype=torch.int32)
        a, rc = ring.decode_fn(model, rc, tok, pos)
        b, lc = lin.decode_fn(model, lc, tok, pos)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5,
                                   msg=f"step {i}")


def _meta_like(t, want):
    assert t.device.type == "meta"
    assert tuple(t.shape) == tuple(want.shape)
    assert str(t.dtype).removeprefix("torch.") == str(want.dtype)


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_serve_plan_and_batch_stand_ins_match_the_reference(arch):
    assert set(ARCHITECTURES) == set(JAX_ARCHS)
    assert set(INPUT_SHAPES) == set(JAX_SHAPES)
    cfg, cfg_j = get_config(arch), JAX_ARCHS[arch]
    for name, shape in INPUT_SHAPES.items():
        shape_j = JAX_SHAPES[name]
        if shape.kind == "decode":
            assert specs.serve_plan_for(cfg, shape) == \
                jax_specs.serve_plan_for(cfg_j, shape_j)
            tok, pos = specs.decode_io_specs(cfg, shape)
            tok_j, pos_j = jax_specs.decode_io_specs(cfg_j, shape_j)
            _meta_like(tok, tok_j)
            _meta_like(pos, pos_j)
        else:
            with pytest.raises(AssertionError):
                jax_specs.serve_plan_for(cfg_j, shape_j)
            with pytest.raises(ValueError, match="not a decode"):
                specs.serve_plan_for(cfg, shape)
        for fn in ("train_batch_specs", "prefill_batch_specs"):
            got = getattr(specs, fn)(cfg, shape)
            want = getattr(jax_specs, fn)(cfg_j, shape_j)
            assert list(got) == list(want), fn
            for key in want:
                _meta_like(got[key], want[key])


def test_long_500k_plan_takes_the_ring_for_dense_gqa_only():
    shape = INPUT_SHAPES["long_500k"]
    rings = {arch for arch, cfg in ARCHITECTURES.items()
             if specs.serve_plan_for(cfg, shape)["ring"]}
    assert rings == {"qwen3-1.7b", "llama3-8b", "qwen2.5-3b",
                     "phi4-mini-3.8b", "pixtral-12b", "whisper-medium"}
    plan = specs.serve_plan_for(get_config("qwen3-1.7b"), shape)
    assert plan == {"cache_len": 8192, "sliding_window": 8192, "ring": True,
                    "shard_batch": False}


def _ring_case(rng, B, L, H=4, KV=2, D=16):
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, L, KV, D)).astype(
        np.float32)) for _ in "kv")
    return q, k, v


@pytest.mark.parametrize("ns", [1, 4, 16])
@pytest.mark.parametrize("window", [0, 40])
def test_split_partials_over_a_ring_fold_to_the_plain_version(ns, window):
    """Rows: a wrapped ring, a partly filled one (holes of -1), one written
    from mid-ring across the wrap (two runs), and one whose every entry
    the mask drops (cur_pos before every slot's position): that row
    averages v over the whole cache, as the plain version's sentinel
    does. Each row's cut is the whole cache."""
    L = 100
    rng = np.random.default_rng(ns + window)
    q, k, v = _ring_case(rng, 4, L)
    first = torch.tensor([0, 0, 170, 50])
    last = torch.tensor([1000, 30, 230, 120])
    table = ring_positions(first, last, L)
    cur = torch.tensor([1000, 30, 230, 10], dtype=torch.int32)
    assert (table[1, 31:] == -1).all() and (table[2] == -1).sum() == 39
    kw = dict(sliding_window=window, k_positions=table)
    m, l, acc = fd.combine_splits(*fd.split_partials_ref(q, k, v, cur, ns,
                                                         **kw))
    pm, pl, pacc = flash_decode_partial_ref(q, k, v, cur_pos=cur, **kw)
    torch.testing.assert_close(m, pm, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(acc / l[..., None], pacc / pl[..., None],
                               rtol=1e-4, atol=1e-5)
    # the masked row: the finite sentinel, every key of the cache counted
    assert (m[3] == NEG_INF).all() and (l[3] == L).all()
    for masked, starts in fd.split_bounds(cur, L, ns, k_positions=table):
        assert not masked and starts[0] == 0 and starts[-1] == L


def test_ring_cache_leaves_and_specs():
    """A ring gives each GQA layer a ``pos`` table of ``(B, L / tp)``
    int32, every slot -1, split as its ``k`` (the reference's
    ``model_zoo.py:77-78``, ``:128-129``); an MLA layer and an SSM layer
    take none, and without the ring no layer has one."""
    from repro_torch.models.model_zoo import cache_specs, make_decode_caches
    plan = MeshPlan(("data", "model"), (2, 2))
    for arch in ("qwen3-1.7b", "deepseek-v2-lite-16b", "mamba2-370m"):
        cfg = get_config(arch).reduced()
        ring = make_decode_caches(cfg, plan, 3, 32, "cpu", ring=True)
        specs_ = cache_specs(cfg, plan, ("data",), ring=True)
        for c, sp in zip(ring, specs_):
            assert ("pos" in c) == ("k" in c) == ("pos" in sp)
            if "pos" in c:
                assert c["pos"].dtype == torch.int32
                assert tuple(c["pos"].shape) == (3, 16)
                assert (c["pos"] == -1).all()
                assert sp["pos"] == sp["k"]
        assert not any("pos" in c for c in make_decode_caches(
            cfg, plan, 3, 32, "cpu"))
        assert not any("pos" in sp for sp in cache_specs(cfg, plan,
                                                          ("data",)))


def test_make_serve_step_ring_errors_by_name():
    cfg = get_config("qwen3-1.7b").reduced()
    ss = make_serve_step(cfg, cache_len=WINDOW, sliding_window=WINDOW,
                         ring=True, device="cpu")
    batch = classic_batch(cfg, 2, 8, np.random.default_rng(0))
    with pytest.raises(NotImplementedError, match="no prefill"):
        ss.prefill_fn(ss.init_params(0), batch)
    for kw in (dict(cache_len=48, sliding_window=WINDOW),
               dict(cache_len=WINDOW, sliding_window=0)):
        with pytest.raises(ValueError, match="cache_len == sliding_window"):
            make_serve_step(cfg, ring=True, device="cpu", **kw)


def test_ring_decodes_on_a_mesh():
    """``gqa_decode`` over a ring on (1, 2): each rank holds 8 of the 16
    slots and their table, the token goes to the shard that owns slot
    ``pos % 16`` (rank 1's slots stay -1 until position 8, so its partials
    carry weight 0), and the combined output is one device's, teacher-fed
    20 steps from position 0, within 1e-5."""
    cfg = get_config("qwen3-1.7b").reduced()
    plan = MeshPlan(("data", "model"), (1, 2))
    ring = make_serve_step(cfg, plan, cache_len=WINDOW,
                           sliding_window=WINDOW, ring=True, device="cpu")
    one = make_serve_step(cfg, cache_len=WINDOW, sliding_window=WINDOW,
                          ring=True, device="cpu")
    model = one.init_params(4)
    params = ring.shard_params_fn(model)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (20, 2))
    rc = ring.init_caches_fn(torch.zeros(2, dtype=torch.int32))
    oc = one.init_caches_fn(torch.zeros(2, dtype=torch.int32))
    assert [tuple(c[0]["pos"].shape) for c in rc] == [(2, 8), (2, 8)]
    for i in range(20):
        tok = torch.as_tensor(toks[i], dtype=torch.int32)
        pos = torch.tensor([i, i + 3], dtype=torch.int32)
        a, rc = ring.decode_fn(params, rc, tok, pos)
        b, oc = one.decode_fn(model, oc, tok, pos)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5,
                                   msg=f"step {i}")
        if i == 0:
            assert (rc[1][0]["pos"] == -1).all()
        whole = torch.cat([rc[0][0]["pos"], rc[1][0]["pos"]], dim=1)
        assert torch.equal(whole, oc[0]["pos"])


def test_reference_ring_prefill_is_red():
    """The reference's ring serve step cannot prefill: its prefill_fn's
    out_specs carry the ``pos`` table, its prefill builds none (ROADMAP
    Queue 3). The port raises NotImplementedError there instead."""
    env = build("qwen3-1.7b")
    js = jax_serve_step(env["cfg_j"], mesh(), cache_len=WINDOW,
                        sliding_window=WINDOW, ring=True)
    batch = classic_batch(env["cfg"], 2, 8, np.random.default_rng(0))
    with pytest.raises(ValueError, match="pytree structure"):
        js.prefill_fn(env["params"],
                      {k: jnp.asarray(v) for k, v in batch.items()})


#: the ring on a mesh: every row's first 5 tokens go to shard 0's slots
MESH_STARTS = (0, 3, 524_272, 8_192)
MESH_STEPS = 24
RING_MESHES = [((1, 2), True), ((1, 2), False), ((2, 2), True),
               ((2, 2), False)]

JAX_RING = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
out_dir = sys.argv[2]
import numpy as np
import jax
import jax.numpy as jnp
from repro.configs.registry import get_config
from repro.models.model_zoo import build_model
from repro.train.steps import make_serve_step, plan_from_mesh
from repro_torch.configs.registry import get_config as port_config
from repro_torch.models.convert import unstack_layers
inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
W, steps = int(inp["window"]), int(inp["steps"])
cfg = get_config("qwen3-1.7b").reduced()


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


params = build_model(cfg, plan_from_mesh(mesh_of((1, 1)))).init(
    jax.random.PRNGKey(0))
res = {}
for shape, sb in zip(inp["shapes"], inp["shard_batch"]):
    t = f"{shape[0]}x{shape[1]}_{bool(sb)}"
    js = make_serve_step(cfg, mesh_of(tuple(int(v) for v in shape)),
                         cache_len=W, sliding_window=W, ring=True,
                         shard_batch=bool(sb))
    tok = inp["first"]
    caches = js.init_caches_fn(jnp.asarray(tok))
    for i in range(steps):
        logits, caches = js.decode_fn(params, caches, jnp.asarray(tok),
                                      jnp.asarray(inp["starts"] + i))
        res[f"logits_{t}_{i}"] = np.asarray(logits)
        tok = np.argmax(res[f"logits_{t}_{i}"][:, :cfg.vocab_size],
                        -1).astype(np.int32)
    for li, c in enumerate(unstack_layers(jax.device_get(caches),
                                          port_config("qwen3-1.7b")
                                          .reduced())):
        res[f"pos_{t}_{li}"] = np.asarray(c["pos"])
np.savez(os.path.join(out_dir, "jax.npz"), **res)
print("JAX-OK")
"""


def _ring_tag(shape, shard_batch):
    return f"{shape[0]}x{shape[1]}_{shard_batch}"


@pytest.fixture(scope="module")
def ring_mesh_run(tmp_path_factory):
    """Both packages' ring decode on each mesh of ``RING_MESHES``: the JAX
    step in a subprocess, the port in process (every rank a thread), each
    fed its own greedy tokens after the same numpy-seeded first ones."""
    out = tmp_path_factory.mktemp("jax_ring_mesh")
    cfg = get_config("qwen3-1.7b").reduced()
    first = np.random.default_rng(8).integers(
        0, cfg.vocab_size, len(MESH_STARTS)).astype(np.int32)
    starts = np.asarray(MESH_STARTS, np.int32)
    np.savez(out / "inputs.npz", window=WINDOW, steps=MESH_STEPS,
             first=first, starts=starts,
             shapes=np.array([s for s, _ in RING_MESHES]),
             shard_batch=np.array([b for _, b in RING_MESHES]))
    run_env = dict(os.environ, JAX_PLATFORMS="cpu")
    run_env.pop("XLA_FLAGS", None)
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run([sys.executable, "-c", JAX_RING, src, str(out)],
                          env=run_env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0 and "JAX-OK" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:])
    jx = dict(np.load(out / "jax.npz"))
    state = build("qwen3-1.7b")["state"]
    port = {}
    for shape, sb in RING_MESHES:
        ss = make_serve_step(cfg, MeshPlan(("data", "model"), shape),
                             cache_len=WINDOW, sliding_window=WINDOW,
                             ring=True, device="cpu", shard_batch=sb)
        params = ss.shard_params_fn(state)
        caches = ss.init_caches_fn(torch.as_tensor(first))
        tok, logits_all, empty = first, [], []
        for i in range(MESH_STEPS):
            logits, caches = ss.decode_fn(params, caches,
                                          torch.as_tensor(tok),
                                          torch.as_tensor(starts + i))
            logits_all.append(logits.numpy())
            # a rank of model index 1 whose every slot is still empty
            empty.append(all((c["pos"] == -1).all() for r, rank in
                             enumerate(caches) if ss.mesh.coords(r)[1] == 1
                             for c in rank))
            tok = greedy(logits_all[-1], cfg.vocab_size)
        port[shape, sb] = dict(logits=logits_all, caches=caches,
                               empty=empty, mesh=ss.mesh)
    return cfg, jx, port


@pytest.mark.parametrize("shape,shard_batch", RING_MESHES,
                         ids=[_ring_tag(*c) for c in RING_MESHES])
def test_ring_on_a_mesh_matches_the_jax_ring_step(ring_mesh_run, shape,
                                                  shard_batch):
    cfg, jx, port = ring_mesh_run
    run, t = port[shape, shard_batch], _ring_tag(shape, shard_batch)
    # the model axis's second shard holds no token for the first 5 steps
    assert run["empty"][:5] == [True] * 5 and not any(run["empty"][5:])
    for i, got in enumerate(run["logits"]):
        want = jx[f"logits_{t}_{i}"]
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"step {i}")
        np.testing.assert_array_equal(greedy(got, cfg.vocab_size),
                                      greedy(want, cfg.vocab_size))
    plan = MeshPlan(("data", "model"), shape)
    specs = cache_specs(cfg, plan, ("data",) if shard_batch else (),
                        ring=True)
    for r, rank in enumerate(run["caches"]):
        for li, (c, sp) in enumerate(zip(rank, specs)):
            whole = jx[f"pos_{t}_{li}"]
            block = whole[M.shard_slices(whole.shape, sp["pos"], shape,
                                         run["mesh"].coords(r))]
            np.testing.assert_array_equal(c["pos"].numpy(), block,
                                          err_msg=f"rank {r} layer {li}")
            assert c["pos"].shape[0] == (len(MESH_STARTS) // shape[0]
                                         if shard_batch
                                         else len(MESH_STARTS))
