"""What the port's frontend architectures (whisper-medium, an
encoder-decoder; pixtral-12b, an embed frontend) refuse, and their
parameter trees, without jax.

* ``api.compile(cfg, mode="serve")`` refuses both with the reference's
  ``ValueError`` ("pipelined serving needs a token frontend",
  ``repro/core/lowering.py:1350-1353``), before building a model: they
  serve through the classic loop;
* ``make_train_step`` on a mesh, and ``make_serve_step`` on a mesh, with
  ``ring=True`` or with ``sliding_window > 0``, raise naming their ROADMAP
  items;
* ``convert.params_to_jax`` and ``params_from_jax`` round-trip both trees
  bit for bit, with the reference's ``enc_body`` stacked over encoder
  layers and the cross leaves in every decoder block of the body;
* the serve launcher routes both archs to the classic loop, and
  ``--classic`` routes a token-frontend arch there too.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models.common import MeshPlan
from repro_torch.models.convert import (jax_leaves, params_from_jax,
                                        params_to_jax)
from repro_torch.models.model_zoo import (build_model, cache_specs,
                                          make_decode_caches)
from repro_torch.train.steps import make_serve_step, make_train_step

ARCHS = ("whisper-medium", "pixtral-12b")


@pytest.mark.parametrize("arch", ARCHS)
def test_pipelined_serving_refuses_frontend_archs(arch, monkeypatch):
    from repro_torch.models import model_zoo
    built = []
    monkeypatch.setattr(model_zoo, "build_model",
                        lambda *a, **k: built.append(a))
    cfg = get_config(arch).reduced()
    with pytest.raises(ValueError, match="token frontend"):
        api.compile(cfg, mode="serve", device="cpu")
    assert not built


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_train_step_on_a_mesh_raises_item_13(arch, shape):
    cfg = get_config(arch).reduced()
    for zero in (False, True):
        with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
            make_train_step(cfg, MeshPlan(("data", "model"), shape),
                            zero=zero, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kw,match", [
    (dict(ring=True), "Queue 2 item 3"), (dict(sliding_window=16),
                                          "Queue 1 item 13"),
    (dict(plan=MeshPlan(("data", "model"), (1, 2))), "Queue 1 item 13")])
def test_make_serve_step_scope_raises(arch, kw, match):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match=match):
        make_serve_step(cfg, cache_len=48, device="cpu", **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_trees_round_trip_bit_for_bit(arch):
    cfg = get_config(arch).reduced()
    state = build_model(cfg, MeshPlan(), seed=3, device="cpu").state_dict()
    tree = params_to_jax(state, cfg)
    want_top = {"body", "embed", "final_norm", "prologue", "unembed"}
    if cfg.encoder_decoder:
        want_top |= {"enc_body", "enc_norm"}
        assert tree["enc_body"]["attn"]["wq"].shape == (
            cfg.num_encoder_layers, cfg.d_model, cfg.num_heads * 64)
        assert set(tree["body"][0]) == {"attn", "ln1", "ln2", "ln_x", "mlp",
                                        "xattn"}
        assert set(tree["body"][0]["xattn"]) == {"wq", "wk", "wv", "wo"}
    else:
        assert set(tree["body"][0]) == {"attn", "ln1", "ln2", "mlp"}
    assert set(tree) == want_top
    back = params_from_jax(tree, cfg)
    assert set(back) == set(state)
    for name, t in state.items():
        assert torch.equal(back[name], t), name
    # the leaf order is the JAX tree's: sorted keys, depth first
    paths = [path for path, _ in jax_leaves(cfg)]
    tops = [p[0] for p in paths]
    assert tops == sorted(tops)
    assert sum(len(names) for _, names in jax_leaves(cfg)) == len(state)


def test_cross_caches_and_their_specs():
    cfg = get_config("whisper-medium").reduced()
    caches = make_decode_caches(cfg, MeshPlan(), 3, 40, device="cpu")
    assert len(caches) == cfg.num_layers
    for c in caches:
        assert set(c) == {"k", "v", "xk", "xv"}
        assert c["xk"].shape == (3, cfg.encoder_seq, cfg.num_kv_heads, 64)
        assert c["k"].shape == (3, 40, cfg.num_kv_heads, 64)
        assert c["xk"].dtype == torch.float32      # a float32 config
    specs = cache_specs(cfg, MeshPlan(("data", "model"), (1, 1)), ("data",))
    assert set(specs[0]) == {"k", "v", "xk", "xv"}


@pytest.mark.parametrize("arch", ARCHS + ("qwen3-1.7b",))
def test_serve_launcher_takes_the_classic_loop(arch, capsys):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--gen", "3",
            "--batch", "2", "--prompt-len", "8"]
    if arch == "qwen3-1.7b":
        argv.append("--classic")
    gen = launch_serve.main(argv)
    out = capsys.readouterr().out
    assert "serve ok (classic loop)" in out and "tok/s" in out
    assert gen.shape == (2, 4)
    assert (gen >= 0).all() and (gen < get_config(arch).vocab_size).all()
    # the same seed serves the same ids
    np.testing.assert_array_equal(launch_serve.main(argv), gen)


@pytest.mark.parametrize("arch,train,prefill", [
    ("whisper-medium", ("tokens", "enc_embeds"), ("tokens", "enc_embeds")),
    ("pixtral-12b", ("embeds", "labels"), ("embeds",)),
    ("qwen3-1.7b", ("tokens",), ("tokens",))])
def test_batch_forms_and_serve_caches(arch, train, prefill):
    """The reference's batch forms (``train/steps.py:37-56``): the keys of
    ``batch_specs``, each row-split over ``data`` and replicated over
    ``model``, and of the seeded ``classic_batch``; ``ServeStep`` carries
    the prefill's. ``init_caches_fn`` gives the prefill's cache leaves at
    their shapes, zeroed, in the compute dtype (the prefill rounds its
    attention caches to bfloat16, as the reference does)."""
    from repro_torch.core.sbp import ndsbp
    from repro_torch.train.steps import batch_specs
    cfg = get_config(arch).reduced()
    plan = MeshPlan(("data", "model"), (2, 2))
    for kind, keys in (("train", train), ("prefill", prefill)):
        specs = batch_specs(cfg, plan, kind)
        assert tuple(specs) == keys
        assert set(specs.values()) == {ndsbp("S(0),B")}
        batch = launch_serve.classic_batch(cfg, 2, 8,
                                           np.random.default_rng(0), kind)
        assert tuple(batch) == keys
        rows = {"tokens": 9 if kind == "train" else 8, "labels": 8,
                "embeds": 8, "enc_embeds": cfg.encoder_seq}
        for key, a in batch.items():
            assert a.shape[:2] == (2, rows[key]), key
    ss = make_serve_step(cfg, cache_len=24, device="cpu")
    assert ss.batch_specs == batch_specs(cfg, MeshPlan(), "prefill")
    batch = launch_serve.classic_batch(cfg, 2, 8, np.random.default_rng(1))
    _, caches = ss.prefill_fn(ss.init_params(0), batch)
    zeros = ss.init_caches_fn(np.zeros(2, np.int32))
    assert len(zeros) == len(caches) == cfg.num_layers
    for got, want in zip(zeros, caches):
        assert set(got) == set(want)
        for key, z in got.items():
            assert z.shape == want[key].shape, key
            assert z.dtype == torch.float32 and not z.any(), key
            assert want[key].dtype == torch.bfloat16, key
