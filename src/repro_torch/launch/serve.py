"""Serving driver: continuous-batching pipelined decode on the actor runtime.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --requests 6 --prompt-len 32 --gen 16 --backend actors --stages 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --mesh 1x2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --smoke --device cpu --mesh 1x2
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --smoke --device cpu --mesh 1x2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium
    PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-medium --smoke --device cpu --mesh 1x2
    PYTHONPATH=src python -m repro_torch.launch.serve --classic \
        --smoke --device cpu --mesh 2x1

Port of ``repro/launch/serve.py:80-150`` (``continuous_batching``): requests
with differing generation lengths are packed into decode slots, finished
requests retire and queued ones are admitted mid-flight, and the stage
actors overlap across request groups. Runs on the card by default
(``--device cuda``); ``--device cpu --smoke`` runs the reduced config on the
plain PyTorch path. ``--mesh DxM`` serves a token-frontend model (dense,
Mamba-2, MLA + MoE, hybrid) on a ``("data", "model")`` mesh of D x M ranks
(threads; on one card every rank shares it), as the reference's
``launch/serve.py:130-141`` does. Weights are the port's
seeded init (``--seed``), drawn in the config's compute dtype.

Embed-frontend and encoder-decoder archs (pixtral, whisper) take the
reference's classic loop instead (``:19-77``, routed at ``:143``;
``--classic`` forces it for any arch): :func:`classic_loop`, one batched
whole-model prefill and greedy decode through
:func:`repro_torch.train.steps.make_serve_step`, on one device or on the
``--mesh`` (heads split over ``model``, rows over ``data``), its inputs
(token ids, patch or frame embeddings) drawn from ``--seed`` with numpy
as the reference draws them.
"""
from __future__ import annotations

import argparse
import time


def classic_batch(cfg, batch: int, length: int, rng, kind: str = "prefill"):
    """A batch in the reference's form for ``cfg``
    (:func:`repro_torch.models.transformer.batch_inputs`), drawn from the
    numpy ``rng`` key by key in that order, as the reference's classic loop
    draws its prompt (``launch/serve.py:44-53``): token ids ``(B, length)``
    (``length + 1`` for ``kind`` "train"), patch embeddings ``(B, length,
    d)`` and labels ``(B, length)``, an encoder-decoder's frame embeddings
    ``(B, encoder_seq, d)``."""
    import numpy as np

    from repro_torch.models.transformer import batch_inputs

    def draw(key):
        if key in ("tokens", "labels"):
            n = length + (key == "tokens" and kind == "train")
            return rng.integers(0, cfg.vocab_size,
                                size=(batch, n)).astype(np.int32)
        rows = cfg.encoder_seq if key == "enc_embeds" else length
        return rng.normal(size=(batch, rows, cfg.d_model)).astype(np.float32)
    return {key: draw(key) for key in batch_inputs(cfg, kind)}


def classic_loop(cfg, args, params=None):
    """The pre-pipeline serve loop: one batched prefill and greedy decode
    (``repro/launch/serve.py:19-77``), on one device or on the ``--mesh``
    of D x M ranks (``make_serve_step`` on that mesh; ``cache_len`` rounded
    up to a multiple of M, as the reference's ``:34-36``). The first
    token's logits go through ``ServeStep.logits_fn``, the decode step's
    head, and greedy selection masks the padded vocab, so every id is <
    ``cfg.vocab_size``. ``params``: the global model to serve, a
    ``Transformer`` or a ``state_dict`` (default the seeded init of
    ``--seed`` in the compute dtype), which ``ServeStep.shard_params_fn``
    cuts into the ranks' shards on a mesh. Prints the prefill's seconds
    and the decode's tok/s as the reference does; returns the ids ``(B,
    gen + 1)``."""
    import numpy as np
    import torch

    from repro_torch.models.common import MeshPlan
    from repro_torch.train.steps import greedy_from_logits, make_serve_step

    shape = tuple(int(v) for v in getattr(args, "mesh", "1x1").split("x"))
    m_ = shape[1]
    cache_len = args.cache_len or (args.prompt_len + args.gen + 8)
    cache_len = -(-cache_len // m_) * m_
    ss = make_serve_step(cfg, MeshPlan(("data", "model"), shape),
                         cache_len=cache_len, device=args.device)
    model = (ss.init_params(args.seed) if params is None
             else ss.shard_params_fn(params))
    rng = np.random.default_rng(args.seed)
    batch = classic_batch(cfg, args.batch, args.prompt_len, rng)

    def sync():
        if ss.device.type == "cuda":
            torch.cuda.synchronize(ss.device)

    t0 = time.perf_counter()
    h_last, caches = ss.prefill_fn(model, batch)
    sync()
    print(f"prefill {args.batch}x{args.prompt_len}: "
          f"{time.perf_counter() - t0:.2f}s")

    # greedy decode from the last prefill hidden, through the decode head
    tok = greedy_from_logits(ss.logits_fn(model, h_last), cfg.vocab_size)
    generated = [tok.cpu().numpy()]
    pos = torch.full((args.batch,), args.prompt_len, dtype=torch.int32,
                     device=ss.device)
    t0 = time.perf_counter()
    for _ in range(args.gen):
        logits, caches = ss.decode_fn(model, caches, tok, pos)
        tok = greedy_from_logits(logits, cfg.vocab_size)
        generated.append(tok.cpu().numpy())
        pos = pos + 1
    sync()
    dt = time.perf_counter() - t0
    print(f"decode {args.gen} steps: {dt:.2f}s "
          f"({args.gen * args.batch / dt:.1f} tok/s)")
    gen = np.stack(generated, axis=1)
    print("generated ids (first row):", gen[0][:16])
    assert gen.shape == (args.batch, args.gen + 1)
    assert (gen >= 0).all() and (gen < cfg.vocab_size).all()
    print("serve ok (classic loop)")
    return gen


def continuous_batching(cfg, args):
    import numpy as np

    from repro_torch import api
    from repro_torch.core.placement import Placement

    d_, m_ = (int(v) for v in args.mesh.split("x"))
    mesh = (None if (d_, m_) == (1, 1)
            else Placement(("data", "model"), (d_, m_)))
    sess = api.compile(cfg, mode="serve", backend=args.backend,
                       stages=args.stages, device=args.device, mesh=mesh,
                       seed=args.seed, num_groups=args.groups,
                       group_size=args.slots,
                       max_prompt_len=args.prompt_len,
                       max_new_tokens=args.gen,
                       cache_len=args.cache_len or None)
    print(sess.describe())

    rng = np.random.default_rng(args.seed)
    requests = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, (args.prompt_len,))
        gen = max(1, args.gen - (i % max(1, args.gen // 2)))  # unequal lengths
        requests.append((prompt.astype(np.int32), gen))

    outs = sess.generate(requests)
    sess.close()
    stats = sess.last_stats
    print(f"{args.requests} requests, {stats['tokens']} tokens in "
          f"{stats['rounds']} rounds / {stats['wall_s']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s, "
          f"{stats['admitted_mid_flight']} admitted mid-flight)")
    print("generated ids (first request):", outs[0][:16])
    assert all(len(o) == g for o, (_, g) in zip(outs, requests))
    assert all((o >= 0).all() and (o < cfg.vocab_size).all() for o in outs)
    print("serve ok (continuous batching)")
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced config of --arch")
    ap.add_argument("--backend", default="actors",
                    choices=("actors", "monolithic"))
    ap.add_argument("--classic", action="store_true",
                    help="force the monolithic batched prefill+decode loop")
    ap.add_argument("--stages", type=int, default=None)
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--slots", type=int, default=2,
                    help="decode slots per request group")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4,
                    help="batch size of the classic loop")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=0)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM: D data-parallel x M model-parallel ranks")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card ('cuda')")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_config

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.classic or cfg.embed_frontend or cfg.encoder_decoder:
        return classic_loop(cfg, args)
    return continuous_batching(cfg, args)


if __name__ == "__main__":
    main()
