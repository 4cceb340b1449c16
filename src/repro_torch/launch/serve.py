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

Port of ``repro/launch/serve.py:80-150`` (``continuous_batching``): requests
with differing generation lengths are packed into decode slots, finished
requests retire and queued ones are admitted mid-flight, and the stage
actors overlap across request groups. Runs on the card by default
(``--device cuda``); ``--device cpu --smoke`` runs the reduced config on the
plain PyTorch path. ``--mesh DxM`` serves a dense or Mamba-2 model on a
``("data", "model")`` mesh of D x M ranks (threads; on one card every rank
shares it), as the reference's ``launch/serve.py:130-141`` does; MLA and MoE
models (deepseek-v2-lite-16b) serve on one device. Weights are the port's
seeded init (``--seed``), drawn in the config's compute dtype.
"""
from __future__ import annotations

import argparse


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
    ap.add_argument("--stages", type=int, default=None)
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--slots", type=int, default=2,
                    help="decode slots per request group")
    ap.add_argument("--requests", type=int, default=6)
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
    return continuous_batching(cfg, args)


if __name__ == "__main__":
    main()
