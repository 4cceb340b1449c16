"""End-to-end training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --steps 50 --batch 8 --seq 128 --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --mesh 1x2 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
        --smoke --device cpu --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-v2-lite-16b --smoke --device cpu --steps 3

The flags are the reference's (``repro/launch/train.py``) plus ``--device``
(default: the card). ``--smoke`` uses the reduced config. ``--mesh DxM``
trains on a ``("data", "model")`` mesh of D x M ranks (threads; on one
card virtual ranks of it), tensor-parallel over ``model`` and
data-parallel over ``data``; ``--batch`` must divide by D. The data
pipeline is the actor-runtime prefetcher (paper §6.1); checkpointing every
``--ckpt-every`` steps writes the reference's format, the global params
assembled from the ranks. ``--zero`` (the default, as in the reference)
keeps float32 masters and AdamW moments as flat rows sharded over the data
axes, gathered in the compute dtype each step (paper §6.4);
``--no-zero`` keeps a replica of each rank's shards and moments. An MLA +
MoE config (deepseek-v2-lite) trains as well, its routers' load-balance
loss in the loss; on a mesh its heads and experts split over ``model``::

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-v2-lite-16b --smoke --device cpu --mesh 1x2 \
        --batch 4 --seq 32 --steps 3
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config for CPU")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--zero", action="store_true", default=True)
    ap.add_argument("--no-zero", dest="zero", action="store_false")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="checkpoints/run")
    ap.add_argument("--data-buffers", type=int, default=2)
    ap.add_argument("--mesh", default="1x1", help="data x model")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import ActorDataPipeline, SyntheticLM
    from repro_torch.models.common import MeshPlan
    from repro_torch.models.convert import params_to_jax
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.steps import make_train_step

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    d_, m_ = (int(v) for v in args.mesh.split("x"))
    plan = MeshPlan(("data", "model"), (d_, m_))

    ts = make_train_step(cfg, plan, optimizer=AdamWConfig(lr=args.lr),
                         zero=args.zero, device=args.device)
    params = ts.init_params(0)
    opt_state = ts.init_opt(params)

    src = SyntheticLM(cfg.vocab_size, args.batch, args.seq)
    pipe = ActorDataPipeline(src, num_batches=args.steps,
                             buffers=args.data_buffers)

    t0 = time.time()
    losses = []
    for step, tokens in enumerate(pipe):
        batch = {"tokens": tokens}
        params, opt_state, metrics = ts.step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % 10 == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tok_s = (step + 1) * args.batch * args.seq / dt
            print(f"step {step:4d}  loss {loss:.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):.3f}  "
                  f"{tok_s:,.0f} tok/s")
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir,
                            {"params": params_to_jax(params.state_dict(), cfg)},
                            step=step + 1, meta={"arch": cfg.name})
            print(f"  checkpoint @ step {step + 1} -> {args.ckpt_dir}")
    print(f"first loss {losses[0]:.4f} -> last {losses[-1]:.4f} "
          f"({'improved' if losses[-1] < losses[0] else 'NOT improved'})")
    assert losses[-1] < losses[0], "training did not reduce the loss"


if __name__ == "__main__":
    main()
