"""repro_torch — the OneFlow reproduction ported to PyTorch and CUDA.

The JAX package ``repro`` is the reference this package is held against;
nothing here imports it (or jax). The public surface is
:mod:`repro_torch.api`::

    from repro_torch import api
    sess = api.compile(graph, mode="train", params=params, stages=4,
                       num_microbatches=8)  # device=None means "cuda"
    res = sess.step(**batch)                # SBP plan -> stages -> 1F1B
    sess = api.compile("qwen3-1.7b", mode="serve", backend="actors",
                       stages=2)
    outs = sess.generate([(prompt_ids, 16), ...])

Its kernels are CUDA C++ for Hopper (``src/repro_torch/csrc``), built at
first use; CPU tensors take each kernel's plain PyTorch version.
"""
