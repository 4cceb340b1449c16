"""repro_torch — the OneFlow reproduction ported to PyTorch and CUDA.

The JAX package ``repro`` is the reference this package is held against;
nothing here imports it (or jax). The public surface is
:mod:`repro_torch.api`::

    from repro_torch import api
    sess = api.compile("qwen3-1.7b", mode="serve", backend="actors",
                       stages=2)            # device=None means "cuda"
    outs = sess.generate([(prompt_ids, 16), ...])

Its kernels are CUDA C++ for Hopper (``src/repro_torch/csrc``), built at
first use; CPU tensors take each kernel's plain PyTorch version.
"""
