"""Serving: continuous-batching admission, the paged KV/SSM cache pool and
sampling (port of ``repro/serve/``).

* :mod:`repro_torch.serve.paged_cache` -- one preallocated page slab per
  stage layer and positional key plus per-request state rows; alloc/free
  are host bookkeeping (:class:`PagePool`), gather/scatter are fixed-shape
  torch index ops on the stage's device, shared-prefix pages are
  refcounted.
* :mod:`repro_torch.serve.sampler` -- temperature/top-k/top-p sampling from
  a generator owned by the stage that holds the decode head.
* :mod:`repro_torch.serve.admission` -- the continuous-batching admission
  scheduler, including chunked prefill.

Everything is reached through ``api.compile(cfg, mode="serve",
cache="paged", page_len=..., num_pages=..., prefill_chunk=...,
sampling=...)``; the dense path stays the bit-identity reference.
"""
from repro_torch.serve.paged_cache import PagedCacheSpec, PagePool
from repro_torch.serve.sampler import SamplingSpec

__all__ = ["PagedCacheSpec", "PagePool", "SamplingSpec"]
