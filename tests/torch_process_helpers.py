"""Picklable pieces the process-runtime tests ship to worker processes.

A worker unpickles a spec builder (or an optimizer's lr schedule) by
reference, which imports the module that defines it. This module imports
no jax, so neither do the workers of the tests that use it, including the
tests that hold the port to the JAX package in the driver.

The builders are module-level classes (spawn pickles them by reference);
each worker calls its builder locally, so the actor closures never cross a
process boundary, only the builder's plain attributes do.
"""
import sys

import numpy as np
import torch

from repro_torch.runtime.actor import ActorSpec


def lr_schedule(step):
    """A scheduled lr (module-level, so it ships)."""
    return 1e-3 * 0.9 ** step


def imports_jax_or_repro() -> bool:
    """Whether this process has imported jax or the JAX package."""
    return any(m == "jax" or m.startswith("jax.") or m == "repro"
               or m.startswith("repro.") for m in sys.modules)


class ChainBuilder:
    """src (node 0) -> mid (node 1) -> sink (node 2): base + v -> x + 1 ->
    x * 2.

    ``src`` emits a float32 vector, so the cross-node edges carry
    measurable bytes; its ``on_epoch`` hook takes a per-epoch base value
    through ``ctx``. ``src`` also stashes a private (unpicklable) value
    under a ``"__"`` key: it must be stripped at the node boundary, never
    pickled onto the wire.
    """

    def __init__(self, n=4):
        self.n = n

    def __call__(self):
        base = [0.0]

        def set_base(v):
            if v is not None:
                base[0] = float(v)

        def src(version):
            return {"x": torch.full((8,), base[0] + version),
                    "__local_only__": lambda: None}

        def mid(p, version):
            assert "__local_only__" not in p, sorted(p)
            assert isinstance(p["x"], torch.Tensor)
            return {"x": p["x"] + 1.0}

        def sink(p, version):
            assert "__local_only__" not in p, sorted(p)
            return p["x"] * 2.0

        specs = [
            ActorSpec("src", src, (), out_regs=2, max_fires=self.n,
                      node=0, thread=0, wants_version=True,
                      on_epoch=set_base),
            ActorSpec("mid", mid, ("src",), out_regs=2, node=1, thread=0,
                      wants_version=True),
            ActorSpec("sink", sink, ("mid",), out_regs=2, node=2, thread=0,
                      wants_version=True),
        ]
        return specs, "sink"


def _emit_version(version):
    return np.float32(version)


class CrashBuilder:
    """Two nodes; the node-1 actor raises on its third fire."""

    def __call__(self):
        def boom(x, version):
            if version == 2:
                raise RuntimeError("kaboom on version 2")
            return x

        specs = [
            ActorSpec("src", _emit_version, (), out_regs=2, max_fires=6,
                      node=0, thread=0, wants_version=True),
            ActorSpec("bad", boom, ("src",), out_regs=2, node=1, thread=0,
                      wants_version=True),
        ]
        return specs, "bad"


class StuckBuilder:
    """``sink`` needs both ``src`` and ``never``; ``never`` has no fires,
    so ``src`` stalls against its register quota and the epoch never
    completes."""

    def __call__(self):
        specs = [
            ActorSpec("src", _emit_version, (), out_regs=2, max_fires=3,
                      node=0, thread=0, wants_version=True),
            ActorSpec("never", _emit_version, (), out_regs=1, max_fires=0,
                      node=0, thread=1, wants_version=True),
            ActorSpec("sink", lambda a, b: a, ("src", "never"), out_regs=1,
                      node=1, thread=0),
        ]
        return specs, "sink"


class EchoBuilder:
    """``src`` (node 0) emits the payload the epoch's ``ctx`` gave it;
    ``echo`` (node 1) sends back what arrived, with whether its process has
    imported jax or the JAX package and its pid. The payload crosses two
    process boundaries (driver -> node 0 -> node 1) and comes back to the
    driver: the wire format, end to end."""

    def __call__(self):
        cell = {"payload": None}

        def on_epoch(v):
            cell["payload"] = v

        def src():
            return cell["payload"]

        def echo(p):
            import os
            return {"echo": p, "jax": imports_jax_or_repro(),
                    "pid": os.getpid()}

        specs = [
            ActorSpec("src", src, (), out_regs=1, max_fires=1, node=0,
                      thread=0, on_epoch=on_epoch),
            ActorSpec("echo", echo, ("src",), out_regs=1, node=1, thread=0),
        ]
        return specs, "echo"
