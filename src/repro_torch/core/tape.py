"""Per-rank programs of local steps and collectives, and their reverse mode.

A :class:`LocalProgram` is what one rank runs: local steps (torch ops) and
collective steps (mesh collectives, :mod:`repro_torch.core.mesh`) over the
names of one environment. The graph lowering builds one per (sub)graph
(:mod:`repro_torch.core.lowering`) and the model's training on a mesh one
per model (:func:`repro_torch.models.transformer.mesh_loss_program`).

Training runs a program through :func:`taped_forward`, which records an
:class:`OpTape`, and :func:`taped_backward`, which walks it in reverse on
the rank's own thread: ``torch.autograd.grad`` step by step for the local
steps, the explicit transpose for a collective one, summing cotangents in
that fixed order. No autograd node ever waits at a rendezvous: PyTorch runs
every backward node of a card on one worker thread, so a node that waited
for another rank of the same card would hang the run
(:func:`repro_torch.core.mesh._collective` refuses to run inside a
backward). A local step marked ``remat`` keeps only its inputs in the
forward and runs again inside the backward (the reference's remat policy,
which saves the collectives' outputs and recomputes the local math between
them); a collective is never run again.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

#: marks the environment names a program makes up (boxed copies, an op's
#: internal values); graph tensor and parameter names never hold it
INTERNAL = "#"


@dataclasses.dataclass
class Step:
    """One step of a program, run by every rank: ``outs = fn(*ins)`` over
    names of the program's environment. A local step runs torch ops, which
    the training tape differentiates with autograd (again from its saved
    inputs in the backward where ``remat``); a collective step
    (``collective=True``) runs mesh collectives outside autograd and
    carries its ``transpose``: the cotangent of ``outs[0]`` to that of
    ``ins[0]`` (None where nothing is differentiated through it)."""

    fn: Callable
    ins: Tuple[str, ...]
    outs: Tuple[str, ...]
    collective: bool = False
    transpose: Optional[Callable] = None
    remat: bool = False


@dataclasses.dataclass
class LocalProgram:
    """A program as one rank runs it: ``steps`` in order from
    ``input_names`` to ``output_names``; output ``i`` is read from the
    environment name ``out_keys[i]`` (its boundary-boxed copy where the
    stored signature differs from the boundary's). Calling it runs
    inference on one rank's shards (inside :func:`repro_torch.core.mesh
    .spmd` on a mesh of several)."""

    steps: List[Step]
    input_names: Tuple[str, ...]
    output_names: Tuple[str, ...]
    out_keys: Tuple[str, ...]

    def __call__(self, *values) -> Tuple:
        env = dict(zip(self.input_names, values))
        for st in self.steps:
            res = st.fn(*[env[n] for n in st.ins])
            env.update(zip(st.outs, res if len(st.outs) > 1 else (res,)))
        return tuple(env[k] for k in self.out_keys)


@dataclasses.dataclass
class OpTape:
    """What one forward through a program keeps on one rank for its
    backward, one record per differentiated step: ``(outs, leaves,
    values)`` for a local step -- its output names, input leaves ``((name,
    leaf), ...)`` and outputs with the step's autograd graph, or for a
    ``remat`` step a function that runs the step again and returns both --
    and ``(out, in, transpose, like)`` for a collective step."""

    records: List[Tuple]


def _call(st: Step, args: Sequence, live):
    """Run the local step ``st`` on ``args``, the inputs named in ``live``
    as fresh leaves that require grad (one per distinct name). Returns
    ``(((name, leaf), ...), outputs)``."""
    leaves: Dict[str, torch.Tensor] = {}
    call = []
    for n, a in zip(st.ins, args):
        if n in live:
            if n not in leaves:
                leaves[n] = a.detach().requires_grad_(True)
            call.append(leaves[n])
        else:
            call.append(a)
    res = st.fn(*call)
    return tuple(leaves.items()), (tuple(res) if len(st.outs) > 1
                                   else (res,))


def _rerun(st: Step, args: Sequence, live: set):
    """A ``remat`` step's record: the step run again on its saved inputs,
    with grad."""
    def run():
        with torch.enable_grad():
            return _call(st, args, live)
    return run


def taped_forward(program: LocalProgram, diff: set, values: Sequence):
    """Run ``program`` on one rank recording an :class:`OpTape`. A value is
    differentiated when it is a name in ``diff`` or an internal value
    computed from one; a local step's differentiated inputs enter as fresh
    leaves (one per distinct name) that require grad, and its outputs
    leave it detached. A ``remat`` step runs as any other (the same
    kernels, so the same bits as its rerun) but is recorded by its inputs,
    its graph dropped. Returns ``(outputs, tape)``."""
    env = dict(zip(program.input_names, values))
    live = {n for n in program.input_names if n in diff}
    records: List[Tuple] = []

    def keep(n: str) -> bool:
        return n in diff or INTERNAL in n

    with torch.enable_grad():
        for st in program.steps:
            if st.collective:
                src, (dst,) = st.ins[0], st.outs
                out = st.fn(env[src])
                env[dst] = out
                if st.transpose is not None and src in live:
                    if keep(dst):
                        live.add(dst)
                    records.append((dst, src, st.transpose,
                                    (out.shape, out.dtype, out.device)))
                continue
            args = [env[n] for n in st.ins]
            leaves, outs = _call(st, args, live)
            if leaves and any(o.requires_grad for o in outs):
                # a remat step drops its graph now and keeps its inputs
                records.append(
                    (st.outs, (), _rerun(st, args, {n for n, _ in leaves}))
                    if st.remat else (st.outs, leaves, outs))
                live.update(n for n, o in zip(st.outs, outs)
                            if o.requires_grad and keep(n))
            env.update((n, o.detach()) for n, o in zip(st.outs, outs))
    return tuple(env[k] for k in program.out_keys), OpTape(records)


def taped_backward(tape: OpTape, cotangents: Dict[str, torch.Tensor],
                   wanted: Sequence[str]) -> Tuple:
    """Reverse-mode over one rank's ``tape``: start from ``cotangents``
    (output seeds and the cotangents later stages sent for this program's
    inputs, keyed by environment name), walk the steps in reverse and add
    each step's contribution to its inputs' cotangents in that order.
    Every collective record runs its transpose (on zeros where no
    cotangent reached it), so all ranks call the same collectives. Returns
    one cotangent per ``wanted`` name (``None`` where nothing flowed)."""
    cot = {n: c for n, c in cotangents.items() if c is not None}

    def add(n, g):
        cot[n] = g if n not in cot else cot[n] + g

    for rec in reversed(tape.records):
        if len(rec) == 4:
            dst, src, transpose, like = rec
            g = cot.pop(dst, None)
            if g is None:
                shape, dtype, device = like
                g = torch.zeros(shape, dtype=dtype, device=device)
            add(src, transpose(g))
            continue
        outs, leaves, values = rec
        seeds = [cot.pop(n, None) for n in outs]
        if all(g is None for g in seeds):
            continue
        if callable(values):          # a remat step: run it again now
            leaves, values = values()
        pairs = [(v, g) for v, g in zip(values, seeds)
                 if g is not None and v.requires_grad]
        if not pairs:
            continue
        grads = torch.autograd.grad([v for v, _ in pairs],
                                    [leaf for _, leaf in leaves],
                                    [g for _, g in pairs], allow_unused=True)
        for (n, _), gi in zip(leaves, grads):
            if gi is not None:
                add(n, gi)
    tape.records.clear()
    return tuple(cot.get(n) for n in wanted)
