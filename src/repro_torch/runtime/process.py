"""Process-backed actor runtime -- one worker process per node id (paper §5).

The 64-bit actor address (:mod:`repro_torch.runtime.messages`) encodes a
*node* field; here it stops being notation: :class:`ProcessRuntime` spawns
one worker process per distinct node id of the spec graph, each running a
:class:`repro_torch.runtime.threaded._LocalEngine` over its own (node,
thread) keys. Same-node Reqs keep their in-process ``payload``; a Req that
crosses nodes has its payload rebuilt by
:func:`repro_torch.runtime.base.encode_payload` and travels a
``torch.multiprocessing`` queue. The actor protocol is the one the threads
runtime speaks: the workers coordinate by req and ack alone, with no
central scheduler (§5's "no middleman").

Tensors cross as tensors. A CUDA tensor is exported by CUDA IPC (the
reductions ``torch.multiprocessing`` registers with the queues' pickler:
the receiver maps the sender's allocation and waits on the sender's event),
so an activation between stages or logits for the driver are never copied
to the host; a CPU tensor crosses by shared memory. Who owns what:

* a worker owns every tensor it computes with. What arrives from another
  process -- a message, or the driver's ``ctx`` -- is a view of the
  sender's memory; a worker copies a CUDA one into its own memory on
  arrival (a CUDA tensor received by IPC cannot be sent on, and the copy
  lets the sender free its block), before anything updates it in place;
* the driver's mirrors of worker state (a train executor's params and
  optimizer states, refreshed from the ``opt{s}`` outputs every step) are
  views of the workers' tensors, read between epochs. They die with their
  worker and are then dropped unread.

Each epoch ends in every worker with ``torch.cuda.ipc_collect()``, which
frees the blocks a consumer has released since. A worker's "stats" reply
carries its instrumentation, its kernel launch counts
(:mod:`repro_torch.kernels.counters`, which the driver adds into its own
counters) and, on a card, its peak and current allocated bytes.

Spec graphs are shipped as a *picklable builder* (called once in the driver
for metadata, once in each worker): closures over tensors never cross, each
worker lowers its stages from the builder's recipe
(:mod:`repro_torch.runtime.recipes`). Workers are spawned (the driver has
usually initialised CUDA, which a forked child cannot use), load the kernel
libraries the driver built before spawning them, and import nothing of JAX.

Termination: each worker reports local quiescence *transitions* (see the
counter discipline in :mod:`repro_torch.runtime.threaded`). When every
node's latest report is quiescent, the driver probes all workers for their
(quiescent, sent, received) counters and concludes after two consecutive
all-quiescent waves with equal and unchanged sums (the four-counter
method). Every protocol message is epoch-tagged: a worker holds messages
that race ahead of the driver's epoch broadcast and drops stale ones, so a
timed-out epoch cannot poison the next.
"""
from __future__ import annotations

import dataclasses
import io
import os
import pickle
import queue
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.multiprocessing as tmp

from repro_torch.runtime.base import (RemoteTraceback, Runtime, SpecBuilder,
                                      WorkerError, _check_epoch_names,
                                      _encode, encode_payload, map_tensors)
from repro_torch.runtime.messages import Req, node_of


class _TensorBlindPickler(pickle.Pickler):
    """Pickles everything but tensors, which it takes as given: a check
    that a builder will ship, without copying or exporting a weight."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            return int, ()
        return NotImplemented


def check_picklable(obj, what: str = "spec builder") -> None:
    """Raise ``ValueError`` unless ``obj`` can be shipped to a worker
    process (a lambda, a closure or a locally defined class cannot)."""
    try:
        _TensorBlindPickler(io.BytesIO(),
                            protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    except Exception as exc:
        raise ValueError(
            f"runtime='processes' requires a picklable {what} (it is "
            "shipped to one worker process per node; an optimizer's lr "
            "schedule must be a module-level function, not a lambda); "
            f"pickling failed with: {exc!r}") from exc


@dataclasses.dataclass(frozen=True)
class WorkerSetup:
    """What a worker does before it builds its actors: take its card
    (``device``) or, on the CPU, the driver's intra-op thread count (a CPU
    op then splits its work as the threads runtime's does); load the kernel
    libraries the driver built (``sources``); and take the driver's float32
    matmul settings, so both runtimes compute the same bits."""

    device: str
    num_threads: int
    sources: Tuple[str, ...]
    matmul_precision: str
    allow_tf32: bool
    cudnn_allow_tf32: bool
    allow_bf16_reduction: bool
    allow_fp16_reduction: bool


def worker_setup(builder) -> WorkerSetup:
    """The setup for ``builder``'s workers, from its recipe's device (the
    CPU without one). On a card every kernel library is built here, in the
    driver, before any worker starts: a cold build cache would otherwise
    run ``nvcc`` once in every worker."""
    device = getattr(getattr(builder, "recipe", None), "device", None)
    dev = torch.device("cpu" if device is None else device)
    sources: Tuple[str, ...] = ()
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        sources = tuple(sorted(p.name for p in _build.CSRC.glob("*.cu")))
        _build.build(sources)
    matmul = torch.backends.cuda.matmul
    return WorkerSetup(
        device=str(dev), num_threads=torch.get_num_threads(),
        sources=sources,
        matmul_precision=torch.get_float32_matmul_precision(),
        allow_tf32=matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        allow_bf16_reduction=matmul.allow_bf16_reduced_precision_reduction,
        allow_fp16_reduction=matmul.allow_fp16_reduced_precision_reduction)


def _apply_setup(setup: WorkerSetup) -> None:
    torch.set_float32_matmul_precision(setup.matmul_precision)
    matmul = torch.backends.cuda.matmul
    matmul.allow_tf32 = setup.allow_tf32
    matmul.allow_bf16_reduced_precision_reduction = setup.allow_bf16_reduction
    matmul.allow_fp16_reduced_precision_reduction = setup.allow_fp16_reduction
    torch.backends.cudnn.allow_tf32 = setup.cudnn_allow_tf32
    dev = torch.device(setup.device)
    if dev.type != "cuda":
        torch.set_num_threads(setup.num_threads)
        return
    # raises here, and the driver gets the traceback, when the card cannot
    # be reached (no card, or a compute mode that refuses this process)
    torch.cuda.set_device(0 if dev.index is None else dev.index)
    torch.cuda.init()
    from repro_torch.kernels import _build
    for source in setup.sources:
        _build.load(source)


def _own_tensor(t: torch.Tensor) -> torch.Tensor:
    return t.clone() if t.is_cuda else t


def _own(v: Any) -> Any:
    """``v`` as the receiving worker's own: every CUDA tensor (a view of
    the sender's memory by IPC) copied into this process's memory."""
    return map_tensors(v, _own_tensor)


def _device_stats(setup: WorkerSetup) -> Dict[str, Any]:
    out: Dict[str, Any] = {"pid": os.getpid(), "device": setup.device}
    if torch.device(setup.device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.ipc_collect()
        out.update(device=f"cuda:{torch.cuda.current_device()}",
                   device_name=torch.cuda.get_device_name(),
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   allocated_bytes=torch.cuda.memory_allocated())
    return out


def _worker_main(node: int, inbox, driver_q, peer_queues,
                 setup: WorkerSetup) -> None:
    """Entry point of one node's worker process (module-level: spawn
    pickles the function by reference). The builder, the collected names
    and the fault plan arrive as the first message of ``inbox``: a spawn
    writes its arguments to the child before it returns, so a builder that
    carries tensors (a serve recipe's model) would start the workers one
    after another; through the queue they start together."""
    state = {"epoch": 0, "sent": 0, "recv": 0}
    # wall-clock marks of the worker's start (the driver subtracts its
    # spawn time): entered, set up (card, kernel libraries), builder
    # received, actors built
    marks = {"entered": time.time()}
    try:
        import threading

        from repro_torch.kernels import counters
        from repro_torch.runtime.threaded import _LocalEngine

        _apply_setup(setup)
        marks["set_up"] = time.time()
        _, builder, collect_names, faults = inbox.get()
        marks["received"] = time.time()
        specs, _ = builder()
        local_keys = sorted({(s.node, s.thread) for s in specs
                             if s.node == node})
        engine = _LocalEngine(specs, local_keys=local_keys)
        engine.collect_names = set(collect_names)
        if faults is not None:
            from repro_torch.runtime.chaos import FaultInjector
            # each worker routes only the messages its own actors send, so
            # every fault still applies once graph-wide; a KillWorker here
            # hard-exits this process and the driver's liveness check turns
            # the exit code into a WorkerError
            engine.fault_injector = FaultInjector(faults, process_mode=True)
        sent_lock = threading.Lock()

        def send_remote(msg):
            if isinstance(msg, Req):
                msg = dataclasses.replace(
                    msg, payload=encode_payload(msg.payload))
            # count BEFORE the message can possibly be received: the probe
            # sums rely on sent >= received at all times
            with sent_lock:
                state["sent"] += 1
            peer_queues[node_of(msg.dst)].put(("msg", state["epoch"], msg))

        def on_output(name, value, version):
            driver_q.put(("out", state["epoch"], node, name,
                          encode_payload(value), version))

        def on_quiescence(flag):
            driver_q.put(("q", state["epoch"], node, flag))

        def on_error(exc, key):
            driver_q.put(("error", state["epoch"], node,
                          type(exc).__name__, str(exc),
                          "".join(traceback.format_exception(exc))))

        engine.send_remote = send_remote
        engine.on_output = on_output
        engine.on_quiescence = on_quiescence
        engine.on_error = on_error
        marks["built"] = time.time()
        driver_q.put(("ready", node, dict(_device_stats(setup), marks=marks)))
        timing = {"own_s": 0.0, "epoch_started": time.time()}

        held: List[Tuple[int, Any]] = []   # messages that raced the epoch
        while True:
            item = inbox.get()
            kind = item[0]
            if kind == "stop":
                # join the actor threads before the interpreter exits under
                # them (one inside a card op would abort the process)
                engine.stop_workers()
                engine.join_workers(2.0)
                driver_q.cancel_join_thread()
                return
            if kind == "epoch":
                _, e, ctx, fires = item
                del item
                t = time.time()
                ctx = {k: _own(v) for k, v in ctx.items()}
                timing = {"own_s": time.time() - t, "epoch_started": t}
                engine.stop_workers()
                engine.join_workers(1.0)
                state["epoch"] = e
                with sent_lock:
                    state["sent"] = 0
                state["recv"] = 0
                engine.start_epoch(ctx, fires)
                del ctx
                replay = [m for ee, m in held if ee == e]
                held = [(ee, m) for ee, m in held if ee > e]
                for m in replay:
                    state["recv"] += 1
                    engine.deliver(_own_msg(m))
                del replay
            elif kind == "msg":
                _, e, m = item
                del item
                if e == state["epoch"]:
                    state["recv"] += 1
                    # deliver, not post: the message was fault-routed at
                    # the sending worker's engine
                    engine.deliver(_own_msg(m))
                elif e > state["epoch"]:
                    held.append((e, m))
                # e < epoch: a stale message of an abandoned epoch -- drop
                del m
            elif kind == "probe":
                _, e, k = item
                if e == state["epoch"]:
                    with sent_lock:
                        s = state["sent"]
                    driver_q.put(("probe_ack", e, k, node,
                                  engine.quiescent, s, state["recv"]))
            elif kind == "stats":
                _, e = item
                if e == state["epoch"]:
                    engine.stop_workers()
                    engine.join_workers(1.0)
                    info = _device_stats(setup)
                    info["counts"] = counters.take()
                    # seconds copying the driver's ctx into this process,
                    # and from the epoch's start to now
                    info["own_s"] = timing["own_s"]
                    info["epoch_s"] = time.time() - timing["epoch_started"]
                    driver_q.put(("stats", e, node, engine.snapshot(), info))
                else:
                    driver_q.put(("stats", e, node, ({}, {}, {}, {}), {}))
    except BaseException as exc:  # noqa: BLE001 -- ship everything home
        try:
            driver_q.put(("error", state["epoch"], node,
                          type(exc).__name__, str(exc),
                          "".join(traceback.format_exception(exc))))
        except Exception:
            pass


def _own_msg(m):
    if isinstance(m, Req):
        return dataclasses.replace(m, payload=_own(m.payload))
    return m


class ProcessRuntime(Runtime):
    """Drive an actor graph across one worker process per node id.

    ``builder`` is a picklable callable returning ``(specs,
    collect_outputs_of)``; ``collect_outputs_of`` here overrides the
    builder's choice. Workers are spawned once in ``__init__`` (taking
    ``start_seconds``) and reused across :meth:`run` epochs; :meth:`close`
    (or context-manager exit) tears them down. Besides the
    :class:`~repro_torch.runtime.base.Runtime` instrumentation,
    ``workers`` holds each node's ``pid``, ``device`` and ``start_s``
    (seconds from the spawn to its interpreter's entry, then its setup,
    the builder's arrival and its actors) and, after a run,
    ``last_worker_stats`` each node's last stats (``own_s``, the seconds
    it spent copying the driver's ``ctx``; ``epoch_s``; on a card
    ``peak_bytes`` and ``allocated_bytes``); the workers' kernel launches
    are added to this process's counters after every run.
    """

    def __init__(self, builder: SpecBuilder, collect_outputs_of=None,
                 start_timeout: float = 300.0, faults=None):
        check_picklable(builder)
        specs, default_collect = builder()
        collect = (default_collect if collect_outputs_of is None
                   else collect_outputs_of)
        self._collect_single = collect is None or isinstance(collect, str)
        names = [collect] if self._collect_single else list(collect)
        self._collect_names = [n for n in names if n is not None]
        self._specs = list(specs)
        self._spec_by_name = {s.name: s for s in self._specs}
        for n in self._collect_names:
            if n not in self._spec_by_name:
                raise ValueError(
                    f"collect_outputs_of names unknown actor {n!r}")
        self.nodes = sorted({s.node for s in self._specs})
        self._closed = True         # until the workers exist
        self._procs: Dict[int, Any] = {}
        self._epoch = 0
        self.last_history: Dict[str, List[Tuple[float, float]]] = {}
        self.last_peak_regs: Dict[str, int] = {}
        self.last_edge_bytes: Dict[Tuple[str, str], int] = {}
        self.last_fired: Dict[str, int] = {}
        self.last_worker_stats: Dict[int, Dict[str, Any]] = {}
        self.workers: Dict[int, Dict[str, Any]] = {}
        setup = worker_setup(builder)
        self.device = setup.device
        ctx = tmp.get_context("spawn")
        self._driver_q = ctx.Queue()
        self._node_qs = {n: ctx.Queue() for n in self.nodes}
        self._closed = False
        t0 = time.perf_counter()
        spawned_at = time.time()
        for n in self.nodes:
            p = ctx.Process(
                target=_worker_main,
                args=(n, self._node_qs[n], self._driver_q, self._node_qs,
                      setup),
                name=f"repro-node{n}", daemon=True)
            p.start()
            self._procs[n] = p
        for n in self.nodes:
            self._node_qs[n].put(("build", builder,
                                  tuple(self._collect_names), faults))
        self._await_ready(start_timeout)
        self.start_seconds = time.perf_counter() - t0
        # each worker's start in seconds from the spawn: its interpreter,
        # imports and the builder's unpickling, its setup, its actors
        for w in self.workers.values():
            m = w.pop("marks")
            w["start_s"] = {"boot": m["entered"] - spawned_at,
                            "setup": m["set_up"] - m["entered"],
                            "builder": m["received"] - m["set_up"],
                            "build": m["built"] - m["received"]}

    # -- startup -----------------------------------------------------------------
    def _await_ready(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while len(self.workers) < len(self.nodes):
            try:
                item = self._driver_q.get(timeout=0.2)
            except queue.Empty:
                self._check_alive()
                if time.monotonic() > deadline:
                    missing = sorted(set(self.nodes) - set(self.workers))
                    self.close()
                    raise TimeoutError(
                        "process runtime workers failed to start; missing "
                        f"nodes: {missing}")
                continue
            if item[0] == "ready":
                self.workers[item[1]] = item[2]
            elif item[0] == "error":
                self._raise_worker_error(item)

    # -- epoch execution ---------------------------------------------------------
    def run(self, ctx: Optional[Dict[str, Any]] = None,
            fires: Optional[Dict[str, int]] = None,
            timeout: float = 120.0):
        if self._closed:
            raise RuntimeError("process runtime is closed")
        _check_epoch_names(self._specs, ctx, fires)
        ctx = ctx or {}
        fires = fires or {}
        effective = {s.name: fires.get(s.name, s.max_fires)
                     for s in self._specs}
        if not any(v is not None for v in effective.values()):
            raise ValueError(
                "process runtime needs at least one bounded actor")
        self._epoch += 1
        e = self._epoch
        node_of_name = {s.name: s.node for s in self._specs}
        for n in self.nodes:
            ctx_n = {k: _encode(v) for k, v in ctx.items()
                     if node_of_name[k] == n}
            fires_n = {k: v for k, v in fires.items()
                       if node_of_name[k] == n}
            self._node_qs[n].put(("epoch", e, ctx_n, fires_n))
        outputs: Dict[str, List[Any]] = {n: [] for n in self._collect_names}
        qstate: Dict[int, bool] = {}
        stats: Dict[int, Any] = {}
        deadline = time.monotonic() + timeout
        # Termination (Mattern's four counters, two waves): the quiescence
        # reports only trigger a probe. Each worker answers with its
        # current (quiescent, sent, received); the epoch ends after TWO
        # consecutive all-quiescent waves with equal and unchanged
        # sum(sent) == sum(received) -- monotone counters make that sound
        # although the replies are not simultaneous. Outputs are queued
        # before their fire's counter moves, so by then every collected
        # output has reached the driver's FIFO queue ahead of the replies.
        probe_k = 0
        awaiting: Optional[int] = None
        acks: Dict[int, Tuple[bool, int, int]] = {}
        prev_sums: Optional[Tuple[int, int]] = None
        done = False
        while not done:
            if (awaiting is None and len(qstate) == len(self.nodes)
                    and all(qstate.values())):
                probe_k += 1
                awaiting = probe_k
                acks = {}
                for n in self.nodes:
                    self._node_qs[n].put(("probe", e, probe_k))
            item = self._poll(e, outputs, qstate, stats, deadline, effective)
            if item is None or item[0] != "probe_ack":
                continue
            _, ee, k, node, quiescent, sent, recv = item
            if ee != e or k != awaiting:
                continue  # a stale reply
            acks[node] = (quiescent, sent, recv)
            if len(acks) < len(self.nodes):
                continue
            awaiting = None
            if all(a[0] for a in acks.values()):
                s_sum = sum(a[1] for a in acks.values())
                r_sum = sum(a[2] for a in acks.values())
                if s_sum == r_sum and prev_sums == (s_sum, r_sum):
                    done = True
                else:
                    prev_sums = (s_sum, r_sum) if s_sum == r_sum else None
            else:
                prev_sums = None
        for n in self.nodes:
            self._node_qs[n].put(("stats", e))
        while len(stats) < len(self.nodes):
            self._poll(e, outputs, qstate, stats, deadline, effective)
        hist: Dict[str, Any] = {}
        peaks: Dict[str, int] = {}
        edges: Dict[Tuple[str, str], int] = {}
        fired: Dict[str, int] = {}
        worker_stats: Dict[int, Dict[str, Any]] = {}
        from repro_torch.kernels import counters
        for node, ((h, p, ed, f), info) in sorted(stats.items()):
            hist.update(h)
            peaks.update(p)
            edges.update(ed)
            fired.update(f)
            counters.add(info.pop("counts", {}))
            worker_stats[node] = info
        self.last_history, self.last_peak_regs = hist, peaks
        self.last_edge_bytes, self.last_fired = edges, fired
        self.last_worker_stats = worker_stats
        if torch.cuda.is_initialized():
            # free this process's blocks the workers have let go of
            torch.cuda.ipc_collect()
        if self._collect_single:
            return (outputs[self._collect_names[0]] if self._collect_names
                    else [])
        return outputs

    def _poll(self, e, outputs, qstate, stats, deadline, effective):
        """Handle one driver-queue item; returns it for the kinds the caller
        dispatches on itself (probe_ack), None on an empty slice."""
        try:
            item = self._driver_q.get(timeout=0.2)
        except queue.Empty:
            self._check_alive()
            if time.monotonic() > deadline:
                self._raise_timeout(e, effective)
            return None
        except Exception:
            # an item whose tensors cannot be opened: its sender died after
            # sending it, and the shared descriptor or CUDA allocation went
            # with it -- the death is the error to report
            self._check_alive(grace=2.0)
            raise
        kind = item[0]
        if kind == "q":
            _, ee, node, flag = item
            if ee == e:
                qstate[node] = flag
        elif kind == "out":
            _, ee, node, name, value, version = item
            if ee == e:
                outputs[name].append(value)
        elif kind == "stats":
            _, ee, node, snap, info = item
            if ee == e:
                stats[node] = (snap, info)
        elif kind == "error":
            self._raise_worker_error(item)
        return item

    def _raise_worker_error(self, item) -> None:
        """Raise the WorkerError of a posted error -- unless another worker
        died: a worker that cannot open a message from a dead peer reports
        the death's consequence, so the death is reported instead."""
        if any(code for _, code in self._dead(grace=0.5)):
            self._check_alive()
        self.close()  # the distributed graph state is poisoned: tear down
        _, _, node, tname, msg, tb = item
        raise WorkerError(
            f"worker for node {node} failed: {tname}: {msg}",
            node=node, remote_traceback=tb) from RemoteTraceback(tb)

    def _dead(self, grace: float = 0.0) -> List[Tuple[int, Any]]:
        """The (node, exit code) of every worker that has exited, waiting
        up to ``grace`` seconds for one to show."""
        t_end = time.monotonic() + grace
        while True:
            dead = [(n, p.exitcode) for n, p in self._procs.items()
                    if not p.is_alive()]
            if dead or time.monotonic() >= t_end:
                return dead
            time.sleep(0.05)

    def _check_alive(self, grace: float = 0.0) -> None:
        """Raise a WorkerError if a worker has exited. A worker killed or
        crashed (a nonzero exit code) is the cause; one that exited
        cleanly did so after posting its error, which is raised then."""
        dead = self._dead(grace)
        if not dead:
            return
        killed = [(n, code) for n, code in dead if code]
        if not killed:
            try:
                while True:
                    item = self._driver_q.get_nowait()
                    if item[0] == "error":
                        self._raise_worker_error(item)
            except queue.Empty:
                pass
            except WorkerError:
                raise
            except Exception:
                pass    # an item of a dead sender that cannot be opened
        n, code = (killed or dead)[0]
        self.close()
        raise WorkerError(f"worker for node {n} died (exit code {code})",
                          node=n)

    def _raise_timeout(self, e, effective) -> None:
        # best-effort fire counts, so the error names every unfired actor
        for n in self.nodes:
            self._node_qs[n].put(("stats", e))
        fired: Dict[str, int] = {}
        t_end = time.monotonic() + 3.0
        got = 0
        while got < len(self.nodes) and time.monotonic() < t_end:
            try:
                item = self._driver_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if item[0] == "stats" and item[1] == e:
                got += 1
                fired.update(item[3][3])
        unfired = [f"{name}={fired.get(name, '?')}/{eff}"
                   for name, eff in effective.items()
                   if eff is not None and fired.get(name, -1) != eff]
        raise TimeoutError(
            "process actor runtime did not complete: " + ", ".join(unfired))

    # -- teardown ----------------------------------------------------------------
    def close(self) -> None:
        """Stop every worker: ask, then terminate, then kill what is left;
        no process outlives this call. Idempotent."""
        if self._closed:
            return
        self._closed = True
        for q_ in self._node_qs.values():
            try:
                q_.put(("stop",))
            except Exception:
                pass
        for p in self._procs.values():
            p.join(timeout=2.0)
        for p in self._procs.values():
            if p.is_alive():
                p.terminate()
        for p in self._procs.values():
            p.join(timeout=1.0)
        # SIGKILL stragglers: a worker wedged in native code (or mid-error)
        # can survive terminate(), and a failed runtime must leak nothing
        for p in self._procs.values():
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        # the queues may hold data for readers that are gone: never let the
        # interpreter's exit wait to flush it
        for q_ in [*self._node_qs.values(), self._driver_q]:
            q_.cancel_join_thread()
            q_.close()

    def __del__(self):  # best-effort; daemon workers die with the parent
        try:
            self.close()
        except Exception:
            pass
