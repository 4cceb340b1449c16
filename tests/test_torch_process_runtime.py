"""The port's process-backed actor runtime: one OS worker per node id, real
transport (the port of ``tests/test_process_runtime.py`` and of the wire
format cases of ``tests/test_mixed_precision_zero.py::TestBf16WireFormat``).

The spec builders live in ``torch_process_helpers`` (module-level classes,
so they pickle under the ``spawn`` start method). This file and that module
import no jax, so the workers do not either, and a test asks a worker
whether it did. On the CPU tensors cross by shared memory; on a card by
CUDA IPC (``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""
import pickle
from multiprocessing.reduction import ForkingPickler

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.graph import LogicalGraph
from repro_torch.core.lowering import OptimizerSpec
from repro_torch.core.placement import Placement
from repro_torch.optim.zero import ZeroState
from repro_torch.runtime.base import (RemoteTraceback, WorkerError,
                                      encode_payload, make_runtime)
from repro_torch.runtime.chaos import KILL_EXIT_CODE, FaultPlan, KillWorker
from repro_torch.runtime.pipeline import (InferSpecBuilder,
                                          ServePipelineExecutor)
from repro_torch.runtime.process import ProcessRuntime
from torch_process_helpers import (ChainBuilder, CrashBuilder, EchoBuilder,
                                   StuckBuilder)


class TestProcessRuntime:
    def test_cross_node_chain_reuse_fires_and_edges(self):
        """One persistent runtime over 3 worker processes: correct results,
        epoch reuse, per-epoch ctx and fires, per-edge bytes, and the
        private ``__`` payload keys stripped (checked inside the workers'
        actor bodies)."""
        with make_runtime("processes", ChainBuilder(n=4)) as rt:
            assert isinstance(rt, ProcessRuntime)
            outs = rt.run(timeout=60.0)
            expect = [(v + 1.0) * 2.0 for v in range(4)]
            assert [float(o[0]) for o in outs] == expect
            assert all(o.shape == (8,) for o in outs)
            assert rt.last_fired == {"src": 4, "mid": 4, "sink": 4}
            # the two cross-node hops each carried 4 fires x 8 float32
            for edge in (("src", "mid"), ("mid", "sink")):
                assert rt.last_edge_bytes[edge] == 4 * 8 * 4
            # epoch reuse: the same workers, a new base via ctx, fewer fires
            pids = {n: w["pid"] for n, w in rt.workers.items()}
            outs = rt.run(ctx={"src": 100.0}, fires={"src": 2}, timeout=60.0)
            assert [float(o[0]) for o in outs] == [202.0, 204.0]
            assert rt.last_fired["src"] == 2
            assert {n: w["pid"] for n, w in rt.last_worker_stats.items()} \
                == pids
            with pytest.raises(ValueError, match="unknown actor"):
                rt.run(ctx={"nope": 1}, fires={"src": 1})

    def test_worker_crash_propagates_with_remote_traceback(self):
        """An exception inside a worker surfaces on the driver as a
        WorkerError naming the node, with the worker's traceback chained so
        the failing frame shows."""
        with ProcessRuntime(CrashBuilder()) as rt:
            with pytest.raises(WorkerError, match="worker for node 1") as ei:
                rt.run(timeout=60.0)
        assert ei.value.node == 1
        assert "kaboom on version 2" in (ei.value.remote_traceback or "")
        assert isinstance(ei.value.__cause__, RemoteTraceback)

    def test_timeout_names_unfired_actors(self):
        """A wedged epoch times out naming the unfinished bounded actors
        with fired/max counts."""
        with ProcessRuntime(StuckBuilder()) as rt:
            with pytest.raises(TimeoutError, match=r"src=\d/3"):
                rt.run(timeout=3.0)


class TestProcessRuntimeClose:
    """close() is idempotent and never leaks a worker process: not after
    clean runs, not after a worker crash, not after a hard kill (a dead
    session must be fully reclaimed before its resume spawns workers)."""

    def test_close_is_idempotent(self):
        rt = ProcessRuntime(ChainBuilder(n=2))
        rt.run(timeout=60.0)
        procs = list(rt._procs.values())
        rt.close()
        rt.close()    # a second close: a no-op, no error
        assert all(not p.is_alive() for p in procs)
        with pytest.raises(RuntimeError, match="closed"):
            rt.run(timeout=5.0)

    def test_no_leak_after_worker_crash(self):
        rt = ProcessRuntime(CrashBuilder())
        procs = list(rt._procs.values())
        with pytest.raises(WorkerError):
            rt.run(timeout=60.0)
        # the raise path already closed the runtime; nothing may survive
        assert all(not p.is_alive() for p in procs)
        rt.close()    # and closing a failed runtime stays safe

    def test_no_leak_after_fault_injected_kill(self):
        """KillWorker under processes is a real ``os._exit`` of the
        worker: the driver sees the exit code, not an exception."""
        rt = ProcessRuntime(ChainBuilder(n=4),
                            faults=FaultPlan([KillWorker("mid", fire=2)]))
        procs = list(rt._procs.values())
        with pytest.raises(WorkerError,
                           match=f"node 1 died .exit code {KILL_EXIT_CODE}"
                           ) as ei:
            rt.run(timeout=60.0)
        assert ei.value.node == 1
        assert rt._procs[1].exitcode == KILL_EXIT_CODE == 57
        assert all(not p.is_alive() for p in procs)
        rt.close()


class TestProcessRuntimeGuards:
    def test_unpicklable_builder_rejected_up_front(self):
        """A closure builder fails on the driver with an actionable
        message, before any worker starts."""
        with pytest.raises(ValueError, match="picklable spec builder"):
            ProcessRuntime(lambda: ([], None))

    def test_spec_builder_without_recipe_refuses_to_pickle(self):
        """A builder made from a lowered program alone (no recipe) cannot
        be shipped to workers, and pickling says why."""
        b = InferSpecBuilder(object(), ["x"], 2)
        with pytest.raises(ValueError, match="lowering recipe"):
            pickle.dumps(b)

    def test_executor_without_recipe_refused(self):
        with pytest.raises(ValueError, match="recipe"):
            ServePipelineExecutor(None, runtime="processes")

    def test_lambda_lr_refused_at_compile(self):
        """An lr schedule given as a lambda cannot reach the workers: the
        compile refuses it, and no worker is spawned."""
        g = LogicalGraph(Placement(("d",), (1,), device_kind="cpu"))
        x, labels = g.input("x", (4, 4)), g.input("labels", (4,),
                                                  dtype="int32")
        w = g.input("w0", (4, 4))
        g.softmax_xent(g.matmul(x, w, name="mm0"), labels, name="loss")
        params = {"w0": np.zeros((4, 4), np.float32)}
        with pytest.raises(ValueError, match="picklable lowering recipe"):
            api.compile(g, mode="train", params=params, stages=1,
                        runtime="processes", device="cpu",
                        optimizer=OptimizerSpec.adamw(lr=lambda s: 1e-3))


def _bf16(seed, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


class TestWireFormat:
    """bf16 tensors, bf16 inside a ``ZeroState`` and the stripped private
    keys survive the wire format bitwise: ``encode_payload``, then the
    queues' pickler (tensors as tensors: no numpy on the wire), then a
    worker."""

    def _roundtrip(self, payload):
        return ForkingPickler.loads(
            ForkingPickler.dumps(encode_payload(payload)))

    def test_bf16_tensor_roundtrips_bitwise(self):
        x = _bf16(0, (7, 3))
        out = self._roundtrip({"x": x})["x"]
        assert out.dtype == torch.bfloat16
        assert torch.equal(_bits(out), _bits(x))

    def test_bf16_inside_zero_state_namedtuple(self):
        st = ZeroState(torch.tensor(3, dtype=torch.int32),
                       {"w": _bf16(1, (2, 1, 5))},
                       {"w": _bf16(2, (2, 1, 5)).float()})
        out = self._roundtrip({"state": st})["state"]
        assert isinstance(out, ZeroState)
        assert out.mu["w"].dtype == torch.bfloat16
        assert torch.equal(_bits(out.mu["w"]), _bits(st.mu["w"]))
        assert torch.equal(out.nu["w"], st.nu["w"])
        assert int(out.step) == 3

    def test_private_keys_still_stripped(self):
        out = self._roundtrip({"__tape__": object, "loss": 1.0})
        assert "__tape__" not in out and out["loss"] == 1.0

    def test_through_two_workers_bitwise_and_no_jax_there(self):
        """The payload rides driver -> node 0 -> node 1 -> driver: bf16
        and the ZeroState bitwise, the private key stripped at the node
        boundary; and neither worker imported jax or the JAX package."""
        x = _bf16(3, (5, 4))
        st = ZeroState(torch.tensor(2, dtype=torch.int32),
                       {"w": _bf16(4, (1, 1, 6))},
                       {"w": torch.arange(6.0).reshape(1, 1, 6)})
        with ProcessRuntime(EchoBuilder()) as rt:
            (out,) = rt.run(ctx={"src": {"x": x, "state": st,
                                         "__vjp__": "local"}}, timeout=60.0)
            pids = {w["pid"] for w in rt.workers.values()}
        got = out["echo"]
        assert "__vjp__" not in got
        assert got["x"].dtype == torch.bfloat16
        assert torch.equal(_bits(got["x"]), _bits(x))
        assert isinstance(got["state"], ZeroState)
        assert torch.equal(_bits(got["state"].mu["w"]), _bits(st.mu["w"]))
        assert torch.equal(got["state"].nu["w"], st.nu["w"])
        assert out["pid"] in pids and len(pids) == 2
        assert out["jax"] is False
