"""The actor runtime (paper §4-5) on OS threads or worker processes, and
its pipeline executors."""
from repro_torch.runtime.actor import Actor, ActorSpec, build_actors
from repro_torch.runtime.base import (RUNTIME_KINDS, Runtime, SpecBuilder,
                                      WorkerError, encode_payload,
                                      make_runtime)
from repro_torch.runtime.messages import Ack, Req, make_actor_id, parse_actor_id
from repro_torch.runtime.process import ProcessRuntime
from repro_torch.runtime.threaded import ThreadedRuntime
