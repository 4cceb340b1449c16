"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``src/repro_torch/csrc/<name>.cu`` exposes a plain C interface (no
PyTorch headers), so ``nvcc`` builds it in seconds. The shared library goes
to ``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and the compiler flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them together; the ``-Xptxas -v`` report (registers, shared memory, spills
per kernel) is kept beside each library as ``<name>.log``.

Nothing here runs at import: the CPU tests import every module of the
package on a machine with neither a card nor ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: seconds each source took to build in this process (0.0: found built)
build_seconds: Dict[str, float] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card (set CUDA_HOME)")
    return found


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:16]}.so"


def build(sources: Sequence[str]) -> Dict[str, Path]:
    """Compile every source that is not built yet, all in parallel; raise
    with the compiler's output if any fails. Returns ``{source: .so}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for source in sources:
        out = library_path(source)
        if out.exists():
            build_seconds.setdefault(source, 0.0)
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        jobs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out, time.perf_counter())
    failed = []
    for source, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        build_seconds[source] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{source}:\n{log}")
            continue
        os.replace(tmp, out)          # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {s: library_path(s) for s in sources}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build([source])[source]))
            _libs[source] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def refuse_grad(what: str, use: str, *tensors) -> None:
    """Raise when autograd is recording and an input requires grad: a raw
    wrapper writes its output through ctypes, so that output would have no
    autograd link to its inputs and the graph would be cut silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad and the raw kernel wrapper would "
            f"cut the autograd graph; {use}")
