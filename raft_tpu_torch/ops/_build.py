"""Build and load the port's CUDA kernels.

Each ``raft_tpu_torch/ops/csrc/<name>.cu`` is compiled by ``nvcc`` into a
shared library with a plain C interface under ``build/kernels/`` at the
repository root, at first use, and loaded with ``ctypes``. The library's
file name carries a hash of its source and flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing here runs when the
package is imported: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

from raft_tpu_torch.core.error import DeviceError

_OPS = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_OPS, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_OPS)), "build",
                         "kernels")
# -Xptxas=-v: each kernel's registers, shared memory and spills, kept in
# BUILD_LOG for the smoke run to print
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_load_lock = threading.Lock()
# seconds spent compiling, per library, in this process (0 when loaded
# from an earlier build)
BUILD_SECONDS: Dict[str, float] = {}
# the compiler's report of each library built in this process
BUILD_LOG: Dict[str, str] = {}
# nvcc runs and library loads in this process: a server checks that
# neither moves once it has warmed up (no request pays a build or a load)
BUILDS = 0
LOADS = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise DeviceError("nvcc not found: the port's CUDA kernels are "
                          "built from source on the machine with the card")
    return path


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _record_cache(name: str, hit: bool, seconds: float = 0.0) -> None:
    """The library cache's hit or miss into the metrics registry, and a
    build's wall time into the flight ring."""
    from raft_tpu_torch.observability.hooks import record_cache
    from raft_tpu_torch.observability.timeline import emit_compile

    record_cache(hit)
    if seconds:
        emit_compile(name, seconds, hit=False)


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists (a
    cache hit); a miss passes the ``aot_compile`` fault site first."""
    global BUILDS
    out = library_path(name)
    if os.path.exists(out):
        BUILD_SECONDS.setdefault(name, 0.0)
        _record_cache(name, True)
        return out
    from raft_tpu_torch.resilience.faults import fault_point

    fault_point("aot_compile")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise DeviceError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)          # atomic: a reader never sees half a file
    with _lock:
        BUILDS += 1
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOG[name] = proc.stderr
    _record_cache(name, False, BUILD_SECONDS[name])
    return out


def build_all(names: Iterable[str]) -> None:
    """Compile several sources at once (one ``nvcc`` each, in parallel)."""
    names = list(names)
    threads = [threading.Thread(target=build, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for n in names:               # re-raise a failed build in this thread
        build(n)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use); a
    library already loaded counts as a cache hit."""
    global LOADS
    with _load_lock:
        lib = _libs.get(name)
        if lib is not None:
            _record_cache(name, True)
        else:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
            LOADS += 1
        return lib
