"""Build the port's native code at first use and load it with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, ``_build/lib<name>-<digest>.so``.  The digest
covers the sources and the flags, so an edited kernel builds anew and an
unchanged one is loaded from disk.  Sources build in parallel: one
``nvcc`` per file, all started together.  No source includes PyTorch's
headers, which keeps a build to seconds.

Host code (``csrc/<name>.cc``: the CRC-32C of the checkpoints) builds the
same way with ``g++`` through :func:`load_host`, on any machine with a C++
compiler.

Only the launching code calls :func:`load` or :func:`load_host`;
importing this module needs neither a compiler nor a GPU.
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

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 900
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_HOST_LOCK = threading.Lock()


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed (set CUDA_HOME)")


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def build_all() -> float:
    """Compile every kernel source not yet built; returns the seconds it
    took.  Raises with the compiler's output if any build fails."""
    t0 = time.monotonic()
    todo = [(s, _target(s)) for s in sources() if not _target(s).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for src, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs.append((proc, src, tmp, out))
        failures = []
        for proc, src, tmp, out in procs:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failures.append(f"nvcc {src.name} exited {proc.returncode}:"
                                f"\n{log}")
            else:
                os.replace(tmp, out)
        if failures:
            raise RuntimeError("\n".join(failures))
    finally:
        for proc, *_ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return time.monotonic() - t0


def build_log(name: str) -> str:
    """The compiler's output (ptxas registers, spills, shared memory) from
    the build of ``csrc/<name>.cu``; empty when it was loaded from disk."""
    log = _target(SRC_DIR / f"{name}.cu").with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, built first if
    needed."""
    if name not in _LIBS:
        build_all()
        _LIBS[name] = ctypes.CDLL(str(_target(SRC_DIR / f"{name}.cu")))
    return _LIBS[name]


def _host_target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cc`` with ``g++``,
    built first if needed.  A failed build raises with the compiler's
    output: there is no fallback."""
    with _HOST_LOCK:
        key = f"{name}.cc"
        if key not in _LIBS:
            src = SRC_DIR / key
            out = _host_target(src)
            if not out.exists():
                gxx = shutil.which(os.environ.get("CXX", "g++"))
                if gxx is None:
                    raise RuntimeError(f"no C++ compiler to build {src.name}"
                                       f" (set CXX)")
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                proc = subprocess.run(
                    [gxx, *GXX_FLAGS, "-o", str(tmp), str(src)],
                    capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"g++ {src.name} exited "
                                       f"{proc.returncode}:\n{proc.stdout}"
                                       f"{proc.stderr}")
                os.replace(tmp, out)    # atomic: concurrent builds agree
            _LIBS[key] = ctypes.CDLL(str(out))
        return _LIBS[key]
