"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, ``_build/lib<name>-<digest>.so``.  The digest
covers the sources and the flags, so an edited kernel builds anew and an
unchanged one is loaded from disk.  Sources build in parallel: one
``nvcc`` per file, all started together.  No source includes PyTorch's
headers, which keeps a build to seconds.

Only the launching code calls :func:`load`; importing this module needs
neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 900

_LIBS: dict[str, ctypes.CDLL] = {}


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
