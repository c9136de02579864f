"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain C
interface, ``_build/lib<name>-<digest>.so``, where the digest covers the
source and the flags, so an edited source builds anew; the compiler's
output is kept beside it, ``lib<name>-<digest>.log``. The build happens
at first use; ``build()`` compiles several sources at once, one nvcc
process each. Nothing here touches CUDA at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

# No --use_fast_math: the decode divides by S and must reproduce the IEEE
# quotient. -Xptxas=-v reports registers, shared memory and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return nvcc


def source_path(name: str) -> str:
    """``csrc/<name>.cu``; a name that ends in ``.cu`` is a source's path."""
    if name.endswith(".cu"):
        return name
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name: str) -> str:
    src = source_path(name)
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.basename(src)[:-3]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def _log_path(name: str) -> str:
    return library_path(name)[:-3] + ".log"


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile the named sources (default: all of ``csrc/``) that are not
    built yet.

    All nvcc processes start together and run in parallel. Each build's
    compiler output (``-Xptxas -v``: registers, spills, ptxas's warnings)
    is kept beside its library. Returns ``{name: compiler output}`` for
    every name, from the build that made its library, whether that was
    this call or an earlier one; raises ``RuntimeError`` with the compiler
    output if any build fails.
    """
    names = sources() if names is None else names
    todo = [n for n in names if not (os.path.exists(library_path(n))
                                     and os.path.exists(_log_path(n)))]
    if todo:
        _compile(todo)
    logs = {}
    for name in names:
        with open(_log_path(name)) as f:
            logs[name] = f.read()
    return logs


def _compile(names: list[str]) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for name in names:
        # build under a temporary name, then rename: a concurrent process
        # never loads a half-written library or reads a half-written log
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = f"{out}[{name}: {time.perf_counter() - t0:.1f} s]\n"
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
            with open(tmp[:-3] + ".log", "w") as f:
                f.write(logs[name])
            os.replace(tmp[:-3] + ".log", _log_path(name))
        else:
            os.unlink(tmp)
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "".join(logs[n] for n in failed))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, built on first use.

    The caller sets ``argtypes`` and ``restype`` of the functions it calls.
    """
    build([name])
    return ctypes.CDLL(library_path(name))
