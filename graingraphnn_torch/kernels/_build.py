"""Build and bind the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc for Hopper (sm_90a) into a
shared library with a plain C interface, `_build/lib<name>-<hash>.so`, and
loaded with ctypes. The hash covers the sources and the flags, so an edited
kernel is rebuilt at its first use and an unchanged one is loaded as is.
Every C entry returns cudaGetLastError() after its launches; the bound
function raises on anything but cudaSuccess. Processes that build at the
same time (the ranks of a partitioned run) take turns on a file lock in
`_build/`, so each library is compiled once.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

build_log: Dict[str, Dict] = {}   # "source flags" -> {"seconds", "ptxas"}
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], object] = {}


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _target(source: str, flags: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    for path in [os.path.join(CSRC, source + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{source}-{h.hexdigest()[:16]}.so")


@contextlib.contextmanager
def _locked():
    """Hold the build directory's lock (one builder at a time)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(specs: Iterable[Tuple[str, Sequence[str]]]) -> Dict[str, Dict]:
    """Compile every (source, extra flags) whose library is missing, one
    nvcc process per source, all started together. Returns build_log."""
    with _locked():
        return _build(specs)


def _build(specs):
    compiler = None
    procs = []
    for source, flags in specs:
        out = _target(source, flags)
        if os.path.exists(out):
            continue
        compiler = compiler or nvcc()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [compiler, *NVCC_FLAGS, *flags, "-o", tmp,
               os.path.join(CSRC, source + ".cu")]
        procs.append((source, flags, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for source, flags, out, tmp, t0, proc in procs:
        text, _ = proc.communicate()
        build_log[" ".join((source, *flags))] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": [ln.strip() for ln in text.splitlines()
                      if ("ptxas" in ln and ("registers" in ln
                                             or "Compiling" in ln
                                             or "warning" in ln))
                      or "spill stores" in ln],
        }
        if proc.returncode != 0:
            failed.append(f"{source}.cu:\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return build_log


def library(source: str, flags: Sequence[str] = ()) -> ctypes.CDLL:
    key = source + " " + " ".join(flags)
    if key not in _libs:
        build([(source, flags)])
        _libs[key] = ctypes.CDLL(_target(source, flags))
    return _libs[key]


def function(source: str, symbol: str, argtypes, flags: Sequence[str] = ()):
    """The C entry `symbol` of csrc/<source>.cu as a Python callable that
    raises RuntimeError when the entry reports a CUDA error."""
    key = (source + " " + " ".join(flags), symbol)
    if key not in _fns:
        lib = library(source, flags)
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        err_string = lib.ggnn_error_string
        err_string.argtypes = [ctypes.c_int]
        err_string.restype = ctypes.c_char_p

        def call(*args):
            err = fn(*args)
            if err != 0:
                raise RuntimeError(
                    f"{symbol}: {err_string(err).decode()} (cudaError {err})")

        _fns[key] = call
    return _fns[key]
