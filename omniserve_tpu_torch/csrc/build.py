"""Build the port's native libraries on first use and bind them with ctypes.

Each ``*.cu`` source in this directory is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface (no
PyTorch headers, so a build takes seconds); ``host_prep.cc``, the host-side
batch preparation, is compiled by the host ``g++``. Libraries land in
``_build/`` next to the sources (listed in ``.gitignore``), keyed by a hash
of the source, the shared ``*.cuh`` headers and the flags, so an edited
source rebuilds. ``build_all()`` starts one compiler per source at once and
waits for all of them. Each process compiles to a temporary file of its
own and ``os.replace``s it into place, so concurrent processes (the test
workers) never load a half-written library. A failed build raises with
the compiler's output.

Nothing here runs at import time: the CPU tests import every module, and
this machine has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")

# source -> extra compiler flags. The decode, append and GEMM files must
# reproduce the plain versions' f32 op order exactly (quant codes,
# epilogues), so they forbid FMA contraction.
SOURCES: Dict[str, List[str]] = {
    "quant_gemm.cu": ["--fmad=false"],
    "decode_attention.cu": ["--fmad=false"],
    "kv_append.cu": ["--fmad=false"],
    "flash_prefill.cu": [],
    "paged_prefill.cu": [],
    "prefill_single_pass.cu": [],
    "embed_gather.cu": [],
    "host_prep.cc": [],
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels build on a machine with "
        "the CUDA toolkit (PATH or /usr/local/cuda/bin)"
    )


def _command(src: str) -> List[str]:
    """The compiler and its flags for ``src``, output path to follow."""
    if src.endswith(".cu"):
        return [_nvcc(), *NVCC_FLAGS, *SOURCES[src]]
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {src} builds with the host g++")
    return [gxx, *GXX_FLAGS, *SOURCES[src]]


def _target(src: str) -> str:
    flags = (NVCC_FLAGS if src.endswith(".cu") else GXX_FLAGS) + SOURCES[src]
    h = hashlib.sha256()
    headers = sorted(n for n in os.listdir(_DIR)
                     if n.endswith(".cuh")) if src.endswith(".cu") else []
    for name in [src, *headers]:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build_all(sources: Optional[List[str]] = None) -> float:
    """Compile every stale source in parallel; returns the wall seconds.

    Raises with the compiler's output if any build fails."""
    sources = list(SOURCES) if sources is None else sources
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.time()
    procs = {}
    for src in sources:
        out = _target(src)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [*_command(src), os.path.join(_DIR, src), "-o", tmp]
        procs[src] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ), tmp, out)
    failed = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[src] = log
        if proc.returncode != 0:
            failed.append(f"--- {src} ({os.path.basename(proc.args[0])} "
                          f"exit {proc.returncode})\n{log}")
            if os.path.exists(tmp):
                os.unlink(tmp)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))
    return time.time() - t0


def lib(src: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    handle = _libs.get(src)
    if handle is None:
        out = _target(src)
        if not os.path.exists(out):
            build_all([src])
        handle = ctypes.CDLL(out)
        _libs[src] = handle
    return handle
