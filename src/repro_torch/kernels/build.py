"""Build the hand-written CUDA kernels and load them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc -c`` (all started
together) for ``sm_90a`` and linked into one shared library with a plain C
interface. The build lands in ``build/kernels-<hash>/`` at the repository
root, keyed by a hash of the sources and flags, at first use; a later
process with the same sources loads the library without compiling.
Processes that start together (the ranks of one job) take a file lock
beside the build directory first: one compiles, the others wait for it
and load its library.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libmoska_kernels.so"

_p = ctypes.c_void_p
_i = ctypes.c_int
# C entry points: name -> argument types (every pointer and the stream as
# c_void_p, so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "moska_shared_chunk_attn": [_p, _p, _p, _p, _p, _p,
                                _i, _i, _i, _i, _i, _i, _i, _p],
    "moska_shared_chunk_attn_q8": [_p, _p, _p, _p, _p, _p, _p, _p,
                                   _i, _i, _i, _i, _i, _i, _i, _p],
    "moska_shared_tail_attn": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p],
    "moska_decode_attn": [_p, _p, _p, _p, _p, _p,
                          _i, _i, _i, _i, _i, _i, _i, _p],
    "moska_paged_decode_attn": [_p, _p, _p, _p, _p, _p, _p,
                                _i, _i, _i, _i, _i, _i, _i, _i, _p],
    "moska_lse_merge": [_p, _p, _p, _p, _i, ctypes.c_long, _i, _i, _p],
    "moska_lse_merge_pair": [_p, _p, _p, _p, _p, _p, ctypes.c_long, _i, _i,
                             _p],
    "moska_lse_merge_routed": [_p, _p, _p, _p, _p, ctypes.c_long,
                               _i, _i, _i, _i, _i, _p],
    "moska_router_scores": [_p, _p, _p, _i, _i, _i, _i, _i, _i, _p],
    "moska_flash_prefill_attn": [_p, _p, _p, _p, _p, *[_i] * 13, _p],
}


@dataclass
class BuildInfo:
    path: Path
    seconds: float                 # wall time of this process's build (0 if cached)
    cached: bool
    logs: Dict[str, str] = field(default_factory=dict)  # source -> nvcc output

    def ptxas_lines(self):
        """(source, line) for each ptxas line naming a kernel, its
        registers, shared memory or spills."""
        keys = ("Compiling entry", "Used", "spill")
        return [(src, ln.strip()) for src, log in sorted(self.logs.items())
                for ln in log.splitlines() if any(k in ln for k in keys)]


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_key() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CC_FLAGS).encode())
    cus, hdrs = _sources()
    for path in cus + hdrs:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


@contextlib.contextmanager
def _locked(path: Path):
    """An exclusive ``flock`` on ``path`` for the duration of the block."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> BuildInfo:
    """Compile the library unless a build of the same sources exists."""
    key = source_key()
    with _locked(BUILD_ROOT / f"kernels-{key}.lock"):
        return _build(BUILD_ROOT / f"kernels-{key}")


def _build(out_dir: Path) -> BuildInfo:
    lib = out_dir / LIB_NAME
    cus, _ = _sources()
    if lib.exists():
        logs = {p.stem + ".cu": p.read_text()
                for p in out_dir.glob("*.log")}
        return BuildInfo(lib, 0.0, True, logs)
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [(src, subprocess.Popen(
        [nvcc, *ARCH_FLAGS, *CC_FLAGS, "-c", str(src),
         "-o", str(out_dir / f"{src.stem}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in cus]
    logs, failed = {}, []
    for src, proc in procs:
        logs[src.name] = proc.communicate()[0]
        (out_dir / f"{src.stem}.log").write_text(logs[src.name])
        if proc.returncode:
            failed.append(src.name)
    if failed:
        detail = "\n".join(logs[n] for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    tmp = out_dir / (LIB_NAME + ".tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *(str(out_dir / f"{src.stem}.o") for src in cus)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return BuildInfo(lib, time.perf_counter() - t0, False, logs)


_LIB: Optional[ctypes.CDLL] = None
_INFO: Optional[BuildInfo] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB, _INFO
    if _LIB is None:
        info = build()
        lib = ctypes.CDLL(str(info.path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB, _INFO = lib, info
    return _LIB


def build_info() -> BuildInfo:
    library()
    return _INFO
