"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` source with a plain C interface is compiled by its own
``nvcc`` into a shared library for ``sm_90a`` and loaded with ``ctypes``.
Builds happen at first use, never at import (the CPU test box has no
``nvcc``), into ``horovod_tpu_torch/_build/``, which git ignores.  A
library's file name carries a hash of its sources and flags, so an edited
source is rebuilt and an unchanged one is reused within a checkout.
:func:`build_all` starts every missing build at once and waits for all of
them: the builds run in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "build_all", "build_dir", "built", "library",
           "ptxas_report", "sass_counts"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"

# kernel library -> its source; every library also includes the shared header
SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd_dkdv": "flash_bwd_dkdv.cu",
    "flash_bwd_dq": "flash_bwd_dq.cu",
    "flash_fwd_tc": "flash_fwd_tc.cu",
    "flash_bwd_dkdv_tc": "flash_bwd_dkdv_tc.cu",
    "flash_bwd_dq_tc": "flash_bwd_dq_tc.cu",
    "flash_fwd_f32tc": "flash_fwd_f32tc.cu",
    "flash_bwd_dkdv_f32tc": "flash_bwd_dkdv_f32tc.cu",
    "flash_bwd_dq_f32tc": "flash_bwd_dq_f32tc.cu",
}
_HEADERS = ("flash_common.cuh", "hopper_tc.cuh")
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: see the extern "C" functions in csrc/*.cu
_SIGNATURES = {
    "flash_fwd": ("hvd_flash_fwd",
                  [_P] * 5 + [_I] * 7 + [_F, _I, _P]),
    "flash_bwd_dkdv": ("hvd_flash_bwd_dkdv",
                       [_P] * 8 + [_I] * 7 + [_F, _I, _P]),
    "flash_bwd_dq": ("hvd_flash_bwd_dq",
                     [_P] * 7 + [_I] * 7 + [_F, _I, _P]),
    "flash_fwd_tc": ("hvd_flash_fwd_tc",
                     [_P] * 5 + [_I] * 7 + [_F, _I, _P]),
    # + the (lse, delta) scratch of the pre-pass
    "flash_bwd_dkdv_tc": ("hvd_flash_bwd_dkdv_tc",
                          [_P] * 9 + [_I] * 7 + [_F, _I, _P]),
    # the filled (lse, delta) scratch in place of o and lse
    "flash_bwd_dq_tc": ("hvd_flash_bwd_dq_tc",
                        [_P] * 6 + [_I] * 7 + [_F, _I, _P]),
    "flash_fwd_f32tc": ("hvd_flash_fwd_f32tc",
                        [_P] * 5 + [_I] * 7 + [_F, _I, _P]),
    "flash_bwd_dkdv_f32tc": ("hvd_flash_bwd_dkdv_f32tc",
                             [_P] * 8 + [_I] * 7 + [_F, _I, _P]),
    "flash_bwd_dq_f32tc": ("hvd_flash_bwd_dq_f32tc",
                           [_P] * 7 + [_I] * 7 + [_F, _I, _P]),
}

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        "/usr/local/cuda/bin/nvcc"
    ]:
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels of "
            "horovod_tpu_torch are built from csrc/ at first use"
        )
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(_FLAGS).encode())
    for fn in (SOURCES[name],) + _HEADERS:
        h.update((_CSRC / fn).read_bytes())
    return _BUILD / f"{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str, out: Path) -> subprocess.Popen:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
           str(_CSRC / SOURCES[name])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _load(name: str, path: Path) -> None:
    lib = ctypes.CDLL(str(path))
    sym, argtypes = _SIGNATURES[name]
    fn = getattr(lib, sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _loaded[name] = fn


def build_all() -> None:
    """Build (in parallel) and load every kernel library not yet loaded.
    Raises with the compiler's output if a build fails."""
    with _lock:
        todo = [n for n in SOURCES if n not in _loaded]
        if not todo:
            return
        _BUILD.mkdir(parents=True, exist_ok=True)
        paths = {n: _lib_path(n) for n in todo}
        procs = {n: _start_build(n, p) for n, p in paths.items()
                 if not p.exists()}
        failed = []
        for n, proc in procs.items():
            log, _ = proc.communicate()
            paths[n].with_suffix(".ptxas.txt").write_text(log)
            tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
            if proc.returncode != 0:
                failed.append(f"--- {n} (exit {proc.returncode})\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                # atomic: concurrent processes may build the same library
                os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for n in todo:
            _load(n, paths[n])


def build_dir() -> Path:
    """Where the kernel libraries are built (git-ignored)."""
    return _BUILD


def built() -> dict:
    """Kernel library -> whether this checkout holds its build from the
    current sources and flags (a process that finds them all loads them
    and compiles nothing)."""
    return {n: _lib_path(n).exists() for n in SOURCES}


def library(name: str):
    """The loaded C entry point of kernel library ``name`` (built on first
    use)."""
    fn = _loaded.get(name)
    if fn is None:
        build_all()
        fn = _loaded[name]
    return fn


def ptxas_report(name: str) -> str:
    """The compiler's register / shared-memory / spill lines, and its
    notes on serialized wgmma ("Potential Performance Loss"), of the build
    of ``name`` from the current sources (kept beside the library, under
    the same hash), or '' if it has not been built."""
    p = _lib_path(name).with_suffix(".ptxas.txt")
    if not p.exists():
        return ""
    return "\n".join(
        ln for ln in p.read_text().splitlines()
        if "registers" in ln or "spill" in ln or "Performance Loss" in ln
    )


def sass_counts(name: str, opcodes=("HGMMA", "UTMALDG")) -> dict:
    """How many instructions of each opcode the built library of ``name``
    holds (``cuobjdump --dump-sass``): the proof that a tensor-core kernel
    compiled to wgmma (HGMMA) and TMA loads (UTMALDG)."""
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    out = subprocess.run(
        [str(cuobjdump), "--dump-sass", str(_lib_path(name))],
        capture_output=True, text=True, check=True, timeout=120,
    ).stdout
    lines = out.splitlines()
    return {op: sum(op in ln for ln in lines) for op in opcodes}
