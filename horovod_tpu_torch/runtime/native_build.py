"""Builds the native eager engine's library from the port's own C++ sources
(``csrc/engine/``) at first use.

The reference builds its C++ engine with a Makefile into the JAX package;
the port keeps its own copy of those sources and compiles them here, with
the Makefile's compiler and flags, into a directory of the
git-ignored ``_build/`` named by a hash of the compiler, the flags and
every source's bytes.  A changed source or flag therefore builds anew
beside the old library, and :func:`built` answers for the current
sources only.

One build at a time across processes: an ``fcntl.flock`` on the
directory's ``lock`` file, so test workers and ranks started together
compile once and the rest load what the first linked.  The objects are
compiled in parallel (one compiler process per source) into a temporary
directory, and the library reaches its final name by ``os.replace``, so
no process ever loads a half-written file.  A failed compile raises
:class:`NativeBuildError` with the compiler's messages.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List

PACKAGE = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE / "csrc" / "engine"
BUILD_ROOT = PACKAGE / "_build" / "native"
LIB_NAME = "libhvdtpu_torch.so"
# the reference Makefile's flags (CXXFLAGS, LDFLAGS)
CXXFLAGS = ("-std=c++17", "-O2", "-fPIC", "-Wall", "-Wextra", "-pthread")
LDFLAGS = ("-shared", "-pthread")


class NativeBuildError(RuntimeError):
    """The native engine's library did not compile or link; the message
    holds the compiler's output."""


def compiler() -> str:
    """``$CXX``, as make reads it, else ``g++``."""
    return os.environ.get("CXX") or "g++"


def sources(source_dir: Path = SOURCE_DIR) -> List[Path]:
    """The translation units, in a fixed order."""
    return sorted(source_dir.glob("*.cc"))


def build_dir(source_dir: Path = SOURCE_DIR,
              build_root: Path = BUILD_ROOT) -> Path:
    """Where the library of these sources, this compiler and these flags
    lives: ``build_root/<hash>``."""
    h = hashlib.sha256()
    for part in (compiler(), *CXXFLAGS, "|", *LDFLAGS):
        h.update(part.encode() + b"\0")
    for path in sorted(source_dir.glob("*.cc")) + \
            sorted(source_dir.glob("*.h")):
        h.update(path.name.encode() + b"\0")
        h.update(path.read_bytes())
    return build_root / h.hexdigest()[:16]


def library_path(source_dir: Path = SOURCE_DIR,
                 build_root: Path = BUILD_ROOT) -> Path:
    return build_dir(source_dir, build_root) / LIB_NAME


def built(source_dir: Path = SOURCE_DIR,
          build_root: Path = BUILD_ROOT) -> bool:
    """Whether the library of the current sources is built."""
    return library_path(source_dir, build_root).exists()


def build(source_dir: Path = SOURCE_DIR,
          build_root: Path = BUILD_ROOT) -> Path:
    """The library of the current sources, compiled first if it is not
    there.  Raises :class:`NativeBuildError` on a failed compile or link,
    and ``OSError`` when no compiler runs."""
    lib = library_path(source_dir, build_root)
    if lib.exists():
        return lib
    out = lib.parent
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():  # another process built it while we waited
            return lib
        with tempfile.TemporaryDirectory(dir=out) as tmp:
            objs = _compile(sources(source_dir), Path(tmp))
            staged = Path(tmp) / LIB_NAME
            _run([compiler(), *LDFLAGS, "-o", str(staged),
                  *map(str, objs)], "link")
            os.replace(staged, lib)
    return lib


def _compile(srcs: List[Path], tmp: Path) -> List[Path]:
    """One compiler process per source, all at once, each writing its
    messages to a log beside its object; on the first failure the rest are
    stopped and the failure raised with its log."""
    if not srcs:
        raise NativeBuildError(f"no C++ sources to build in {tmp}")
    jobs = []
    try:
        for src in srcs:
            obj, log = tmp / (src.stem + ".o"), tmp / (src.stem + ".log")
            with open(log, "w") as f:
                proc = subprocess.Popen(
                    [compiler(), *CXXFLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=f, stderr=subprocess.STDOUT)
            jobs.append((src, log, proc))
        pending = list(jobs)
        while pending:
            for job in list(pending):
                src, log, proc = job
                if proc.poll() is None:
                    continue
                pending.remove(job)
                if proc.returncode:
                    raise NativeBuildError(
                        f"compiling {src.name} failed (exit "
                        f"{proc.returncode}) with {compiler()}:\n"
                        f"{log.read_text()}")
            time.sleep(0.02)
    finally:
        for _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [tmp / (src.stem + ".o") for src in srcs]


def _run(cmd: List[str], what: str) -> None:
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise NativeBuildError(
            f"{what} failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}")
