"""Process execution with tree-safe termination (a copy of
``horovod_tpu/run/exec.py``).

Reference: horovod/run/common/util/safe_shell_exec.py (219 LoC) — run a
command in its own process group, forward termination to the whole tree,
stream output; and gloo_run's threaded per-slot execution with job-level
failure propagation (gloo_run.py:168-234, 294-304)."""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, IO, List, Optional

GRACEFUL_TERM_SECS = 5.0


def _stream(pipe: IO[bytes], sink, prefix: bytes,
            tee: Optional[IO[bytes]] = None) -> None:
    """Pump a child pipe to our stdout/stderr (when ``sink`` is set),
    rank-prefixed like horovodrun's `[1]<stdout>` tagging; optionally tee
    the raw (unprefixed) lines to a per-rank capture file (reference
    MultiFile, gloo_run.py:130-143,204-217).  A closed console (e.g. the
    launcher piped into `head`) stops only the console leg — the capture
    file keeps draining, that durability being what --output-filename is
    for."""
    sink_ok = sink is not None
    tee_ok = tee is not None
    try:
        for line in iter(pipe.readline, b""):
            if sink_ok:
                try:
                    sink.buffer.write(prefix + line)
                    sink.flush()
                except (ValueError, OSError):
                    # console gone (interpreter shutdown, or BrokenPipeError
                    # when the launcher's stdout is piped into a consumer
                    # that exited) — keep the capture leg alive
                    sink_ok = False
            if tee_ok:
                try:
                    tee.write(line)
                    tee.flush()
                except OSError:
                    tee_ok = False  # e.g. disk full; keep the console leg
            if not sink_ok and not tee_ok:
                break  # no destination left; stop pumping
    finally:
        pipe.close()
        if tee is not None:
            try:
                tee.close()
            except OSError:
                pass


@dataclass
class _Proc:
    rank: int
    popen: subprocess.Popen
    threads: List[threading.Thread]


class ProcessSet:
    """Launch N local commands; kill the whole set if any fails
    (reference gloo_run.py:294-304) or on SIGINT/SIGTERM."""

    def __init__(self):
        self._procs: List[_Proc] = []
        self._lock = threading.Lock()

    def install_signal_handlers(self) -> None:
        """Forward SIGTERM/SIGHUP to the worker tree before dying —
        children run in their own sessions, so without this a scheduler
        killing the launcher would orphan every worker (reference
        gloo_run.py registers the same propagation)."""

        def _handler(signum, frame):
            del frame
            # Restore the default disposition here: the handler runs on the
            # main thread, and signal.signal() refuses any other thread.
            signal.signal(signum, signal.SIG_DFL)
            # terminate() takes self._lock, which the interrupted main
            # thread may already hold (wait() polls under it) — and Python
            # locks are not reentrant, so calling it here could deadlock.
            # Do the work on a fresh thread and re-raise once it finishes.
            def _term_and_reraise():
                self.terminate()
                os.kill(os.getpid(), signum)

            threading.Thread(target=_term_and_reraise, daemon=True).start()

        for sig in (signal.SIGTERM, signal.SIGHUP):
            try:
                signal.signal(sig, _handler)
            except ValueError:
                pass  # not the main thread (e.g. run() from a worker)

    def launch(
        self,
        rank: int,
        cmd: List[str],
        env: Dict[str, str],
        tag_output: bool = True,
        stdin_data: Optional[bytes] = None,
        output_dir: Optional[str] = None,
        num_proc: int = 1,
    ) -> None:
        """``output_dir``: when set, each stream also lands in
        ``<output_dir>/rank.<padded>/stdout|stderr`` (reference
        --output-filename, gloo_run.py:204-217)."""
        capture = tag_output or output_dir is not None
        popen = subprocess.Popen(
            cmd,
            env=env,
            stdin=subprocess.PIPE if stdin_data is not None else None,
            stdout=subprocess.PIPE if capture else None,
            stderr=subprocess.PIPE if capture else None,
            start_new_session=True,  # own process group for tree kill
        )
        if stdin_data is not None:
            popen.stdin.write(stdin_data)
            popen.stdin.close()
        threads = []
        if capture:
            tees: Dict[str, Optional[IO[bytes]]] = {"stdout": None, "stderr": None}
            if output_dir is not None:
                pad = max(len(str(num_proc - 1)), 1)
                rank_dir = os.path.join(output_dir, f"rank.{rank:0{pad}d}")
                os.makedirs(rank_dir, exist_ok=True)
                for name in tees:
                    tees[name] = open(  # noqa: SIM115 — closed by _stream
                        os.path.join(rank_dir, name), "wb"
                    )
            for pipe, sink, name in (
                (popen.stdout, sys.stdout, "stdout"),
                (popen.stderr, sys.stderr, "stderr"),
            ):
                t = threading.Thread(
                    target=_stream,
                    args=(
                        pipe,
                        sink if tag_output else None,
                        f"[{rank}]".encode(),
                        tees[name],
                    ),
                    daemon=True,
                )
                t.start()
                threads.append(t)
        with self._lock:
            self._procs.append(_Proc(rank, popen, threads))

    # -- per-rank lifecycle (elastic launcher) ---------------------------
    # wait() keeps the reference's all-or-nothing contract (first failure
    # kills the job); the elastic monitor instead polls exits rank by
    # rank, discards the dead entry, and relaunches into the same set.

    def poll_exits(self) -> List[tuple]:
        """Reap newly exited workers: returns ``[(rank, returncode)]``
        and removes them from the set (their stream pumps drain on their
        own).  Non-destructive to still-running workers."""
        done: List[tuple] = []
        with self._lock:
            remaining = []
            for p in self._procs:
                rc = p.popen.poll()
                if rc is None:
                    remaining.append(p)
                else:
                    done.append((p.rank, rc))
            self._procs = remaining
        return done

    def alive_ranks(self) -> List[int]:
        with self._lock:
            return sorted(
                p.rank for p in self._procs if p.popen.poll() is None
            )

    def terminate_rank(self, rank: int, *, grace: float = 0.0) -> None:
        """Tree-kill one worker (heartbeat/progress-dead path: the
        process is still alive as far as the OS knows, but the job has
        declared it lost); its exit then surfaces through poll_exits().

        ``grace > 0`` escalates instead of executing: SIGUSR1 (the
        flight recorder's dump-only signal), then SIGTERM (the recorder's
        handler flushes and re-raises), then SIGKILL after ``grace``
        seconds on a watchdog thread, so the monitor loop never blocks.
        A rank whose main thread is inside a C call (a CUDA or NCCL wait)
        runs no Python signal handler until it returns; the flight
        recorder's flush thread dumps its ring within the grace anyway
        (``obs/flightrec.py``).  ``grace=0`` is an immediate SIGKILL."""
        with self._lock:
            procs = [p for p in self._procs if p.rank == rank]

        def _kill(pg_procs):
            for p in pg_procs:
                if p.popen.poll() is None:
                    try:
                        os.killpg(os.getpgid(p.popen.pid), signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):
                        pass

        if grace <= 0:
            _kill(procs)
            return
        for p in procs:
            if p.popen.poll() is None:
                for sig in (signal.SIGUSR1, signal.SIGTERM):
                    try:
                        os.killpg(os.getpgid(p.popen.pid), sig)
                    except (ProcessLookupError, PermissionError):
                        break

        def _watchdog():
            deadline = time.time() + grace
            for p in procs:
                while p.popen.poll() is None and time.time() < deadline:
                    time.sleep(0.05)
            _kill(procs)

        threading.Thread(target=_watchdog, daemon=True,
                         name=f"hvdtpu_kill_rank{rank}").start()

    def wait(self, timeout: Optional[float] = None) -> Dict[int, int]:
        """Wait for all; on first non-zero exit, terminate the rest and
        raise.  Returns {rank: returncode} when all succeed."""
        deadline = time.time() + timeout if timeout else None
        results: Dict[int, int] = {}
        try:
            while True:
                with self._lock:
                    procs = list(self._procs)
                pending = [p for p in procs if p.rank not in results]
                if not pending:
                    return results
                for p in pending:
                    rc = p.popen.poll()
                    if rc is not None:
                        results[p.rank] = rc
                        if rc != 0:
                            self.terminate()
                            raise RuntimeError(
                                f"Process {p.rank} exited with code {rc}; "
                                f"terminating remaining workers "
                                f"(launcher failure propagation)."
                            )
                if deadline and time.time() > deadline:
                    self.terminate()
                    raise TimeoutError("launcher wait() timed out")
                time.sleep(0.05)
        except KeyboardInterrupt:
            self.terminate()
            raise

    def terminate(self) -> None:
        """SIGUSR1 (the flight recorder's dump signal) and SIGTERM the
        process groups, escalate to SIGKILL after ``GRACEFUL_TERM_SECS``
        (reference safe_shell_exec's event-driven tree termination)."""
        with self._lock:
            procs = list(self._procs)
        for p in procs:
            if p.popen.poll() is None:
                for sig in (signal.SIGUSR1, signal.SIGTERM):
                    try:
                        os.killpg(os.getpgid(p.popen.pid), sig)
                    except (ProcessLookupError, PermissionError):
                        break
        deadline = time.time() + GRACEFUL_TERM_SECS
        for p in procs:
            while p.popen.poll() is None and time.time() < deadline:
                time.sleep(0.05)
            if p.popen.poll() is None:
                try:
                    os.killpg(os.getpgid(p.popen.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass


# Env vars whose values must never appear on a command line (`ps` exposes
# argv to every local user); they travel over the ssh channel's stdin.
SENSITIVE_ENV = ("HVDTPU_SECRET", "HVDTPU_NIC_SECRET")


def make_ssh_command(
    host: str, cmd: List[str], env: Dict[str, str], ssh_port: Optional[int]
) -> tuple:
    """Wrap a worker command for remote execution (reference
    gloo_run.py:168-234 get_remote_command: env exported inline over ssh).

    Returns ``(argv, stdin_data)``: sensitive values (the per-job HMAC
    secret) are read by the remote shell from stdin — inlining them in the
    argv would leak them via the process list on both ends."""
    public = {k: v for k, v in env.items() if k not in SENSITIVE_ENV}
    secret_items = [(k, env[k]) for k in SENSITIVE_ENV if k in env]
    exports = " ".join(f"{k}={_shquote(v)}" for k, v in sorted(public.items()))
    prelude = ""
    stdin_data: Optional[bytes] = None
    if secret_items:
        reads = "; ".join(
            f"IFS= read -r {k} && export {k}" for k, _ in secret_items
        )
        prelude = f"{reads}; "
        stdin_data = (
            "".join(f"{v}\n" for _, v in secret_items).encode() or None
        )
    remote = (
        f"{prelude}cd {_shquote(os.getcwd())} && env {exports} "
        f"{' '.join(_shquote(c) for c in cmd)}"
    )
    ssh = ["ssh", "-o", "StrictHostKeyChecking=no"]
    if ssh_port:
        ssh += ["-p", str(ssh_port)]
    return ssh + [host, remote], stdin_data


def _shquote(s: str) -> str:
    import shlex

    return shlex.quote(str(s))
