"""The port's hvdtpu-lint (``horovod_tpu_torch.analysis``), held against the
JAX package's (``horovod_tpu.analysis``).

* Every source input of ``tests/test_analysis.py`` and
  ``tests/test_racer_unit.py`` (the string literals that parse as Python,
  and the racer tests' ``{file name: source}`` projects), written to
  ``tmp_path``, gives the same findings under both analyzers: rule, line,
  column, message and status, with ``horovod_tpu`` renamed
  ``horovod_tpu_torch`` in the port's copy (its own package) and back in
  its messages.  One parametrised case per input.
* Every rule but HVD009 fires on a ``torch.distributed``-spelled example,
  on the line marked ``# <-`` (and only there), and is quiet on its clean
  twin; HVD009's catalog entry says why it has no torch form.
* The configured surface covers every ``.py`` of ``horovod_tpu_torch``,
  the port's tree lints clean against its baseline, and the analyzer
  imports no torch.
"""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from horovod_tpu.analysis import analyze_paths as reference_analyze
from horovod_tpu_torch.analysis import all_rules, analyze_paths
from horovod_tpu_torch.analysis.baseline import load_baseline
from horovod_tpu_torch.analysis.config import load_config

REPO = Path(__file__).resolve().parent.parent
_PKG = re.compile(r"\bhorovod_tpu\b")


def _inputs(test_file: str) -> list:
    """``(id, {file name: source})`` for every source input of a test
    module of the reference's analyzer."""
    path = REPO / "tests" / test_file
    tree = ast.parse(path.read_text())
    projects, taken = [], set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) and isinstance(k.value, str)
                and k.value.endswith(".py") for k in node.keys) and all(
                isinstance(v, ast.Constant) and isinstance(v.value, str)
                for v in node.values):
            projects.append((f"{test_file}:{node.lineno}", {
                k.value: textwrap.dedent(v.value)
                for k, v in zip(node.keys, node.values)}))
            taken.update(id(v) for v in node.values)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Constant) or \
                not isinstance(node.value, str) or id(node) in taken:
            continue
        src = textwrap.dedent(node.value)
        if src.count("\n") < 2:
            continue
        try:
            ast.parse(src)
        except SyntaxError:
            continue
        projects.append((f"{test_file}:{node.lineno}", {"snippet.py": src}))
    return projects


INPUTS = _inputs("test_analysis.py") + _inputs("test_racer_unit.py")


def _found(findings, port: bool) -> list:
    return sorted(
        (f.path, f.rule, f.line, f.col,
         f.message.replace("horovod_tpu_torch", "horovod_tpu") if port
         else f.message, f.status)
        for f in findings)


def test_inputs_were_found():
    # the fixtures (two per rule) and the edge cases of both files
    assert len(INPUTS) >= 90
    # the racer tests' projects keep their file names
    assert sum("snippet.py" not in files for _, files in INPUTS) >= 3


@pytest.mark.parametrize("files", [files for _, files in INPUTS],
                         ids=[name for name, _ in INPUTS])
def test_findings_match_the_reference(tmp_path, files):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    for name, src in files.items():
        (ref_dir / name).write_text(src)
        (port_dir / name).write_text(_PKG.sub("horovod_tpu_torch", src))
    want = _found(reference_analyze([str(ref_dir)], root=str(ref_dir)),
                  port=False)
    got = _found(analyze_paths([str(port_dir)], root=str(port_dir)),
                 port=True)
    assert got == want


# ---------------------------------------------------------------------------
# torch spellings: rule id -> (firing source, clean twin); the firing
# source marks the lines the rule must report with "# <-"
# ---------------------------------------------------------------------------

TORCH_FIXTURES = {
    "HVD001": (
        """
        import torch.distributed as dist

        def step(x):
            if dist.get_rank() == 0:
                dist.all_reduce(x)  # <-
            return x
        """,
        """
        import torch.distributed as dist

        def step(x):
            dist.all_reduce(x)
            if dist.get_rank() == 0:
                print(x)
            return x
        """,
    ),
    "HVD002": (
        """
        import torch.distributed as dist

        def reduce_all(grads):
            for k in {"w", "b"}:
                dist.all_reduce(grads[k])  # <-
        """,
        """
        import torch.distributed as dist

        def reduce_all(grads):
            for k in sorted({"w", "b"}):
                dist.all_reduce(grads[k])
        """,
    ),
    "HVD003": (
        """
        import torch.distributed as dist

        def step(x, spiked):
            if spiked:
                dist.all_reduce(x)  # <-
            return x
        """,
        """
        import torch.distributed as dist

        def step(x, spiked):
            dist.all_reduce(x)
            if spiked:
                x = x * 2
            return x
        """,
    ),
    "HVD004": (
        """
        import torch
        import horovod_tpu_torch as hvd

        def main(model):
            hvd.init()  # <-
            opt = torch.optim.SGD(model.parameters(), lr=0.1)
            return hvd.DistributedOptimizer(opt)

        if __name__ == "__main__":
            main(torch.nn.Linear(2, 2))
        """,
        """
        import torch
        import horovod_tpu_torch as hvd

        def main(model):
            hvd.init()
            hvd.broadcast_parameters(model.state_dict(), root_rank=0)
            opt = torch.optim.SGD(model.parameters(), lr=0.1)
            return hvd.DistributedOptimizer(opt)

        if __name__ == "__main__":
            main(torch.nn.Linear(2, 2))
        """,
    ),
    "HVD005": (
        """
        import torch.distributed as dist

        IS_CHIEF = dist.get_rank() == 0  # <-
        """,
        """
        import torch.distributed as dist

        dist.init_process_group("gloo")
        IS_CHIEF = dist.get_rank() == 0
        """,
    ),
    "HVD006": (
        """
        import torch.distributed as dist

        def step(x):
            try:
                dist.all_reduce(x)
            except RuntimeError:
                dist.barrier()  # <-
            return x
        """,
        """
        import torch.distributed as dist

        def step(x):
            try:
                dist.all_reduce(x)
            finally:
                dist.barrier()
            return x
        """,
    ),
    "HVD007": (
        """
        import torch.distributed as dist
        import horovod_tpu_torch as hvd

        def step(x):
            return hvd.allreduce(x, name=f"grad_{dist.get_rank()}")  # <-
        """,
        """
        import torch.distributed as dist
        import horovod_tpu_torch as hvd

        def step(x):
            return hvd.allreduce(x, name="grad_w0")
        """,
    ),
    "HVD008": (
        """
        import torch.distributed as dist

        def checkpoint_barrier():
            dist.barrier()  # <-
        """,
        """
        import horovod_tpu_torch as hvd

        def checkpoint_barrier():
            hvd.barrier()
        """,
    ),
    "HVD010": (
        """
        import torch.distributed as dist
        from horovod_tpu_torch import basics

        def reduce_part(flag, x):
            if flag == 0:
                dist.all_reduce(x, group=basics.local_group())  # <-
            return x

        def step(x):
            return reduce_part(basics.local_rank(), x)
        """,
        """
        import torch.distributed as dist
        from horovod_tpu_torch import basics

        def reduce_part(flag, x):
            dist.all_reduce(x, group=basics.local_group())
            if flag == 0:
                return x
            return x * 0

        def step(x):
            return reduce_part(basics.local_rank(), x)
        """,
    ),
    "HVD011": (
        """
        import torch.distributed as dist
        from horovod_tpu_torch.basics import group_of_axis

        def step(x, fast_path):
            axis = "hvd_local" if fast_path else "hvd_cross"
            dist.all_reduce(x, group=group_of_axis(axis))  # <-
        """,
        """
        import torch.distributed as dist
        from horovod_tpu_torch.basics import group_of_axis

        def step(x):
            dist.all_reduce(x, group=group_of_axis("hvd_local"))
        """,
    ),
    "HVD012": (
        """
        import torch

        # hvdtpu: deterministic
        def pick_slot(queue, slots):
            return slots[int(torch.randint(len(slots), (1,)))]  # <-
        """,
        """
        import torch

        # hvdtpu: deterministic
        def pick_slot(queue, slots, gen: torch.Generator):
            return slots[int(torch.randint(len(slots), (1,), generator=gen))]
        """,
    ),
    "HVD013": (
        """
        import torch.distributed as dist

        def record(trace, tid, t0, t1):
            if dist.get_rank() == 0:
                trace.add_span(tid, "decode", t0, t1)  # <-
        """,
        """
        def record(trace, tid, t0, t1, enabled):
            if enabled:
                trace.add_span(tid, "decode", t0, t1)
        """,
    ),
    "HVDC101": (
        """
        import threading

        import torch.distributed as dist

        _table_lock = threading.Lock()
        _stream_lock = threading.Lock()

        def enqueue(t):
            with _table_lock:
                with _stream_lock:
                    dist.all_reduce(t)

        def drain(t):
            with _stream_lock:
                with _table_lock:  # <-
                    dist.all_reduce(t)
        """,
        """
        import threading

        import torch.distributed as dist

        _table_lock = threading.Lock()
        _stream_lock = threading.Lock()

        def enqueue(t):
            with _table_lock:
                with _stream_lock:
                    dist.all_reduce(t)

        def drain(t):
            with _table_lock:
                with _stream_lock:
                    dist.all_reduce(t)
        """,
    ),
    "HVDC102": (
        """
        import threading

        import torch.distributed as dist

        class Engine:
            def __init__(self):
                self._lock = threading.Lock()

            def cycle(self, t):
                with self._lock:
                    work = dist.all_reduce(t, async_op=True)
                    work.wait()  # <-
        """,
        """
        import threading

        import torch.distributed as dist

        class Engine:
            def __init__(self):
                self._lock = threading.Lock()

            def cycle(self, t):
                with self._lock:
                    work = dist.all_reduce(t, async_op=True)
                work.wait()
        """,
    ),
    "HVDC103": (
        """
        import signal
        import threading

        import torch

        _lock = threading.Lock()

        def _flush():
            with _lock:  # <-
                torch.save({}, "/dev/null")

        def _handler(signum, frame):
            _flush()

        def install():
            signal.signal(signal.SIGTERM, _handler)
        """,
        """
        import signal
        import threading

        import torch

        _lock = threading.RLock()

        def _flush():
            with _lock:
                torch.save({}, "/dev/null")

        def _handler(signum, frame):
            _flush()

        def install():
            signal.signal(signal.SIGTERM, _handler)
        """,
    ),
    "HVDC104": (
        """
        import logging
        import signal

        import torch

        LOG = logging.getLogger("x")

        def _handler(signum, frame):
            LOG.warning("dying, %d B", torch.cuda.memory_allocated())  # <-

        def install():
            signal.signal(signal.SIGTERM, _handler)
        """,
        """
        import logging
        import signal

        import torch

        LOG = logging.getLogger("x")

        def _handler(signum, frame):
            pass

        def install():
            signal.signal(signal.SIGTERM, _handler)
            LOG.info("hooks in, %d B", torch.cuda.memory_allocated())
        """,
    ),
    "HVDC105": (
        """
        import torch.distributed as dist

        def step(g):
            try:
                dist.all_reduce(g)
            except RuntimeError:  # <-
                return g
            return g
        """,
        """
        import torch.distributed as dist

        from horovod_tpu_torch.exceptions import HorovodShutdownError

        def step(g):
            try:
                dist.all_reduce(g)
            except HorovodShutdownError:
                raise
            except RuntimeError:
                return g
            return g
        """,
    ),
    "HVDC106": (
        """
        import torch.distributed as dist

        from horovod_tpu_torch.obs.flightrec import on_death

        def _flush():
            dist.all_reduce(_STATE, async_op=True).wait()  # <-

        def arm():
            on_death(_flush)
        """,
        """
        from horovod_tpu_torch.obs.flightrec import on_death

        def _flush():
            pass

        def arm():
            on_death(_flush)
        """,
    ),
    "HVDC107": (
        """
        import signal

        import torch

        def _handler(signum, frame):
            events = []
            while True:
                events.append(torch.cuda.memory_allocated())  # <-

        def install():
            signal.signal(signal.SIGTERM, _handler)
        """,
        """
        import signal

        import torch

        def _handler(signum, frame):
            events = []
            while True:
                events.append(torch.cuda.memory_allocated())
                if len(events) > 8:
                    break

        def install():
            signal.signal(signal.SIGTERM, _handler)
        """,
    ),
    "HVDC108": (
        """
        import threading

        import torch

        class Pump:
            def __init__(self):
                self._lock = threading.Lock()
                self._streams = {}

            def start(self):
                threading.Thread(target=self._run).start()

            def _run(self):
                with self._lock:
                    self._streams[0] = torch.cuda.Stream()
                with self._lock:
                    self._streams = {}

            def streams(self):
                with self._lock:
                    return dict(self._streams)

            def spill(self):
                self._streams = {}  # <-
        """,
        """
        import threading

        import torch

        class Pump:
            def __init__(self):
                self._lock = threading.Lock()
                self._streams = {}

            def start(self):
                threading.Thread(target=self._run).start()

            def _run(self):
                with self._lock:
                    self._streams[0] = torch.cuda.Stream()
                with self._lock:
                    self._streams = {}

            def streams(self):
                with self._lock:
                    return dict(self._streams)

            def spill(self):
                with self._lock:
                    self._streams = {}
        """,
    ),
    "HVDC109": (
        """
        import threading

        import torch.distributed as dist

        class Engine:
            def __init__(self):
                self._lock = threading.Lock()
                self._stop = False

            def start(self):
                threading.Thread(target=self._run).start()

            def _run(self):
                with self._lock:
                    self._stop = False
                with self._lock:
                    self._stop = True

            def pump(self, t):
                if not self._stop:  # <-
                    dist.all_reduce(t)
        """,
        """
        import threading

        import torch.distributed as dist

        class Engine:
            def __init__(self):
                self._lock = threading.Lock()
                self._stop = False

            def start(self):
                threading.Thread(target=self._run).start()

            def _run(self):
                with self._lock:
                    self._stop = False
                with self._lock:
                    self._stop = True

            def pump(self, t):
                with self._lock:
                    stop = self._stop
                if not stop:
                    dist.all_reduce(t)
        """,
    ),
    "HVDC110": (
        """
        import threading

        import torch.distributed as dist

        class Once:
            def __init__(self):
                self._lock = threading.Lock()
                self._started = False

            def launch(self):
                threading.Thread(target=self._work).start()

            def _work(self):
                with self._lock:
                    self._started = False

            def start(self):
                if not self._started:  # <-
                    with self._lock:
                        self._started = dist.is_initialized()
        """,
        """
        import threading

        import torch.distributed as dist

        class Once:
            def __init__(self):
                self._lock = threading.Lock()
                self._started = False

            def launch(self):
                threading.Thread(target=self._work).start()

            def _work(self):
                with self._lock:
                    self._started = False

            def start(self):
                with self._lock:
                    if not self._started:
                        self._started = dist.is_initialized()
        """,
    ),
}


# HVD008's torch form judges library code: its fixture is a module of the
# package
_FIXTURE_PATH = {"HVD008": "horovod_tpu_torch/ckpt_sync.py"}


def _lint(tmp_path, source, rel="snippet.py", rules=None):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return analyze_paths([rel], root=str(tmp_path), rules=rules)


def _lines(findings, rule):
    return sorted(f.line for f in findings
                  if f.rule == rule and f.status == "new")


def test_every_rule_but_hvd009_has_a_torch_fixture():
    assert set(all_rules()) - set(TORCH_FIXTURES) == {"HVD009"}


@pytest.mark.parametrize("rule_id", sorted(TORCH_FIXTURES))
def test_torch_spelling_fires_on_its_line(tmp_path, rule_id):
    bad, _ = TORCH_FIXTURES[rule_id]
    marked = [i for i, line in enumerate(
        textwrap.dedent(bad).splitlines(), start=1)
        if line.rstrip().endswith("# <-")]
    findings = _lint(tmp_path, bad, _FIXTURE_PATH.get(rule_id, "snippet.py"))
    assert marked and _lines(findings, rule_id) == marked, \
        [(f.rule, f.line, f.message) for f in findings]


@pytest.mark.parametrize("rule_id", sorted(TORCH_FIXTURES))
def test_torch_clean_twin_is_quiet(tmp_path, rule_id):
    _, good = TORCH_FIXTURES[rule_id]
    findings = _lint(tmp_path, good,
                     _FIXTURE_PATH.get(rule_id, "snippet.py"))
    assert _lines(findings, rule_id) == [], \
        [(f.rule, f.line, f.message) for f in findings]


def test_hvd009_catalog_says_why_it_has_no_torch_form():
    doc = all_rules()["HVD009"].doc
    assert "no buffer donation" in doc and "no torch spelling" in doc


# ---------------------------------------------------------------------------
# the vocabulary's edges
# ---------------------------------------------------------------------------


def test_hvd004_ddp_counts_as_the_initial_sync(tmp_path):
    findings = _lint(tmp_path, """
        import torch
        import horovod_tpu_torch as hvd
        from torch.nn.parallel import DistributedDataParallel

        def main(model):
            hvd.init()
            model = DistributedDataParallel(model)
            return hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1))
        """)
    assert _lines(findings, "HVD004") == []


def test_hvd008_judges_library_code_and_tcpstore_exchanges(tmp_path):
    src = """
        import torch.distributed as dist

        def sync(t):
            dist.all_reduce(t)
        """
    # a user script's collective surface: quiet
    assert _lines(_lint(tmp_path, src, "train.py"), "HVD008") == []
    assert _lines(_lint(tmp_path, src, "horovod_tpu_torch/m.py"),
                  "HVD008") == [5]
    findings = _lint(tmp_path, """
        import torch.distributed as dist

        def rendezvous(host, port, n):
            store = dist.TCPStore(host, port, n, False)
            store.set("ready", "1")
            return store.get("peer")
        """, "launch.py")
    assert _lines(findings, "HVD008") == [6, 7]


def test_generic_spellings_count_only_on_torch_distributed(tmp_path):
    findings = _lint(tmp_path, """
        import functools

        import numpy as np

        def pick(xs, idx, spiked):
            if spiked:
                total = functools.reduce(max, xs)
                part = np.take(xs, idx).gather(idx)
                return total, part
            return xs
        """)
    assert _lines(findings, "HVD003") == []
    findings = _lint(tmp_path, """
        from torch.distributed import reduce
        import torch.distributed

        def pick(x, spiked):
            if spiked:
                reduce(x, dst=0)
                torch.distributed.gather(x)
            return x
        """)
    assert _lines(findings, "HVD003") == [7, 8]


def test_hvd001_rank_environment_reads(tmp_path):
    findings = _lint(tmp_path, """
        import os

        import torch.distributed as dist

        def step(x):
            if os.environ["LOCAL_RANK"] == "0":
                dist.broadcast(x, src=0)
            if int(os.environ.get("RANK", "0")) > 0:
                dist.all_reduce(x)
            if os.getenv("HVDTPU_LOCAL_RANK") == "0":
                dist.barrier()
            if dist.get_world_size() > 1:
                dist.all_reduce(x)
            return x
        """)
    assert _lines(findings, "HVD001") == [8, 10, 12]
    # a world-size probe is rank-uniform: no HVD003 either
    assert 14 not in _lines(findings, "HVD003")


def test_hvd010_axis_groups_scope_the_taint(tmp_path):
    findings = _lint(tmp_path, """
        import torch.distributed as dist
        from horovod_tpu_torch import basics

        CROSS = basics.group_of_axis("hvd_cross")

        def local_first(x):
            if basics.local_rank() == 0:
                dist.all_reduce(x, group=CROSS)
            return x

        def world_first(x):
            if dist.get_rank() == 0:
                dist.all_reduce(x, group=CROSS)
            return x

        def tp_first(x):
            if dist.get_rank(group=basics.group_of_axis("tp")) == 0:
                dist.all_reduce(x, group=basics.group_of_axis("dp"))
            return x

        def tp_guard(x):
            if dist.get_rank(group=basics.group_of_axis("tp")) == 0:
                dist.all_reduce(x, group=basics.group_of_axis("tp"))
            return x
        """, rules={"HVD010"})
    # local-rank taint is uniform inside a cross group, and tp-rank taint
    # inside a dp group; the world rank differs in every group
    assert _lines(findings, "HVD010") == [14, 24]


def test_hvd010_an_all_reduce_in_place_sanitizes(tmp_path):
    findings = _lint(tmp_path, """
        import torch
        import torch.distributed as dist
        from horovod_tpu_torch import basics

        def helper(x, flag):
            if flag:
                dist.all_reduce(x, group=basics.group_of_axis("hvd_local"))
            return x

        def step(x):
            flag = torch.tensor(float(basics.local_rank() == 0))
            dist.all_reduce(flag)
            return helper(x, flag)

        def unsanitized(x):
            flag = torch.tensor(float(basics.local_rank() == 0))
            return helper(x, flag)
        """, rules={"HVD010"})
    assert len(_lines(findings, "HVD010")) == 1
    assert "unsanitized" in [f for f in findings
                             if f.rule == "HVD010"][0].message


def test_hvd012_explicit_generator_is_deterministic(tmp_path):
    findings = _lint(tmp_path, """
        import torch

        # hvdtpu: deterministic
        def order(n, gen):
            return torch.randperm(n, generator=gen)

        # hvdtpu: deterministic
        def reseed(n):
            torch.manual_seed(0)
            return torch.randperm(n)
        """)
    assert _lines(findings, "HVD012") == [10, 11]


# ---------------------------------------------------------------------------
# the port's surface
# ---------------------------------------------------------------------------


def test_config_defaults_are_the_ports():
    cfg = load_config(str(REPO))
    assert cfg.paths == ["horovod_tpu_torch", "chip_smoke.py"]
    assert cfg.baseline == "horovod_tpu_torch/analysis/baseline.json"
    assert cfg.cache == ".hvdtpu-torch-lint-cache.json"
    assert cfg.exclude == ["horovod_tpu_torch/_build"]


def test_configured_surface_covers_package():
    """The configured paths cover EVERY python file of horovod_tpu_torch/
    and chip_smoke.py: a subpackage added later cannot escape the gate."""
    from horovod_tpu_torch.analysis.cli import _iter_py_files

    cfg = load_config(str(REPO))
    surface = set(_iter_py_files(cfg.paths, cfg.exclude, str(REPO)))
    want = {str(p) for p in (REPO / "horovod_tpu_torch").rglob("*.py")
            if "__pycache__" not in p.parts and "_build" not in p.parts}
    want.add(str(REPO / "chip_smoke.py"))
    assert not want - surface, sorted(want - surface)


def test_self_application_is_clean_against_baseline():
    """The port's tree lints clean against its baseline, and the baseline
    holds no stale entry (``--strict-baseline``) and a reason for each."""
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis", "--no-cache",
         "--strict-baseline", "--jobs", "0"],
        cwd=str(REPO), capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert "0 new finding(s)" in out.stdout
    baseline = load_baseline(
        str(REPO / "horovod_tpu_torch" / "analysis" / "baseline.json"))
    for (rule, path, _), entry in baseline.items():
        assert rule in all_rules() and (REPO / path).is_file()
        assert len(entry["reason"]) > 40


_STANDALONE = textwrap.dedent("""
    import json, sys, types
    for name in ("torch", "jax", "jaxlib", "numpy", "horovod_tpu"):
        sys.modules[name] = None   # any import of these now raises
    # the analysis package alone, without its parent's __init__
    parent = types.ModuleType("horovod_tpu_torch")
    parent.__path__ = [{pkg!r}]
    sys.modules["horovod_tpu_torch"] = parent
    from horovod_tpu_torch.analysis import cli, registry, schedule
    rc = cli.main(["--list-rules"])
    print(json.dumps({{"rc": rc, "rules": len(registry.all_rules()),
                       "schema": schedule.SCHEDULE_SCHEMA}}))
""")


def test_analysis_imports_no_torch():
    code = _STANDALONE.format(pkg=str(REPO / "horovod_tpu_torch"))
    out = subprocess.run([sys.executable, "-I", "-B", "-c", code],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(REPO / "tests"))
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc == {"rc": 0, "rules": len(all_rules()),
                   "schema": "hvdtpu-torch-fr-schedule-v1"}


def test_cli_exit_codes_and_json(tmp_path):
    bad, good = TORCH_FIXTURES["HVD001"]
    (tmp_path / "bad.py").write_text(textwrap.dedent(bad))
    (tmp_path / "good.py").write_text(textwrap.dedent(good))

    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.analysis", *args],
            cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
            env={**os.environ, "PYTHONPATH": str(REPO) + os.pathsep
                 + os.environ.get("PYTHONPATH", "")})

    assert cli("good.py").returncode == 0
    r = cli("bad.py", "--format", "json")
    assert r.returncode == 1
    doc = json.loads(r.stdout)
    assert doc["schema"] == "hvdtpu-lint-v1"
    assert [f["rule"] for f in doc["findings"]] == ["HVD001"]
    assert cli("bad.py", "--rules", "HVD999").returncode == 2
    assert cli("--strict-baseline", "bad.py").returncode == 2
