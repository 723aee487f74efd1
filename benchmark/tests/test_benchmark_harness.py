"""The benchmark's own tests, on the CPU (those that need the card are
marked ``gpu`` and skip without one, decided in a fixture):

    python -m pytest benchmark/tests -q

They hold ``BENCHMARK.json`` to the characters and keys its contract
allows, find every cell's files by name, check the copied arithmetic,
the frozen float32 references against the program's plain CPU path, the
seed's reach, that nothing the benchmark runs imports JAX or the JAX
package, and that the comparison fails the control and the faults.
"""

from __future__ import annotations

import ast
import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import flops, session
from benchmark.common import (FORBIDDEN_MODULES, HERE, ROOT, Cell,
                              forbidden_modules, load_json, make_cell, spec)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CELLS = [w["name"] for w in spec()["workloads"]]
SEED = 2 ** 31 + 4321  # past 32 signed bits, as the driver's are


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\t" not in text and "\n" not in text


def test_names_units_and_keys():
    b = spec()
    assert set(b) == TOP_KEYS
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert os.path.getsize(ROOT / "BENCHMARK.json") <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = Cell(cell)
    b = spec()
    assert c.config["name"] == c.entry["config"]
    assert (HERE / "families" / f"{c.config['family']}.py").exists()
    assert set(c.limits) == {"loss_gap", "grad_gap", "change_gap"}
    cfg_entry = [x for x in b["configs"] if x["name"] == c.entry["config"]][0]
    assert c.config["reduced"] == cfg_entry["reduced"]
    assert c.config["source"] == cfg_entry["source"]
    fam = session.family(c.config["family"])
    # every cell reports setup_s, one more end-to-end metric, and a
    # per-layer metric; each per-layer metric moves one the cell reports
    e2e = {m["name"] for m in c.end_to_end}
    kinds = {n.split(".")[0] for n in e2e}
    assert kinds == {"setup_s", fam.RATE_METRIC, "peak_mem_gib"}
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        read, data = session.reader(m["name"])
        assert callable(read)
        if data is not None:
            assert data["kernels"] and all(isinstance(k, str)
                                           for k in data["kernels"])


def test_readers_found_by_base_name():
    """A metric's reader and its kernel names are found by the name up to
    its first dot, so ``bn_device_ms.resnet`` and any later qualified
    name share ``metrics/bn_device_ms.*``; every reader file serves some
    metric of ``BENCHMARK.json``."""
    read, data = session.reader("bn_device_ms.resnet")
    assert read is session.reader("bn_device_ms.other")[0]
    assert data == load_json(HERE / "metrics" / "bn_device_ms.json")
    assert session.reader("mfu.resnet")[1] is None
    bases = {m["name"].split(".")[0] for m in spec()["per_layer"]}
    files = {p.stem.split(".")[0] for p in (HERE / "metrics").iterdir()
             if p.suffix in (".py", ".json")}
    assert files == bases


def test_copied_arithmetic():
    res = load_json(HERE / "configs" / "resnet50.json")
    assert flops.conv_flops_per_image(res) == pytest.approx(24.535e9,
                                                            rel=1e-4)


# -- tiny cells on the CPU -------------------------------------------------

def tiny_cell(dtype: str = "bf16"):
    """The ResNet-50 cell at a size the CPU holds, with the real cell's
    limits and metrics."""
    name = "resnet50.b256.1gpu"
    cfg = load_json(HERE / "configs" / "resnet50.json")
    # the last stage's BatchNorm needs some values per channel: 2 x 2 of
    # 16 images
    cfg.update(image_size=64, dtype=dtype)
    traffic = dict(Cell(name).traffic, batch_per_gpu=16, profile_steps=3,
                   warmup_steps=1)
    real = Cell(name)
    return make_cell(name, 1, cfg, traffic, real.limits, real.end_to_end,
                     real.per_layer)


def run_tiny(cell, dtype=None, fault=None, seed=SEED):
    run = session.run_program(cell, seed, 0.3, False, device="cpu",
                              dtype=dtype, fault=fault)
    ref = session.reference_of(cell, seed, "cpu")
    return run, ref


def test_reference_agrees_with_program_cpu():
    """The program's plain CPU path in fp32 against the frozen float32
    reference, from the same seeded weights and inputs: rounding apart."""
    cell = tiny_cell(dtype="fp32")
    run, ref = run_tiny(cell)
    numbers = session.compare(run["readings"], ref)
    assert numbers["loss_gap"] < 1e-4, numbers
    assert numbers["grad_gap"] < 1e-3, numbers
    assert numbers["change_gap"] < 5e-3, numbers
    assert forbidden_modules() == []
    assert len(run["step_s"]) >= 1


def test_seed_changes_inputs_and_weights():
    import torch

    cell = tiny_cell()
    fam = session.family(cell.config["family"])
    w = [fam.weights(cell.config, s, "cpu") for s in (SEED, SEED + 1, SEED)]
    x = [fam.batches(cell.config, cell.traffic, s, "cpu")
         for s in (SEED, SEED + 1, SEED)]
    big = max(w[0], key=lambda k: w[0][k].numel())
    assert not torch.equal(w[0][big], w[1][big])
    assert torch.equal(w[0][big], w[2][big])
    assert not torch.equal(x[0][0][0], x[1][0][0])
    assert torch.equal(x[0][0][0], x[2][0][0])
    # every row of the check steps differs
    rows = torch.cat([e[0].reshape(e[0].shape[0], -1).float()
                      for e in x[0][:cell.traffic["check_steps"]]])
    assert torch.unique(rows, dim=0).shape[0] == rows.shape[0]


def _imports(path) -> set:
    """Top-level names of every module ``path`` imports (absolute
    imports; relative ones stay inside the benchmark)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_imports_jax_and_reference_imports_no_program():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for f in files:
        found = _imports(f) & set(FORBIDDEN_MODULES)
        assert not found, f"{f} imports {found}"
    assert "horovod_tpu" in FORBIDDEN_MODULES
    assert "horovod_tpu_torch".split(".")[0] not in FORBIDDEN_MODULES
    for f in sorted((HERE / "reference").rglob("*.py")):
        assert "horovod_tpu_torch" not in _imports(f), f
        assert "benchmark" not in _imports(f), f


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import common

    monkeypatch.setitem(sys.modules, "horovod_tpu_torch_fake", object())
    assert "horovod_tpu_torch_fake" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "horovod_tpu.fake", object())
    assert "horovod_tpu.fake" in common.forbidden_modules()


# -- the control and the faults fail the comparison ------------------------

def test_control_fails():
    """The control, the program's own lower-precision path (``fp8``: bf16
    compute with e4m3 activation storage), at a size the CPU holds, is
    judged not correct under the cell's limits, where the same run in
    fp32 passes."""
    cell = tiny_cell(dtype="fp32")
    run, ref = run_tiny(cell)
    ok, check = session.judge(cell, session.compare(run["readings"], ref))
    assert ok, check
    run, ref = run_tiny(cell, dtype="fp8")
    ok, check = session.judge(cell, session.compare(run["readings"], ref))
    assert not ok, check


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_fault_fails(fault):
    """A run with the timed path broken underneath, through the harness's
    own result: ``correct`` comes out false."""
    from benchmark import run

    cell = tiny_cell(dtype="fp32")
    program, ref = run_tiny(cell, fault=fault)
    out = run.result(cell, program, ref, False, 1.0, "cpu")
    assert out["correct"] is False, out["check"]
    if fault == "unchanged":
        assert out["check"]["change_gap"]["value"] == pytest.approx(1.0)


# -- the command --------------------------------------------------------

def _run_cli(cwd, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the no-card exit is not reachable")


def test_no_card_no_result(no_card):
    proc = _run_cli(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    the program is missing: the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    proc = _run_cli(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
def test_cell_runs_on_card(card):
    """A short run of the first cell on the card: correct, every
    end-to-end metric finite."""
    proc = _run_cli(ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert all(math.isfinite(m["value"]) for m in out["metrics"].values())
    assert list(out)[-1] == "check"
