"""horovod_tpu_torch and chip_smoke.py import no JAX and nothing of
horovod_tpu, and the port never falls back to the CPU on its own.

The import check runs in a fresh isolated interpreter (``python -I -B``: no
site customisation that could preload JAX) with ``jax``, ``flax``,
``optax`` and ``horovod_tpu`` blocked in ``sys.modules``; a static pass
over the sources also catches imports inside functions.
"""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "horovod_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")

_SCRIPT = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    sys.path.insert(0, {repo!r})
    for name in {forbidden!r}:
        sys.modules[name] = None  # any import of it now raises
    import horovod_tpu_torch
    mods = sorted(m.name for m in pkgutil.walk_packages(
        horovod_tpu_torch.__path__, "horovod_tpu_torch."))
    for m in mods:
        importlib.import_module(m)
    import chip_smoke
    flops = chip_smoke.attention_work(8, 1024, 12, 12, 64, True, None, 2)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in {forbidden!r}
                    and sys.modules[m] is not None)
    try:
        horovod_tpu_torch.init()
        init_error = None
    except RuntimeError as e:
        init_error = str(e)
    print(json.dumps({{"modules": mods, "leaked": leaked,
                      "init_error": init_error,
                      "smoke_rc": chip_smoke.main(),
                      "fwd_flops": flops["flash_fwd"][0]}}))
""")


def _run_isolated():
    code = _SCRIPT.format(repo=str(REPO), forbidden=FORBIDDEN)
    # -B: -I ignores PYTHONDONTWRITEBYTECODE, and the interpreter must not
    # write bytecode caches next to the installed packages
    out = subprocess.run([sys.executable, "-I", "-B", "-c", code],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(REPO / "tests"))
    assert out.returncode == 0, out.stderr
    import json

    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_module_imports_without_jax():
    res = _run_isolated()
    for mod in ("ops.flash_attention", "train", "optim.overlap", "ops.rope",
                "runtime.autotune", "bench"):
        assert f"horovod_tpu_torch.{mod}" in res["modules"], mod
    assert res["leaked"] == []
    # causal pairs of gpt-small's attention x 4 * head_dim
    assert res["fwd_flops"] == 4 * 64 * 96 * (1024 * 1025 // 2)


def test_gpu_entry_points_refuse_to_run_without_a_gpu():
    """init() with no device argument means the GPU: with none visible it
    raises instead of falling back; chip_smoke exits 2 with no result."""
    res = _run_isolated()
    assert res["init_error"] is not None and "device='cpu'" in \
        res["init_error"]
    assert res["smoke_rc"] == 2


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_names_a_forbidden_import():
    # _build/ holds what the kernels' build writes, not sources of the port
    files = sorted(f for f in PKG.rglob("*.py")
                   if "_build" not in f.relative_to(PKG).parts)
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imports(f) if name.split(".")[0] in FORBIDDEN]
    assert bad == []
