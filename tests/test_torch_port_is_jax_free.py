"""horovod_tpu_torch and chip_smoke.py import no JAX and nothing of
horovod_tpu, and the port never falls back to the CPU on its own.

The import check runs in a fresh isolated interpreter (``python -I -B``: no
site customisation that could preload JAX) with ``jax``, ``flax``,
``optax`` and ``horovod_tpu`` blocked in ``sys.modules``, and with them
``cloudpickle``, ``orbax`` and ``ml_dtypes``, which the card's machine may
lack: only ``run/api.py`` imports cloudpickle, inside the functions that
ship a callable and only where it is installed, and nothing may import it
when a module is imported.  A static pass over the sources also catches imports inside
functions.  The TensorFlow frontends (``interop.tf``, ``interop.tf_keras``,
``interop.keras``) import ``tensorflow``, which the card's machine lacks
and which needs ``ml_dtypes``: the walk leaves them out and checks that no
other module imports tensorflow; a second interpreter imports them with
JAX and the reference still blocked.
"""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "horovod_tpu_torch"
# the reference's examples, ported as horovod_tpu_torch.examples.<name>
EXAMPLES = ("adasum_small_model", "bert_style", "checkpoint_resume",
            "cluster_run", "elastic_train", "estimator_train",
            "keras_mnist", "long_context_zigzag", "mnist", "pipeline_train",
            "synthetic_benchmark", "tf2_mnist", "torch_mnist")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu", "orbax",
             "ml_dtypes")
# not on the card's machine, so never imported at a module's top level
LAZY_ONLY = ("cloudpickle",)
# the frontends that import tensorflow at module level
TF_MODULES = ("horovod_tpu_torch.interop.tf",
              "horovod_tpu_torch.interop.tf_keras",
              "horovod_tpu_torch.interop.keras")

_SCRIPT = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    sys.path.insert(0, {repo!r})
    for name in {forbidden!r}:
        sys.modules[name] = None  # any import of it now raises
    import horovod_tpu_torch
    mods = sorted(m.name for m in pkgutil.walk_packages(
        horovod_tpu_torch.__path__, "horovod_tpu_torch."))
    for m in mods:
        if m not in {tf_modules!r}:
            importlib.import_module(m)
    tf_imported = "tensorflow" in sys.modules
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
                      "tf_imported": tf_imported,
                      "init_error": init_error,
                      "smoke_rc": chip_smoke.main(),
                      "fwd_flops": flops["flash_fwd"][0]}}))
""")


def _run_isolated():
    code = _SCRIPT.format(repo=str(REPO), forbidden=FORBIDDEN + LAZY_ONLY,
                          tf_modules=TF_MODULES)
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
                "runtime.autotune", "bench", "runtime.engine",
                "runtime.controller", "runtime.device_plane",
                "runtime.messages", "runtime.response_cache",
                "runtime.timeline", "ops.eager", "interop.torch",
                "_engine_registry", "obs", "obs.progress",
                "obs.pathspec", "testing.faults", "run.runner",
                "run.rendezvous", "run.allocate", "run.blacklist",
                "run.config_parser", "run.exec", "run.__main__",
                "elastic.context", "elastic.state", "elastic.run",
                "elastic.launch", "elastic.worker", "ckpt.sharded",
                "ckpt.replica", "ckpt.tree", "checkpoint", "callbacks",
                "utils.logging", "run.api", "run.task_fn",
                "run.driver_service", "cluster", "serve.frontend",
                "serve.hotswap", "serve.service", "serve.__main__",
                "obs.slo", "obs.goodput", "obs.memplane",
                "obs.profile", "obs.registry", "obs.flightrec",
                "obs.trace", "obs.straggler", "obs.stream", "obs.trend",
                "obs.live", "obs.summary", "obs.timeline_merge",
                "obs.trace_merge", "obs.postmortem", "obs.health",
                "obs.divergence", "obs.anatomy", "bench.campaign",
                "bench.__main__", "bench.supervisor", "bench.collective",
                "estimator", "serve.autoscale",
                "interop.mxnet", "interop._host", "runtime.native",
                "runtime.native_build", "optim", "basics",
                "ops.collectives", "examples", "examples._common") + tuple(
                    f"examples.{name}" for name in EXAMPLES) + tuple(
                    m[len("horovod_tpu_torch."):] for m in TF_MODULES):
        assert f"horovod_tpu_torch.{mod}" in res["modules"], mod
    assert res["leaked"] == []
    assert res["tf_imported"] is False
    # causal pairs of gpt-small's attention x 4 * head_dim
    assert res["fwd_flops"] == 4 * 64 * 96 * (1024 * 1025 // 2)


def test_tf_frontends_import_without_jax():
    """The TensorFlow frontends import with JAX and the reference blocked
    (ml_dtypes allowed: tensorflow needs it)."""
    blocked = tuple(n for n in FORBIDDEN if n != "ml_dtypes") + LAZY_ONLY
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.path.insert(0, {str(REPO)!r})
        for name in {blocked!r}:
            sys.modules[name] = None
        for m in {TF_MODULES!r}:
            importlib.import_module(m)
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in {blocked!r}
                     and sys.modules[m] is not None))
    """)
    out = subprocess.run([sys.executable, "-I", "-B", "-c", code],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(REPO / "tests"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_gpu_entry_points_refuse_to_run_without_a_gpu():
    """init() with no device argument means the GPU: with none visible it
    raises instead of falling back; chip_smoke exits 2 with no result."""
    res = _run_isolated()
    assert res["init_error"] is not None and "device='cpu'" in \
        res["init_error"]
    assert res["smoke_rc"] == 2


def _imports(path: Path, top_level_only: bool = False):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in (tree.body if top_level_only else ast.walk(tree)):
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
    eager = [(str(f.relative_to(REPO)), name) for f in files
             for name in _imports(f, top_level_only=True)
             if name.split(".")[0] in LAZY_ONLY]
    assert eager == []


# the reference's C++ tree, its build's library directory and the library
REFERENCE_NATIVE = ("cpp/hvdtpu", "horovod_tpu/lib", "libhvdtpu.so")


def test_native_engine_builds_from_the_ports_own_sources():
    """No file of the port (nor chip_smoke.py) names the reference's C++
    tree, its library directory or its library, and every source the
    native build compiles, and the build's output, lie in the port."""
    from horovod_tpu_torch.runtime import native_build

    files = sorted(f for f in PKG.rglob("*") if f.is_file()
                   and "_build" not in f.relative_to(PKG).parts
                   and "__pycache__" not in f.relative_to(PKG).parts)
    files.append(REPO / "chip_smoke.py")
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in REFERENCE_NATIVE
           if name in f.read_text(errors="replace")]
    assert bad == []
    srcs = native_build.sources()
    assert {p.name for p in srcs} == {
        "wire.cc", "tcp.cc", "dtype_math.cc", "ops.cc", "response_cache.cc",
        "controller.cc", "timeline.cc", "engine.cc"}
    for path in srcs + [native_build.SOURCE_DIR]:
        assert path.resolve().is_relative_to(PKG), path
    assert native_build.library_path().resolve().is_relative_to(
        PKG / "_build")
