"""The port's top level against the reference's: every name
``horovod_tpu/__init__.py`` exports, or resolves in its ``__getattr__``,
is either present in ``horovod_tpu_torch`` or in its ``NOT_PORTED`` table
with the ROADMAP item that will port it; reading a name of the table
raises ``NotPortedError`` naming that item.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

import horovod_tpu_torch as hvd

REPO = Path(__file__).resolve().parent.parent
REFERENCE_INIT = REPO / "horovod_tpu" / "__init__.py"


def _reference_names() -> list:
    """The names the reference's top level imports, and the string
    constants its ``__getattr__`` compares a name against."""
    tree = ast.parse(REFERENCE_INIT.read_text())
    names = {"__version__"}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        if isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Compare) and isinstance(
                        sub.left, ast.Name) and sub.left.id == "name":
                    for comp in sub.comparators:
                        for c in ast.walk(comp):
                            if isinstance(c, ast.Constant) and isinstance(
                                    c.value, str):
                                names.add(c.value)
    return sorted(names)


REFERENCE_NAMES = _reference_names()


def test_the_reference_surface_was_read():
    assert len(REFERENCE_NAMES) > 70
    assert {"allreduce_", "SyncBatchNorm", "join", "mesh",
            "IndexedSlices", "callbacks"} <= set(REFERENCE_NAMES)


@pytest.mark.parametrize("name", REFERENCE_NAMES)
def test_every_reference_name_is_ported_or_tabled(name):
    if name in hvd.NOT_PORTED:
        item, _ = hvd.NOT_PORTED[name]
        assert not hasattr(hvd, name)
        with pytest.raises(hvd.NotPortedError, match=f"ROADMAP {item}"):
            getattr(hvd, name)
        with pytest.raises(NotImplementedError, match=name):
            getattr(hvd, name)
    else:
        assert getattr(hvd, name) is not None


A9_NAMES = ("allreduce_async", "allreduce_async_", "allgather_async",
            "broadcast_async", "broadcast_async_", "synchronize", "poll",
            "join")


def test_the_eager_names_are_ported():
    """ROADMAP A9: the eager engine's names are the port's own, from
    ``ops.eager``, and none of them is in the table any more."""
    from horovod_tpu_torch.ops import eager

    for name in A9_NAMES:
        assert name not in hvd.NOT_PORTED
        assert getattr(hvd, name) is getattr(eager, name)
    assert not any(item == "A9" for item, _ in hvd.NOT_PORTED.values())


A10_NAMES = ("Store", "LocalStore", "save_checkpoint",
             "save_checkpoint_async", "restore_checkpoint",
             "latest_checkpoint_step")


def test_the_checkpoint_names_are_ported():
    """ROADMAP A10: the checkpoint names are the port's own, from
    ``checkpoint``, ``callbacks`` is the port's module, and none of them
    is in the table any more."""
    from horovod_tpu_torch import callbacks, checkpoint

    for name in A10_NAMES:
        assert name not in hvd.NOT_PORTED
        assert getattr(hvd, name) is getattr(checkpoint, name)
    assert hvd.callbacks is callbacks
    assert not any(item == "A10" for item, _ in hvd.NOT_PORTED.values())


def test_the_table_holds_only_reference_names():
    assert set(hvd.NOT_PORTED) <= set(REFERENCE_NAMES)


def test_unknown_names_are_plain_attribute_errors():
    with pytest.raises(AttributeError) as info:
        hvd.no_such_name  # noqa: B018
    assert not isinstance(info.value, NotImplementedError)


def test_feature_probes_answer_for_the_ports_transports():
    from horovod_tpu_torch.runtime import native_build

    assert hvd.xla_collectives_built() is False
    # the native engine's library, built for the port's current sources
    assert hvd.native_engine_built() is native_build.library_path().exists()
    assert hvd.mpi_built() is hvd.mpi_enabled() is False
    assert hvd.mpi_threads_supported() is False
    assert hvd.gloo_built() is torch.distributed.is_gloo_available()
    assert hvd.gloo_enabled() is hvd.gloo_built()
    assert hvd.nccl_built() is torch.distributed.is_nccl_available()
    assert hvd.ccl_built() is hvd.ddl_built() is False


def test_axis_names_are_the_references():
    import horovod_tpu as jhvd

    for name in ("DP_AXIS", "CROSS_AXIS", "LOCAL_AXIS", "SLICE_AXIS"):
        assert getattr(hvd, name) == getattr(jhvd, name)


@pytest.mark.parametrize("env,world,rank,want", [
    ({}, 4, 3, (1, 0)),
    ({"HVDTPU_NUM_SLICES": "2"}, 4, 3, (2, 1)),
    ({"HVDTPU_SLICE_SIZE": "2"}, 4, 1, (2, 0)),
    ({"HVDTPU_NUM_SLICES": "2", "HVDTPU_SLICE_SIZE": "1"}, 4, 2, (2, 1)),
    ({"HVDTPU_NUM_SLICES": "3"}, 4, 3, (1, 0)),
    ({"HVDTPU_SLICE_SIZE": "3"}, 4, 3, (1, 0)),
    ({"HVDTPU_NUM_SLICES": "x"}, 4, 3, (1, 0)),
    ({"HVDTPU_NUM_SLICES": "2"}, 1, 0, (1, 0)),
])
def test_slice_partition_matches_the_reference(env, world, rank, want):
    """The forced partition of the reference's ``resolve_slice_partition``
    on a world of processes (one device each)."""
    from horovod_tpu.basics import resolve_slice_partition as jax_resolve
    from horovod_tpu_torch.basics import resolve_slice_partition

    assert resolve_slice_partition(world, rank, env) == want
    assert jax_resolve(world, rank, [object()] * world, env) == want


def test_the_serving_and_run_names_exist_under_the_references_names():
    """A12b and item 1b: ``ServeJob``, ``run`` and ``publish_weights`` (and
    the rest of the reference's serving exports) are the port's own."""
    import horovod_tpu.run as jrun
    import horovod_tpu.serve as jserve
    import horovod_tpu_torch.run as trun
    import horovod_tpu_torch.serve as tserve

    assert callable(trun.run) and trun.run.__module__ == \
        "horovod_tpu_torch.run.api"
    assert callable(jrun.run)
    for name in ("ServeJob", "ServeClient", "FrontDoor", "IngestPump",
                 "validate_request", "Rejection", "RequestRejected",
                 "publish_weights", "SwapManager", "serve_worker",
                 "DEFAULT_SPEC", "SlotEngine", "SlotScheduler"):
        assert hasattr(jserve, name), name
        assert getattr(tserve, name) is not None, name
        obj = getattr(tserve, name)
        if hasattr(obj, "__module__"):
            assert obj.__module__.startswith("horovod_tpu_torch."), name


@pytest.mark.parametrize("flags,item", [
    (["--serve-autoscale"], "A13b"),
    (["--scale-up-queue", "4"], "A13b"),
])
def test_hvdrun_serving_refusals_name_their_item(flags, item):
    """The autoscale flags, refused until ROADMAP ``item`` ported them,
    parse as the reference's do."""
    from horovod_tpu.run import runner as j_runner
    from horovod_tpu_torch.run import runner

    argv = ["-np", "2", "--serve", *flags, "python", "x"]
    port, ref = runner.parse_args(argv), j_runner.parse_args(argv)
    attr = flags[0][2:].replace("-", "_")
    assert getattr(port, attr) == getattr(ref, attr) is not None


def _parallel_names():
    import horovod_tpu.parallel as jparallel

    return sorted(n for n in getattr(jparallel, "__all__", dir(jparallel))
                  if not n.startswith("_")
                  and not isinstance(getattr(jparallel, n), type(jparallel)))


PARALLEL_NAMES = _parallel_names()


def test_the_parallel_names_were_read():
    """The reference's ``horovod_tpu.parallel`` exports 28 names (its
    function ``ring_attention`` shadows the module of that name)."""
    assert len(PARALLEL_NAMES) == 28, PARALLEL_NAMES
    assert "ring_attention" in PARALLEL_NAMES


@pytest.mark.parametrize("name", PARALLEL_NAMES)
def test_the_parallel_names_are_ported(name):
    """ROADMAP A11: every name of ``horovod_tpu.parallel`` is the port's
    own, from ``horovod_tpu_torch``."""
    import horovod_tpu_torch.parallel as tparallel

    obj = getattr(tparallel, name)
    assert obj.__module__.startswith("horovod_tpu_torch."), name


def test_no_port_error_names_a11():
    """After A11 no ``NotPortedError`` or ``NotImplementedError`` the port
    raises names it, and no table of what is not ported lists it."""
    import ast
    from pathlib import Path

    import horovod_tpu_torch

    root = Path(horovod_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        text = path.read_text()
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Raise) and node.exc is not None:
                raised = ast.get_source_segment(text, node)
                if "NotPorted" in raised or "NotImplemented" in raised:
                    assert "A11" not in raised, (path, node.lineno)
    assert all(item != "A11" for item, _ in hvd.NOT_PORTED.values())


def test_not_ported_holds_only_a14():
    """After A14 the table is empty: the reference's SPMD names (``mesh``,
    ``distribute``, ``DistributedGradientTransform``, ``sync_gradients``)
    resolve to the port's own, and the estimator frontend is the port's
    own too."""
    assert hvd.NOT_PORTED == {}
    from horovod_tpu_torch import basics, optim
    from horovod_tpu_torch.optim import overlap

    assert hvd.mesh is basics.mesh
    assert hvd.distribute is optim.distribute
    assert hvd.DistributedGradientTransform is \
        optim.DistributedGradientTransform
    assert hvd.sync_gradients is overlap.sync_gradients
    for name in ("Estimator", "Model"):
        assert getattr(hvd, name).__module__ == "horovod_tpu_torch.estimator"
