"""The port's native (C++) eager engine (``runtime/native.py`` on the port's
copy of the sources, ``csrc/engine/``, built by ``runtime/native_build.py``)
on CPU gloo worlds, against ``tests/test_native_engine.py``'s expectations
and tolerances (the port's counterpart of that file) and the two native
cases of ``tests/test_multiprocess.py``.

* four ranks (the ring chunks a 1000-element Sum; Adasum's VHDD path; the
  dtype grid, bf16, pre- and postscale, a barrier);
* Adasum at 3 and 6 ranks (extra ranks folded into their partners) against
  ``_numpy_adasum_rows``, the reference's own expectation;
* two ranks: bf16 Adasum moves half fp32's wire bytes; 20 steps of the
  same 5 named averages (the response cache's steady state); the
  timeline, each rank's file and the launcher's merge of them; a result is
  a tensor of the input's dtype on its device, in place too; a 32 MB Sum,
  whose ring halves are past the sockets' buffers;
* the autotuner moves the fusion threshold on both ranks;
* eight ranks through the poll-multiplexed negotiation;
* the build: two processes building at once compile once, a changed
  source gets a new library path, a broken one raises with the compiler's
  message.

Every world starts with ``HVDTPU_EAGER_ENGINE=native``, so ``init()``
starts the engine on every rank.  The file skips where no C++ compiler is
found (``$CXX``, else ``g++``).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import _torch_world
from horovod_tpu.ops.adasum import _numpy_adasum_rows
from horovod_tpu_torch.obs import timeline_merge
from horovod_tpu_torch.runtime import native_build

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def native_lib():
    """The port's library, built once for the module (the worlds' ranks
    then load it), or a skip where no compiler runs."""
    if shutil.which(native_build.compiler()) is None:
        pytest.skip(f"no C++ compiler ({native_build.compiler()!r}; set "
                    "$CXX): the native engine cannot be built here")
    return native_build.build()


def _world(native_lib, fn, args=(), world=2, timeout=90, **env):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HVDTPU_EAGER_ENGINE", "native")
        mp.setenv("HVDTPU_CYCLE_TIME", "2")
        for k, v in env.items():
            mp.setenv(k, v)
        return _torch_world.run_world(fn, args, world=world,
                                      timeout=timeout)


# ------------------------------------------------------------ four ranks


@pytest.fixture(scope="module")
def four(native_lib):
    return _world(native_lib, _torch_world.native_four_worker, world=4)


def test_four_rank_sum_scale_and_barrier(four):
    expect = np.sum([r["big_local"] for r in four], axis=0)
    for r in four:
        assert r["started_at_init"] and r["engine"] == "NativeEngine"
        np.testing.assert_allclose(r["big_sum"], expect, rtol=1e-5)
        assert r["scaled"] == [40.0, 40.0, 40.0]  # (2 * 0.5) * 4 ranks * 10
        assert r["barrier"] is True


@pytest.mark.parametrize("dtype", ["float64", "int32", "int64", "uint8"])
def test_four_rank_dtype_grid(four, dtype):
    want = ((np.arange(6) % 5)[None, :] + np.arange(4)[:, None]).sum(0)
    for r in four:
        assert r[f"sum_{dtype}"].dtype == np.dtype(dtype)
        np.testing.assert_array_equal(r[f"sum_{dtype}"], want)


def test_four_rank_bf16_sum(four):
    for r in four:
        np.testing.assert_allclose(r["sum_bf16"], [6.0, 10.0, -12.0],
                                   rtol=0.05)


def test_four_rank_adasum_vhdd(four):
    want = _numpy_adasum_rows([r["ada_local"].astype(np.float64)
                               for r in four])
    for r in four:
        np.testing.assert_allclose(r["ada"].astype(np.float64), want,
                                   rtol=1e-4, atol=1e-5)


# ------------------------------------------------- Adasum off powers of two


@pytest.mark.parametrize("world,n,tol", [(3, 0, (1e-4, 1e-5)),
                                         (6, 257, (1e-3, 1e-4))])
def test_adasum_folds_extra_ranks(native_lib, world, n, tol):
    """3 ranks: the pow-2 pair plus one folded extra; 6 ranks: {0..3} plus
    two, on an odd length (uneven VHDD halves)."""
    res = _world(native_lib, _torch_world.native_adasum_worker, (n,),
                 world=world)
    want = _numpy_adasum_rows([r["v"].astype(np.float64) for r in res])
    for r in res:
        np.testing.assert_allclose(r["out"].astype(np.float64), want,
                                   rtol=tol[0], atol=tol[1])


# ------------------------------------------------------------- two ranks


@pytest.fixture(scope="module")
def pair(native_lib, tmp_path_factory):
    raw = str(tmp_path_factory.mktemp("timeline") / "timeline.json")
    res = _world(native_lib, _torch_world.native_pair_worker,
                 HVDTPU_TIMELINE=raw)
    return res, raw


def test_bf16_adasum_halves_the_wire_bytes(pair):
    """bf16 payloads ride the wire at 2 bytes an element (the engine's
    bytes counter is dtype-aware), accumulated in fp32 / fp64 registers."""
    for r in pair[0]:
        assert r["bf16_bytes"] * 2 == r["f32_bytes"] > 0, r
        np.testing.assert_allclose(r["out16"], r["out32"], rtol=0.05,
                                   atol=0.05)


def test_response_cache_steady_state(pair):
    # the average over ranks 0, 1 of (step + r + k): step + 0.5 + k
    want = [float(sum(8 * (step + 0.5 + k) for k in range(5)))
            for step in range(20)]
    for r in pair[0]:
        np.testing.assert_allclose(r["totals"], want, rtol=1e-6)
        assert r["stats"]["responses"] >= 20
        assert r["stats"]["cycles"] > 0


def test_timeline_written_and_merged(pair):
    """Each rank writes its own file (rank 0's holds the negotiation, as
    the reference's test reads it); the launcher's merge puts both ranks'
    lanes in one valid trace."""
    _, raw = pair
    with open(raw.replace(".json", ".rank.0.json")) as f:
        events = json.load(f)
    cats = {e.get("cat") for e in events}
    assert {"NEGOTIATE_ALLREDUCE", "ALLREDUCE"} <= cats
    with open(raw.replace(".json", ".rank.1.json")) as f:
        assert "ALLREDUCE" in {e.get("cat") for e in json.load(f)}
    assert timeline_merge.merge_glob(raw) == raw
    with open(raw) as f:
        merged = json.load(f)
    assert {e["pid"] for e in merged if e.get("cat") == "ALLREDUCE"} == \
        {0, 1}


def test_results_are_tensors_on_the_inputs_device(pair):
    """The counterpart of ``test_native_engine_returns_device_arrays``:
    the result is a tensor of the input's dtype on the input's device, and
    the in-place spelling writes its argument."""
    for r in pair[0]:
        assert r["is_tensor"] and r["device"] == "cpu"
        assert r["dtype"] == "torch.float32"
        assert r["sum"] == [3.0] * 4
        assert r["inplace_is_arg"] and r["inplace"] == [[3.0, 3.0]] * 2


def test_a_payload_past_the_socket_buffers(pair):
    """A 32 MB Sum: each rank sends and receives a 16 MB ring half at
    once, more than a socket buffer holds, so a send that blocked until
    the peer read would deadlock both ranks."""
    for r in pair[0]:
        assert r["big"] == (1 << 23, True)


# -------------------------------------------------------------- autotune


def test_native_autotune_moves_params(native_lib):
    """Under ``HVDTPU_AUTOTUNE=1`` rank 0 tunes; the moved fusion threshold
    rides the negotiation to every rank (reference
    parameter_manager.cc:528, controller.cc:33-47)."""
    res = _world(native_lib, _torch_world.native_autotune_worker,
                 HVDTPU_AUTOTUNE="1",
                 HVDTPU_FUSION_THRESHOLD=str(3 * 1024 * 1024),
                 HVDTPU_AUTOTUNE_WARMUP_SAMPLES="1",
                 HVDTPU_AUTOTUNE_STEPS_PER_SAMPLE="2")
    for r in res:
        assert r["initial"] == 3 * 1024 * 1024
        assert r["perf_bytes"] > 0, r
        assert r["fusion"] != r["initial"], r


# ------------------------------------------------------------ eight ranks


def test_np8_poll_multiplexed_negotiation(native_lib):
    """Seven workers feed the rank-0 coordinator; 20 rounds of 256 KB a
    rank complete, right, well inside the bound (a coordinator draining
    workers one at a time would stall senders behind full buffers)."""
    res = _world(native_lib, _torch_world.native_np8_worker, world=8,
                 timeout=150)
    assert all(r["ok"] for r in res)
    assert max(r["elapsed"] for r in res) < 60, res


# ---------------------------------------------------------------- build


def _copy_sources(tmp_path) -> Path:
    src = tmp_path / "src"
    shutil.copytree(native_build.SOURCE_DIR, src)
    return src


def test_two_processes_building_at_once_compile_once(native_lib, tmp_path):
    """Both get the one library; the compiler ran once per source and
    linked once (a ``$CXX`` that logs each call), and the build directory
    holds only the library and the lock."""
    src, root, log = _copy_sources(tmp_path), tmp_path / "build", \
        tmp_path / "cxx.log"
    cxx = tmp_path / "cxx"
    cxx.write_text(f"#!/bin/sh\necho \"$@\" >> {log}\n"
                   f"exec {native_build.compiler()} \"$@\"\n")
    cxx.chmod(0o755)
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        from pathlib import Path
        from horovod_tpu_torch.runtime import native_build
        print(native_build.build(Path({str(src)!r}), Path({str(root)!r})))
    """)
    env = {**os.environ, "CXX": str(cxx)}
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0] == outs[1]
    lib = Path(outs[0])
    assert lib.exists() and lib.parent.parent == root
    assert sorted(p.name for p in lib.parent.iterdir()) == \
        sorted([native_build.LIB_NAME, "lock"])
    calls = log.read_text().splitlines()
    assert len(calls) == len(native_build.sources(src)) + 1, calls


def test_a_changed_source_gets_a_new_library(native_lib, tmp_path):
    src, root = _copy_sources(tmp_path), tmp_path / "build"
    first = native_build.library_path(src, root)
    assert native_build.library_path(src, root) == first
    with open(src / "wire.cc", "a") as f:
        f.write("\n// changed\n")
    second = native_build.library_path(src, root)
    assert second != first
    with open(src / "common.h", "a") as f:
        f.write("\n// changed\n")
    assert native_build.library_path(src, root) not in (first, second)
    assert native_build.library_path() == native_lib
    assert native_build.built()


def test_a_broken_source_raises_with_the_compilers_message(native_lib,
                                                          tmp_path):
    src, root = _copy_sources(tmp_path), tmp_path / "build"
    with open(src / "ops.cc", "a") as f:
        f.write("\nint broken( {\n")
    with pytest.raises(native_build.NativeBuildError) as err:
        native_build.build(src, root)
    assert "ops.cc" in str(err.value) and "error" in str(err.value)
    assert not native_build.built(src, root)
