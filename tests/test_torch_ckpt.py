"""The port's checkpoint tiers (``horovod_tpu_torch.ckpt``) against the
JAX package's (``horovod_tpu.ckpt``).

* The sharded format ``hvdtpu-sharded-ckpt-v1`` is one format: an fp32
  and int tree written by ``horovod_tpu.ckpt.sharded.save_sharded``
  restores in the port with a target bit for bit, and the port's fp32
  save restores in the JAX package; the shard assignment is the same
  table.  The port's cases of ``test_ckpt.py``: a corrupt shard falls
  back to the previous step, an uncommitted step is invisible, N -> M
  resharding, a failed re-save never destroys a durable step; and the
  port's own: restore without a target from the manifest's structure, a
  bfloat16 tensor as its raw words.
* The replica tier over the signed KV store: push/fetch, a corrupt chunk
  or another job's replica rejected, superseded chunks collected, the
  ``drop_replica`` fault.
* ``elastic.State`` routed through both tiers: peer, then disk, then none,
  with the newer of replica and disk winning.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest
import torch

import horovod_tpu.ckpt as j_ckpt
from horovod_tpu_torch import ckpt
from horovod_tpu_torch.ckpt.replica import SCOPE as REP_SCOPE, ReplicaTier
from horovod_tpu_torch.ckpt.sharded import (
    ShardCorruptError,
    shard_assignment,
    step_dir,
    write_shard,
)
from horovod_tpu_torch.elastic.context import LocalContext
from horovod_tpu_torch.elastic.state import State, dumps_snapshot
from horovod_tpu_torch.run.rendezvous import KVStoreClient, KVStoreServer
from horovod_tpu_torch.testing import faults


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in (faults.SPEC_ENV, "HVDTPU_CKPT_REPLICA", "HVDTPU_CKPT_DIR"):
        monkeypatch.delenv(name, raising=False)
    faults.reset()
    yield
    faults.reset()


def _np_state(seed=0):
    """The JAX tests' tree: fp32 and fp64 arrays, numpy int scalars."""
    rng = np.random.RandomState(seed)
    return {
        "params": {"w": rng.randn(4, 3).astype(np.float32),
                   "b": rng.randn(3).astype(np.float32)},
        "opt": [rng.randn(2).astype(np.float64), np.int32(seed)],
        "step": np.int64(7 + seed),
    }


def _torch_state(seed=0):
    """The same tree with torch tensors for the arrays."""
    s = _np_state(seed)
    return {"params": {k: torch.from_numpy(v)
                       for k, v in s["params"].items()},
            "opt": [torch.from_numpy(s["opt"][0]), s["opt"][1]],
            "step": s["step"]}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    return np.asarray(x)


def _assert_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = _np(x), _np(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _save_world(mod, directory, state, step, world):
    """``world`` writers: every rank's async save first (rank 0 waits for
    the others' sidecars), then commit them all."""
    handles = [mod.save_sharded_async(directory, state, step, rank=r,
                                      world_size=world)
               for r in range(world)]
    for h in handles:
        h.wait()


@pytest.mark.parametrize("n,world", [(5, 2), (3, 4), (0, 1), (17, 3)])
def test_shard_assignment_matches_the_reference(n, world):
    assert shard_assignment(n, world) == \
        j_ckpt.sharded.shard_assignment(n, world)


@pytest.mark.parametrize("world", [1, 3])
def test_jax_checkpoint_restores_in_the_port(tmp_path, world):
    d = str(tmp_path)
    _save_world(j_ckpt, d, _np_state(), 4, world)
    out = ckpt.restore_sharded(d, target=_torch_state(9))
    assert isinstance(out["params"]["w"], torch.Tensor)
    assert isinstance(out["opt"][1], np.int32)
    _assert_equal(out, _np_state())


@pytest.mark.parametrize("world", [1, 2])
def test_port_checkpoint_restores_in_the_jax_package(tmp_path, world):
    d = str(tmp_path)
    _save_world(ckpt, d, _torch_state(), 3, world)
    manifest = ckpt.load_manifest(d, 3)
    assert manifest["schema"] == ckpt.SCHEMA == j_ckpt.SCHEMA
    assert manifest == j_ckpt.load_manifest(d, 3)
    assert j_ckpt.list_steps(d) == ckpt.list_steps(d) == [3]
    _assert_equal(j_ckpt.restore_sharded(d, target=_np_state(5)),
                  _np_state())


def test_restore_without_a_target_uses_the_manifest_structure(tmp_path):
    d = str(tmp_path)
    state = {**_torch_state(), "bf16": torch.randn(5).to(torch.bfloat16),
             "meta": (1, 2.5, True, None, "tag")}
    _save_world(ckpt, d, state, 1, 2)
    out = ckpt.restore_sharded(d)
    assert out["bf16"].dtype == torch.bfloat16
    assert torch.equal(out["bf16"], state["bf16"])
    assert out["meta"] == (1, 2.5, True, None, "tag")
    spec = ckpt.load_manifest(d, 1)["leaves"]
    assert {"bfloat16"} <= {s["dtype"] for s in spec}
    _assert_equal(out, state)


def test_corrupt_shard_rejected_and_falls_back(tmp_path, monkeypatch):
    d = str(tmp_path)
    good, bad = _torch_state(0), _torch_state(1)
    ckpt.save_sharded(d, good, 1, rank=0, world_size=1)
    monkeypatch.setenv(faults.SPEC_ENV, "shard_write:action=corrupt_write")
    faults.reset()
    ckpt.save_sharded(d, bad, 2, rank=0, world_size=1)
    monkeypatch.delenv(faults.SPEC_ENV)
    faults.reset()
    assert ckpt.list_steps(d) == [1, 2]
    with pytest.raises(ShardCorruptError, match="checksum"):
        ckpt.restore_sharded(d, target=_torch_state(5), step=2)
    _assert_equal(ckpt.restore_sharded(d, target=_torch_state(5)), good)
    # the JAX package rejects the same torn shard
    with pytest.raises(j_ckpt.ShardCorruptError):
        j_ckpt.restore_sharded(d, target=_np_state(5), step=2)


def test_uncommitted_step_is_invisible(tmp_path):
    d = str(tmp_path)
    ckpt.save_sharded(d, _torch_state(), 1, rank=0, world_size=1)
    write_shard(d, 2, 0, 1, {0: np.ones(3, np.float32)})  # no manifest
    assert os.path.isdir(step_dir(d, 2))
    assert ckpt.latest_step(d) == 1 == j_ckpt.latest_step(d)


def test_reshard_n_to_m_roundtrips_bitwise(tmp_path):
    d = str(tmp_path)
    state = _torch_state()
    _save_world(ckpt, d, state, 1, 4)
    restored = ckpt.restore_sharded(d, target=_torch_state(3))
    _assert_equal(restored, state)
    _save_world(ckpt, d, restored, 2, 2)
    assert ckpt.load_manifest(d, 2)["world_size"] == 2
    _assert_equal(ckpt.restore_sharded(d, target=_torch_state(3)), state)


def test_failed_resave_never_destroys_a_durable_step(tmp_path):
    d = str(tmp_path)
    ckpt.save_sharded(d, {"w": torch.zeros(4)}, 1, rank=0, world_size=1)
    h = ckpt.save_sharded_async(d, {"w": torch.full((4,), 9.0)}, 1, rank=1,
                                world_size=2, commit_timeout=0.4)
    with pytest.raises((TimeoutError, RuntimeError)):
        h.wait()
    out = ckpt.restore_sharded(d, target={"w": torch.zeros(4)}, step=1)
    assert out["w"].tolist() == [0.0] * 4
    assert not glob.glob(os.path.join(d, "**", "*.tmp.*"), recursive=True)


def test_async_save_snapshots_before_mutation(tmp_path):
    d = str(tmp_path)
    w = torch.arange(8, dtype=torch.float64)
    h = ckpt.save_sharded_async(d, {"w": w}, 1, rank=0, world_size=1)
    w -= 100.0  # mutate at once, racing the writer thread
    h.wait()
    out = ckpt.restore_sharded(d, target={"w": torch.zeros(8,
                                                           dtype=torch.float64)})
    assert out["w"].tolist() == list(range(8))


def test_structure_mismatch_raises(tmp_path):
    d = str(tmp_path)
    ckpt.save_sharded(d, {"a": torch.zeros(4, 3), "b": np.zeros(3, np.int64)},
                      1, rank=0, world_size=1)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_sharded(d, target={"a": torch.zeros(2, 2),
                                        "b": np.zeros(3, np.int64)})
    with pytest.raises(ValueError, match="dtype"):
        ckpt.restore_sharded(d, target={"a": torch.zeros(4, 3,
                                                         dtype=torch.float64),
                                        "b": np.zeros(3, np.int64)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_sharded(d, target={"only": torch.ones(2)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore_sharded(str(tmp_path / "empty"))


class _Opens:
    """Unpickling this would create the file at ``path``."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


def test_loading_a_shard_runs_no_code(tmp_path):
    """A shard is read back with the restricted loader: numpy arrays and
    containers load, any other global is refused before it runs, even
    under a manifest whose checksum matches."""
    import json
    import pickle

    from horovod_tpu_torch.ckpt import tree

    arrays = {0: np.arange(3, dtype=np.float32), 1: np.int64(5),
              2: np.zeros((2, 0)), 3: np.array("abc")}
    got = tree.safe_loads(pickle.dumps(arrays, protocol=5))
    assert got.keys() == arrays.keys()
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
    marker = tmp_path / "ran"
    d = str(tmp_path / "ckpt")
    ckpt.save_sharded(d, {"w": torch.zeros(4)}, 1, rank=0, world_size=1)
    payload = pickle.dumps({0: _Opens(str(marker))})
    manifest = ckpt.load_manifest(d, 1)
    shard = manifest["shards"][0]
    with open(os.path.join(step_dir(d, 1), shard["file"]), "wb") as f:
        f.write(payload)
    shard["checksum"] = __import__("hashlib").sha256(payload).hexdigest()
    with open(os.path.join(step_dir(d, 1), "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        ckpt.restore_sharded(d, target={"w": torch.zeros(4)}, step=1)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tree.loads(pickle.dumps(({"t": "float"}, ["float64"],
                                 [_Opens(str(marker))])))
    assert not marker.exists()


# ---------------------------------------------------------------------------
# replica tier
# ---------------------------------------------------------------------------


@pytest.fixture()
def kv_server():
    server = KVStoreServer()
    server.start()
    try:
        yield server, KVStoreClient(f"127.0.0.1:{server.port}",
                                    server.secret)
    finally:
        server.stop()


def test_replica_push_fetch_gc_and_corruption(kv_server):
    server, kv = kv_server
    tier = ReplicaTier(kv, 0, [0, 1, 2], chunk_bytes=8)
    payload = b"0123456789" * 5
    assert tier.push(payload, step=4, commits=4)
    got, meta = tier.fetch(0)
    assert got == payload and meta["chunks"] == 7 and meta["holder"] == 1
    assert tier.push(b"new-payload!", step=5)
    assert not server.scan(f"{REP_SCOPE}/o0.s4.")  # superseded chunks gone
    assert tier.fetch(0)[0] == b"new-payload!"
    kv.put(REP_SCOPE, "o0.s5.c0", b"garbage")
    assert tier.fetch(0) is None  # checksum mismatch: fall back
    other_job = ReplicaTier(kv, 0, [0], chunk_bytes=64)
    assert other_job.push(b"job-one", step=9)
    other_job.job_id = "0123456789abcdef"
    assert other_job.fetch(0) is None


def test_drop_replica_fault_suppresses_one_push(kv_server, monkeypatch):
    server, kv = kv_server
    monkeypatch.setenv(faults.SPEC_ENV, "replica_push:action=drop_replica")
    faults.reset()
    tier = ReplicaTier(kv, 0, [0, 1], chunk_bytes=64)
    assert tier.push(b"dropped", step=1) is False
    assert tier.fetch(0) is None
    assert tier.push(b"kept", step=2) is True
    assert tier.fetch(0)[0] == b"kept"


def test_replica_payload_is_the_snapshot_pickle(kv_server):
    """What a commit pushes is ``dumps_snapshot``'s bytes: a bf16 tensor
    travels as raw words and comes back bf16."""
    server, kv = kv_server
    st = State(w=torch.randn(3).to(torch.bfloat16), step=0)
    st._replica_tier = ReplicaTier(kv, 0, [0], chunk_bytes=16)
    st.step = 2
    st.commit()
    got, meta = ReplicaTier(kv, 0, [0]).fetch(0)
    assert got == dumps_snapshot(st._snapshot, 1)
    assert meta["commits"] == 1


# ---------------------------------------------------------------------------
# elastic.State through the tiers
# ---------------------------------------------------------------------------


def test_fresh_sync_adopts_the_peer_replica(kv_server):
    server, kv = kv_server
    st = State(w=torch.zeros(3), step=0)
    st._replica_tier = ReplicaTier(kv, 0, [0], chunk_bytes=64)
    st.w.add_(5.0)
    st.step = 3
    st.commit()
    w2 = torch.zeros(3)
    st2 = State(w=w2, step=0)
    st2._replica_tier = ReplicaTier(kv, 0, [0], chunk_bytes=64)
    st2.sync(LocalContext())
    assert st2.step == 3 and st2.w is w2 and w2.tolist() == [5.0] * 3
    assert st2.last_restore["source"] == "peer"
    assert st2.last_restore["replica_adopted"] is True
    assert st2.last_restore["commits"] == 1


def test_disk_fallback_and_stale_replica(tmp_path, kv_server):
    server, kv = kv_server
    d = str(tmp_path)
    st = State(w=torch.zeros(3), step=0)
    st._replica_tier = ReplicaTier(kv, 0, [0], chunk_bytes=64)
    st._ckpt_dir = d
    st.step = 1
    st.commit()  # replica at commit 1
    st._replica_tier = False  # later pushes "dropped"
    st.step = 2
    st.commit()
    st.step = 3
    st.w.fill_(3.0)
    st.commit()  # commits 3, replica still at 1
    st.save_sharded(ctx=LocalContext()).wait()
    st2 = State(w=torch.zeros(3), step=0)
    st2._replica_tier = ReplicaTier(kv, 0, [0], chunk_bytes=64)
    st2._ckpt_dir = d
    st2.sync(LocalContext())
    assert st2.step == 3 and st2.w.tolist() == [3.0] * 3
    assert st2.last_restore["source"] == "disk"
    assert st2.last_restore["replica_adopted"] is False
    st3 = State(w=torch.zeros(3), step=0)  # no replica tier at all
    st3._replica_tier = False
    st3._ckpt_dir = d
    st3.sync(LocalContext())
    assert st3.step == 3 and st3.last_restore["source"] == "disk"


def test_provenance_none_on_a_fresh_start():
    st = State(w=torch.zeros(2))
    st._replica_tier = False
    st.sync(LocalContext())
    assert st.last_restore["source"] == "none"
    assert st.last_restore["commits"] == 0
