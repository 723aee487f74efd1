"""The port's rank-0 checkpoints and Store (``horovod_tpu_torch.checkpoint``)
and training callbacks (``horovod_tpu_torch.callbacks``), held against the
JAX package's (``horovod_tpu.checkpoint``, ``horovod_tpu.callbacks``) on the
same inputs.

* A world of one: the same sequence of saves (the same state, made from a
  seed with numpy, as torch tensors in the port and as JAX and numpy
  arrays in the JAX package; the same steps and ``keep``) goes through
  both packages, which must leave the same directory listing, report the
  same latest step and restore the same bits; the two Stores give the
  same paths and metadata; a failed async save raises the same error at
  every ``wait()``.
* A 2-rank world in each package: rank 0 writes and every rank restores
  the broadcast state; a failed rank-0 write (``ckpt_write``) raises at
  ``wait()`` on both ranks, with the same messages in both packages.
* The learning-rate schedules against the JAX package's on the same
  steps, within float32 rounding (the JAX schedules compute in float32,
  the port's in Python floats).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_world
import horovod_tpu as jhvd
from horovod_tpu import callbacks as j_callbacks
from horovod_tpu import checkpoint as j_ckpt
from horovod_tpu_torch import callbacks
from horovod_tpu_torch import checkpoint as ckpt


@pytest.fixture(scope="module", autouse=True)
def hvd1():
    import horovod_tpu_torch as hvd

    jhvd.init()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _values(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(4, 3).astype(np.float32), rng.randn(3).astype(np.float32),
            rng.randn(3).astype(np.float32))


def _port_state(seed=0):
    """A model and an optimizer's state dict, as a torch job saves them:
    int keys, a tuple and Python scalars beside the tensors."""
    w, b, mu = _values(seed)
    return {"params": {"w": torch.from_numpy(w),
                       "b": torch.from_numpy(b).to(torch.bfloat16)},
            "opt": {"state": {0: {"step": torch.tensor(float(seed)),
                                  "exp_avg": torch.from_numpy(mu)}},
                    "param_groups": [{"lr": 0.1, "betas": (0.9, 0.99),
                                      "params": [0]}]},
            "step": torch.tensor(7 + seed, dtype=torch.int32)}


def _jax_state(seed=0):
    """:func:`_port_state` for the JAX package: the same values, as JAX
    arrays where the port has tensors."""
    w, b, mu = _values(seed)
    return {"params": {"w": jnp.asarray(w),
                       "b": jnp.asarray(b).astype(jnp.bfloat16)},
            "opt": {"state": {0: {"step": jnp.asarray(float(seed),
                                                      jnp.float32),
                                  "exp_avg": jnp.asarray(mu)}},
                    "param_groups": [{"lr": 0.1, "betas": (0.9, 0.99),
                                      "params": [0]}]},
            "step": jnp.asarray(7 + seed, jnp.int32)}


def _bits(tree, path=""):
    """Every leaf of a tree as ``(path, dtype, shape, bytes)``, dict keys
    sorted, so a torch tree and a JAX tree of the same values compare
    equal.  A Python scalar counts as the numpy array it becomes."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str)
                for x in _bits(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _bits(v, f"{path}/{i}")]
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return [(path, str(t.dtype).replace("torch.", ""), tuple(t.shape),
                 raw.numpy().tobytes())]
    a = np.asarray(tree)
    return [(path, str(a.dtype), a.shape, a.tobytes())]


def _dirs(tmp_path):
    return str(tmp_path / "jax" / "ckpt"), str(tmp_path / "port" / "ckpt")


def _listing(d):
    return sorted(os.listdir(d))


def test_save_restore_roundtrip(tmp_path):
    jd, pd = _dirs(tmp_path)
    j_ckpt.save_checkpoint(jd, _jax_state(), step=7)
    ckpt.save_checkpoint(pd, _port_state(), step=7)
    assert _listing(pd) == _listing(jd) == ["step_0000000007"]
    assert ckpt.latest_checkpoint_step(pd) == \
        j_ckpt.latest_checkpoint_step(jd) == 7
    port = ckpt.restore_checkpoint(pd, _port_state(seed=1))
    ref = j_ckpt.restore_checkpoint(jd, _jax_state(seed=1))
    assert _bits(port) == _bits(ref) == _bits(_port_state())
    # each leaf comes back as its target leaf's kind
    assert isinstance(port["params"]["b"], torch.Tensor)
    assert port["params"]["b"].dtype == torch.bfloat16
    assert port["opt"]["param_groups"][0]["betas"] == (0.9, 0.99)


def test_restore_latest_explicit_and_missing(tmp_path):
    jd, pd = _dirs(tmp_path)
    for s in (1, 5, 3):
        j_ckpt.save_checkpoint(jd, _jax_state(seed=s), step=s)
        ckpt.save_checkpoint(pd, _port_state(seed=s), step=s)
    assert _listing(pd) == _listing(jd)
    assert ckpt.latest_checkpoint_step(pd) == \
        j_ckpt.latest_checkpoint_step(jd) == 5
    for step, seed in ((None, 5), (1, 1), (3, 3)):
        port = ckpt.restore_checkpoint(pd, _port_state(), step=step)
        ref = j_ckpt.restore_checkpoint(jd, _jax_state(), step=step)
        assert _bits(port) == _bits(ref) == _bits(_port_state(seed=seed))
    for restore, target in ((ckpt.restore_checkpoint, _port_state()),
                            (j_ckpt.restore_checkpoint, _jax_state())):
        with pytest.raises(FileNotFoundError):
            restore(str(tmp_path / "none"), target)
    # The port also refuses a target of another shape (the JAX package's
    # orbax restore returns the checkpoint's own leaf there).
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(pd, {**_port_state(), "params": {
            "w": torch.zeros(2, 2), "b": torch.zeros(3, dtype=torch.bfloat16)}})


def test_keep_prunes_and_resave_overwrites(tmp_path):
    jd, pd = _dirs(tmp_path)
    for s in range(5):
        j_ckpt.save_checkpoint(jd, _jax_state(seed=s), step=s, keep=2)
        ckpt.save_checkpoint(pd, _port_state(seed=s), step=s, keep=2)
        assert _listing(pd) == _listing(jd)
    assert _listing(pd) == ["step_0000000003", "step_0000000004"]
    j_ckpt.save_checkpoint(jd, _jax_state(seed=9), step=4)
    ckpt.save_checkpoint(pd, _port_state(seed=9), step=4)
    assert _listing(pd) == _listing(jd)
    port = ckpt.restore_checkpoint(pd, _port_state(), step=4)
    ref = j_ckpt.restore_checkpoint(jd, _jax_state(), step=4)
    assert _bits(port) == _bits(ref) == _bits(_port_state(seed=9))
    for save, state in ((ckpt.save_checkpoint_async, _port_state()),
                        (j_ckpt.save_checkpoint_async, _jax_state())):
        with pytest.raises(ValueError, match="keep"):
            save(pd, state, step=1, keep=0)


def test_step_directory_holds_no_pickle(tmp_path):
    """The port's step directory is JSON and a numpy archive: the
    structure and dtype names beside the leaves, loaded without
    pickle."""
    import json

    d = str(tmp_path / "ckpt")
    path = ckpt.save_checkpoint(d, _port_state(), step=2)
    assert _listing(path) == ["leaves.npz", "structure.json"]
    with open(os.path.join(path, "structure.json")) as f:
        doc = json.load(f)
    with np.load(os.path.join(path, "leaves.npz"), allow_pickle=False) as z:
        assert sorted(z.files, key=int) == [str(i) for i in
                                            range(len(doc["dtypes"]))]
        # bfloat16 is stored as its raw 16-bit words
        b = doc["dtypes"].index("bfloat16")
        assert z[str(b)].dtype == np.uint16
    assert _bits(ckpt.restore_checkpoint(d, _port_state(3))) == \
        _bits(_port_state())


def _store_round(mod, prefix):
    """One script of Store calls; what it observes, with paths relative
    to ``prefix``."""
    store = mod.LocalStore(prefix)
    rel = lambda p: os.path.relpath(p, prefix)  # noqa: E731
    seen = [rel(store.checkpoint_dir("r1")), rel(store.metadata_path("r1")),
            rel(store.logs_dir("r1")), store.read_metadata("r1")]
    store.write_metadata({"epochs": 3, "lr": [0.1, 0.01]}, "r1")
    seen.append(store.read_metadata("r1"))
    p = os.path.join(store.logs_dir("r1"), "x.bin")
    store.makedirs(os.path.dirname(p))
    store.write_bytes(p, b"abc")
    seen += [store.exists(p), store.read_bytes(p)]
    store.write_bytes(p, b"abcd")  # an overwrite replaces the file
    seen.append(store.read_bytes(p))
    store.delete(p)
    seen.append(store.exists(p))
    store.delete(store.logs_dir("r1"))  # a directory goes whole
    seen.append(sorted(os.path.relpath(os.path.join(r, f), prefix)
                       for r, _, fs in os.walk(prefix) for f in fs))
    return seen


def test_local_store_metadata_and_paths(tmp_path):
    port = _store_round(ckpt, str(tmp_path / "port"))
    assert port == _store_round(j_ckpt, str(tmp_path / "jax"))
    assert port[4] == {"epochs": 3, "lr": [0.1, 0.01]}


def test_async_save_snapshots_and_retains(tmp_path):
    jd, pd = _dirs(tmp_path)
    j_ckpt.save_checkpoint(jd, _jax_state(seed=1), step=1)
    ckpt.save_checkpoint(pd, _port_state(seed=1), step=1)
    j_handle = j_ckpt.save_checkpoint_async(jd, _jax_state(), step=2, keep=1)
    state = _port_state()
    handle = ckpt.save_checkpoint_async(pd, state, step=2, keep=1)
    state["params"]["w"].mul_(100)  # the port's save took a snapshot
    assert os.path.relpath(handle.wait(), pd) == \
        os.path.relpath(j_handle.wait(), jd) == "step_0000000002"
    assert handle.wait() == handle.path  # repeat wait is idempotent
    assert j_handle.wait() == j_handle.path
    assert _listing(pd) == _listing(jd) == ["step_0000000002"]
    port = ckpt.restore_checkpoint(pd, _port_state(1))
    ref = j_ckpt.restore_checkpoint(jd, _jax_state(1))
    assert _bits(port) == _bits(ref) == _bits(_port_state())


def test_async_save_failure_raises_at_every_wait(tmp_path):
    raised = {}
    for name, mod, state in (("port", ckpt, _port_state()),
                             ("jax", j_ckpt, _jax_state())):
        blocker = tmp_path / f"file_{name}"
        blocker.write_text("x")
        handle = mod.save_checkpoint_async(str(blocker / "ckpt"), state,
                                           step=1)
        raised[name] = []
        for _ in range(2):
            with pytest.raises(OSError) as info:
                handle.wait()
            raised[name].append(type(info.value))
    assert raised["port"] == raised["jax"]


def _jax_checkpoint_worker(directory, fault):
    """:func:`_torch_world.checkpoint_worker` in the JAX package: the same
    saves, restore and failing async save in a 2-rank world."""
    import os

    import numpy as np

    import horovod_tpu as hvd
    from horovod_tpu.testing import faults

    hvd.init()
    r = hvd.rank()
    state = {"w": np.arange(4, dtype=np.float32) * (r + 1),
             "step": np.int32(3)}
    hvd.save_checkpoint(directory, state, 3)
    out = hvd.restore_checkpoint(directory, {"w": np.zeros(4, np.float32),
                                             "step": np.int32(0)})
    os.environ[faults.SPEC_ENV] = fault
    faults.reset()
    handle = hvd.save_checkpoint_async(directory, state, 5)
    try:
        handle.wait()
        raised, msg = False, ""
    except Exception as exc:  # noqa: BLE001 - the contract under test
        raised, msg = True, str(exc)
    res = {"rank": r, "restored": np.asarray(out["w"]).tolist(),
           "step": int(np.asarray(out["step"])), "raised": raised,
           "msg": msg, "latest": hvd.latest_checkpoint_step(directory)}
    hvd.shutdown()
    return res


def test_two_ranks_restore_the_broadcast_and_share_a_failed_save(tmp_path):
    import horovod_tpu.run as j_run

    fault = "ckpt_write:step=5:rank=0"
    jd, pd = _dirs(tmp_path)
    port = _torch_world.run_world(_torch_world.checkpoint_worker,
                                  (pd, fault), world=2, timeout=120)
    ref = sorted(j_run.run(_jax_checkpoint_worker, args=(jd, fault), np=2,
                           use_cpu=True, timeout=180),
                 key=lambda out: out["rank"])
    for r, (out, want) in enumerate(zip(port, ref)):
        assert out["avg"] == 0.5 and out["synced"] == [0.0, 0.0]
        for key in ("restored", "step", "raised", "latest"):
            assert out[key] == want[key], (r, key)
        assert out["msg"].replace(pd, "<D>") == want["msg"].replace(jd, "<D>")
    assert port[0]["restored"] == [0.0, 1.0, 2.0, 3.0]
    assert port[0]["latest"] == 3  # the failed step never appeared
    assert port[0]["raised"] and port[1]["raised"]
    assert "injected fault at 'ckpt_write'" in port[0]["msg"]
    assert "failed on rank 0" in port[1]["msg"]


@pytest.mark.parametrize("kw", [
    {"steps_per_epoch": 10, "scale": 4.0},
    {"steps_per_epoch": 3, "warmup_epochs": 2.5, "scale": 8.0},
    {"steps_per_epoch": 7},
])
def test_warmup_schedule_matches_the_reference(kw):
    steps = range(0, 120, 7)
    for base in (1.0, 0.05):
        port = callbacks.warmup_schedule(base, **kw)
        ref = j_callbacks.warmup_schedule(base, **kw)
        np.testing.assert_allclose([port(s) for s in steps],
                                   [float(ref(s)) for s in steps],
                                   rtol=1e-6)


@pytest.mark.parametrize("multiplier,staircase", [
    ([(0, 1.0), (2, 0.1), (5, 0.01)], True),
    (lambda e: 0.5 ** e, True),
    (lambda e: 1.0 / (1 + e), False),
])
def test_multiplier_schedule_matches_the_reference(multiplier, staircase):
    steps = range(0, 80, 3)
    port = callbacks.multiplier_schedule(0.2, multiplier, steps_per_epoch=4,
                                         staircase=staircase)
    ref = j_callbacks.multiplier_schedule(0.2, multiplier, steps_per_epoch=4,
                                          staircase=staircase)
    np.testing.assert_allclose([port(s) for s in steps],
                               [float(ref(s)) for s in steps], rtol=1e-6)


def test_schedule_drives_lambda_lr():
    model = torch.nn.Linear(2, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, callbacks.warmup_schedule(steps_per_epoch=2, warmup_epochs=1,
                                       scale=4.0))
    lrs = []
    for _ in range(4):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(lrs, [0.1, 0.2, 0.4, 0.4], rtol=1e-12)


def test_world_of_one_callbacks(hvd1):
    assert callbacks.metric_average(3.5) == 3.5
    t = torch.tensor([1.0, 2.0])
    assert torch.equal(callbacks.metric_average(t), t)
    assert callbacks.MetricAverageCallback()({"loss": 2.0}) == {"loss": 2.0}
    cb = callbacks.BroadcastGlobalVariablesCallback()
    params = {"w": torch.ones(2)}
    assert cb(params) is params and cb(params) is params
