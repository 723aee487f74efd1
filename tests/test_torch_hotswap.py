"""The port's weight hot-swap (horovod_tpu_torch.serve.hotswap) against
the reference's (horovod_tpu.serve.hotswap), on the CPU.

Both packages run the table of tests/test_autoscale_swap.py: two
simulated ranks obey the leader's broadcast transitions and flip on the
same step, the durable version record landing before the flip; a version
published through a ``corrupt_write`` fault fails every rank's prefetch
checksum and the fleet rolls back, and the rejected version is not
offered again while a newer one is.  The transition documents, the
votes and the durable record must be the same in both packages; the
port's engines must end up serving the published weights exactly (the
reference's weights, carried across by ``params_from_jax``).  Tolerance:
exact.
"""

from __future__ import annotations

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu.serve as jserve
from horovod_tpu.serve.hotswap import SwapManager as JSwapManager
from horovod_tpu.testing import faults as jfaults
from horovod_tpu_torch.models import gpt, params_from_jax
from horovod_tpu_torch.run.rendezvous import KVStoreClient, KVStoreServer
from horovod_tpu_torch.serve import SlotEngine, publish_weights
from horovod_tpu_torch.serve.frontend import SCOPE
from horovod_tpu_torch.serve.hotswap import VERSION_KEY, SwapManager
from horovod_tpu_torch.testing import faults

from horovod_tpu.models.transformer import gpt as jax_gpt

OVERRIDES = dict(num_layers=1, num_heads=2, emb_dim=32, max_len=64,
                 vocab_size=64, attention_impl="reference")


def _jax_params(seed):
    model = jax_gpt("nano", dtype=jnp.float32, **OVERRIDES)
    return model, model.init(jax.random.PRNGKey(seed),
                             jnp.zeros((1, 8), jnp.int32))


def _state_dict(params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _port_engine(params):
    model = gpt("nano", device="cpu", dtype=torch.float32, **OVERRIDES)
    model.load_state_dict(_state_dict(params))
    return SlotEngine(model, 1)


@pytest.fixture
def kv():
    server = KVStoreServer()
    server.start()
    try:
        yield KVStoreClient(f"127.0.0.1:{server.port}", server.secret)
    finally:
        server.stop()


def _same_weights(engine, state):
    got = engine.model.state_dict()
    assert set(got) == set(state)
    for name, value in state.items():
        assert torch.equal(got[name], value), name


def _flip_run(pkg, kv, wdir, params0, params1):
    """The flip table through ``pkg``: the transition documents, the
    votes, the durable record between the two transitions, the versions,
    and the engines."""
    scope = f"serve_e0_{pkg}"
    if pkg == "jax":
        model, _ = _jax_params(0)
        engines = [jserve.SlotEngine(model.cfg, params0, 1)
                   for _ in range(2)]
        swaps = [JSwapManager(wdir, params0, poll_steps=1)
                 for _ in range(2)]
    else:
        engines = [_port_engine(params0) for _ in range(2)]
        init = _state_dict(params0)
        swaps = [SwapManager(wdir, init, poll_steps=1) for _ in range(2)]
    log = []
    doc = swaps[0].leader_step(kv, scope, [0, 1], step=1)
    log.append(doc)
    for rank, (sw, eng) in enumerate(zip(swaps, engines)):
        sw.apply(doc, eng, kv, scope, rank, epoch=0, step=1)
    log.append([kv.get(scope, f"swapok_1_{r}") for r in (0, 1)])
    log.append([sw.version for sw in swaps])
    log.append(kv.get(SCOPE, VERSION_KEY))
    doc = swaps[0].leader_step(kv, scope, [0, 1], step=2)
    log.append(doc)
    log.append(kv.get(SCOPE, VERSION_KEY))
    for rank, (sw, eng) in enumerate(zip(swaps, engines)):
        sw.apply(doc, eng, kv, scope, rank, epoch=0, step=2)
    log.append([sw.version for sw in swaps])
    return log, engines, swaps


def test_version_flip_is_the_references_across_simulated_ranks(tmp_path,
                                                               kv):
    _, params0 = _jax_params(3)
    _, params1 = _jax_params(9)
    logs = {}
    for pkg in ("jax", "port"):
        kv.delete(SCOPE, VERSION_KEY)
        wdir = str(tmp_path / pkg)
        if pkg == "jax":
            jserve.publish_weights(wdir, params1, 1)
        else:
            publish_weights(wdir, _state_dict(params1), 1)
        logs[pkg], engines, swaps = _flip_run(pkg, kv, wdir, params0,
                                              params1)
    assert logs["port"] == logs["jax"]
    assert logs["port"][0] == {"phase": "prefetch", "version": 1}
    assert logs["port"][3] is None          # nothing durable before ...
    assert logs["port"][4] == {"phase": "flip", "version": 1}
    assert logs["port"][5] == b"1"          # ... the record, then flip
    assert logs["port"][6] == [1, 1]
    # the port's engines serve the published weights, bit for bit, and
    # both ranks report the same flip step
    for eng in engines:
        _same_weights(eng, _state_dict(params1))
    assert [sw.flips for sw in swaps] == [[(1, 0, 2)]] * 2


def _rollback_run(pkg, kv, wdir, params0, params1, monkeypatch):
    mod_faults = jfaults if pkg == "jax" else faults
    monkeypatch.setenv("HVDTPU_FAULT_SPEC",
                       "shard_write:action=corrupt_write")
    mod_faults.reset()
    try:
        if pkg == "jax":
            jserve.publish_weights(wdir, params1, 1)
        else:
            publish_weights(wdir, _state_dict(params1), 1)
    finally:
        monkeypatch.delenv("HVDTPU_FAULT_SPEC")
        mod_faults.reset()
    scope = f"serve_e0_{pkg}"
    if pkg == "jax":
        model, _ = _jax_params(0)
        eng = jserve.SlotEngine(model.cfg, params0, 1)
        sw = JSwapManager(wdir, params0, poll_steps=1)
    else:
        eng = _port_engine(params0)
        sw = SwapManager(wdir, _state_dict(params0), poll_steps=1)
    log = []
    doc = sw.leader_step(kv, scope, [0], step=1)
    log.append(doc)
    sw.apply(doc, eng, kv, scope, 0, epoch=0, step=1)
    log.append(kv.get(scope, "swapok_1_0"))
    doc = sw.leader_step(kv, scope, [0], step=2)
    log.append(doc)
    sw.apply(doc, eng, kv, scope, 0, epoch=0, step=2)
    log.append((sw.version, kv.get(SCOPE, VERSION_KEY)))
    log.append(sw.leader_step(kv, scope, [0], step=3))
    if pkg == "jax":
        jserve.publish_weights(wdir, params1, 2)
    else:
        publish_weights(wdir, _state_dict(params1), 2)
    log.append(sw.leader_step(kv, scope, [0], step=4))
    return log, eng


def test_rollback_on_seeded_checksum_corruption_as_the_reference(
        tmp_path, kv, monkeypatch):
    _, params0 = _jax_params(3)
    _, params1 = _jax_params(9)
    logs = {}
    for pkg in ("jax", "port"):
        logs[pkg], eng = _rollback_run(pkg, kv, str(tmp_path / pkg),
                                       params0, params1, monkeypatch)
    assert logs["port"] == logs["jax"]
    assert logs["port"] == [
        {"phase": "prefetch", "version": 1}, b"fail",
        {"phase": "abort", "version": 1}, (0, None), None,
        {"phase": "prefetch", "version": 2}]
    _same_weights(eng, _state_dict(params0))   # the incumbent kept


def test_announce_rejects_a_foreign_job_fingerprint(tmp_path, kv):
    sw = SwapManager(str(tmp_path / "w"), {}, poll_steps=1)
    kv.put(SCOPE, "weights",
           pickle.dumps({"version": 5, "fp": "not-this-job"}))
    assert sw.poll_candidate(kv) is None
    # the port's publisher stamps this job's fingerprint: accepted
    _, params1 = _jax_params(9)
    publish_weights(str(tmp_path / "w"), _state_dict(params1), 2, kv=kv)
    assert sw.poll_candidate(kv) == 2


def test_a_wrong_model_fails_the_prefetch_vote(tmp_path, kv):
    """A version of another model's shapes fails the prefetch (the
    manifest's leaf table against the served model's), so the vote rolls
    the fleet back instead of loading wrong weights."""
    eng = _port_engine(_jax_params(3)[1])
    other = gpt("nano", device="cpu", dtype=torch.float32,
                **dict(OVERRIDES, emb_dim=64))
    wdir = str(tmp_path / "w")
    publish_weights(wdir, other.state_dict(), 1)
    sw = SwapManager(wdir, {}, poll_steps=1)
    assert sw.prefetch(1, eng.model.state_dict()) is False


def test_publish_weights_rejects_version_zero(tmp_path):
    with pytest.raises(ValueError, match=">= 1"):
        publish_weights(str(tmp_path / "w"), {}, 0)
