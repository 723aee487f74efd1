"""The port's memory plane (``obs/memplane.py``) against the JAX
package's.

* the census on the CPU: owners' bytes from ``register_owner`` suppliers
  returning tensors, modules and optimizers, a view counted once with its
  storage, the first owner of a shared storage keeping it, dead suppliers
  pruned, no device totals (``source: owners``) and the ``mem.*`` gauges;
* ``register_program(stats=)`` (the step's measured peak; PyTorch has no
  compiled program to read) and ``parse_memory_analysis`` on the
  reference's shapes;
* ``kv_occupancy`` and ``dominant_owner`` equal the reference's;
* the OOM black box: ``alloc_guard`` under ``mem_alloc:action=oom`` raises
  ``torch.cuda.OutOfMemoryError`` and drops a ``mem.oom`` event; the dump
  that rank leaves reads to the same memory verdict in both packages'
  ``postmortem``.
"""

from __future__ import annotations

import gc
import json

import pytest
import torch

import horovod_tpu.obs.memplane as jmemplane
import horovod_tpu.obs.postmortem as jpostmortem
from horovod_tpu_torch.obs import flightrec, memplane, postmortem, registry
from horovod_tpu_torch.testing import faults


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("HVDTPU_FAULT_SPEC", raising=False)
    faults.reset()
    memplane.reset_owners()
    memplane.reset_programs()
    memplane.reset_census()
    flightrec.reset_recorder()
    yield
    faults.reset()
    memplane.reset_owners()
    memplane.reset_programs()
    memplane.reset_census()
    flightrec.reset_recorder()


def test_census_buckets_owners_on_the_cpu():
    model = torch.nn.Linear(8, 4)                    # 32 + 4 floats
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.ones(2, 8)).sum().backward()
    opt.step()                                       # momentum buffers
    cache = torch.zeros(4, 16)
    memplane.register_owner("params", lambda: model)
    memplane.register_owner("optimizer_state", lambda: opt)
    memplane.register_owner("kv_cache", lambda: {"k": cache,
                                                 "rows": [cache[1:3]]})
    # a second owner of the same storage does not count it again
    memplane.register_owner("other", lambda: cache[0])
    reg = registry.MetricsRegistry()
    doc = memplane.census(publish=True, registry=reg)
    assert doc["source"] == "owners"
    assert doc["device"] == {"source": "unavailable"}
    assert doc["owners"] == {"params": 36 * 4, "optimizer_state": 36 * 4,
                             "kv_cache": 64 * 4, "other": 0}
    assert doc["total_bytes"] == 136 * 4
    assert reg.gauge("mem.owner_bytes", owner="kv_cache").value == 256
    assert memplane.dominant_owner(doc) == \
        jmemplane.dominant_owner(doc) == ("kv_cache", 256 / 544)


def test_dead_suppliers_are_pruned_and_the_collector_publishes():
    class Owner:
        def __init__(self):
            self.t = torch.zeros(10)

    import weakref

    o = Owner()
    ref = weakref.ref(o)
    memplane.register_owner("kv_cache",
                            lambda: (lambda x: x.t if x else None)(ref()))
    reg = registry.MetricsRegistry()
    memplane.install_census(registry=reg)
    reg.snapshot()
    assert reg.gauge("mem.owner_bytes", owner="kv_cache").value == 40
    del o
    gc.collect()
    assert memplane.census(publish=False)["owners"].get("kv_cache", 0) == 0
    assert memplane.census(publish=False)["owners"].get("kv_cache", 0) == 0


def test_register_program_and_the_memory_record():
    stats = {"source": "memory_analysis", "argument_bytes": 100,
             "output_bytes": 20, "temp_bytes": 3000, "alias_bytes": 0,
             "generated_code_bytes": 0, "total_bytes": 3120}
    reg = registry.MetricsRegistry()
    assert memplane.register_program("train.step", stats=stats,
                                     registry=reg) == stats
    assert reg.gauge("mem.compiled.temp_bytes",
                     program="train.step").value == 3000
    rec = memplane.memory_record()
    assert rec["programs"] == {"train.step": stats}
    assert rec["census"]["source"] == "owners"

    class Compiled:
        def memory_analysis(self):
            return {"argument_size_in_bytes": 8, "output_size_in_bytes": 4,
                    "temp_size_in_bytes": 16, "alias_size_in_bytes": 4}

    for obj in (Compiled(), object()):
        assert memplane.parse_memory_analysis(obj) == \
            jmemplane.parse_memory_analysis(obj)


@pytest.mark.parametrize("case", [
    ([3, 10, 0, 64], [0, 1, 3], 64, 96.0, None),
    ([0, 0], [], 32, 8.0, 4096),
    ([100, 5], [0, 1], 32, 8.0, 512),     # a position past the cache
])
def test_kv_occupancy_equals_the_reference(case):
    assert memplane.kv_occupancy(*case) == jmemplane.kv_occupancy(*case)


def test_oom_black_box_reads_the_same_in_both_postmortems(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("HVDTPU_FAULT_SPEC",
                       "mem_alloc:rank=1:action=oom")
    faults.reset()
    memplane.register_owner("kv_cache", lambda: torch.zeros(256))
    memplane.register_owner("params", lambda: torch.zeros(64))
    memplane.alloc_guard("prefill", rank=0)           # not this rank
    with pytest.raises(torch.cuda.OutOfMemoryError) as info:
        memplane.alloc_guard("decode_step", rank=1)
    assert memplane.is_resource_exhausted(info.value)
    assert memplane.is_resource_exhausted(
        torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert not memplane.is_resource_exhausted(RuntimeError("other"))
    flightrec.record_exception(info.value, where="decode_step")
    events = flightrec.get_recorder().snapshot()
    oom = [e for e in events if e["kind"] == "mem.oom"]
    assert len(oom) == 1 and oom[0]["name"] == "decode_step"
    assert "owner=kv_cache" in oom[0]["detail"]
    flightrec.get_recorder().dump(str(tmp_path / "flightrec.rank.1.json"),
                                  rank="1", trigger="excepthook")
    mine = postmortem.analyze(postmortem.load_dumps(str(tmp_path)),
                              expected_ranks=1)
    ref = jpostmortem.analyze(jpostmortem.load_dumps(str(tmp_path)),
                              expected_ranks=1)
    assert json.dumps(mine, default=str) == json.dumps(ref, default=str)
    verdict = postmortem.verdict(mine)
    assert verdict == jpostmortem.verdict(ref)
    assert "OUT OF DEVICE MEMORY: rank 1 died allocating in " \
        "'decode_step'" in verdict
