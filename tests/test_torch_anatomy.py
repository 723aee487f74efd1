"""The port's step anatomy (``horovod_tpu_torch/obs/anatomy.py``) held
against the reference's (``horovod_tpu/obs/anatomy.py``): the three cases
of ``tests/test_campaign.py:299-397`` through both packages.

On the same step time, MFU, FLOPs, device kind and registry contents the
two anatomies must be equal key for key, exactly (the same float
arithmetic in the same order), apart from ``top_ops`` — the reference
counts HLO opcodes of a compiled artifact, the port the kernels a profiled
step launches — and ``bytes_per_step``, which the port never has.  The
device kind is one neither package has a peak for ("cpu"), so both take
the same CPU estimates; the H100 case is checked on the port alone.
"""

from __future__ import annotations

import copy

import pytest
import torch

from horovod_tpu.obs import anatomy as janatomy
from horovod_tpu.obs import registry as jregistry
from horovod_tpu_torch.obs import anatomy, registry

H100 = "NVIDIA H100 80GB HBM3"


def _without_op_table(doc: dict) -> dict:
    doc = copy.deepcopy(doc)
    doc.pop("top_ops", None)
    doc.pop("bytes_per_step", None)
    return doc


def _profiled_cpu_step() -> dict:
    """Launches by op of one CPU step of the port's gpt-nano (2 layers,
    fp32, batch 2, seq 16), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch.models import gpt

    model = gpt("nano", device="cpu", dtype=torch.float32, num_layers=2,
                max_len=16, attention_impl="reference")
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        logits = model(tokens)
        torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]).float(),
            tokens.reshape(-1)).backward()
    return {e.key: e.count for e in prof.key_averages()}


@pytest.fixture
def clean_registries():
    registry.reset_registry()
    jregistry.reset_registry()
    yield
    registry.reset_registry()
    jregistry.reset_registry()


def test_step_anatomy_components_tile_step_time(clean_registries):
    """compute + collective_wait + host_gap tile the step within 5%, the
    op table comes from a profiled CPU step of the port, and the rest of
    the anatomy equals the reference's key for key."""
    launches = _profiled_cpu_step()
    kw = dict(mfu=0.25, flops_per_step=2 * 32 ** 3, device_kind="cpu",
              dtype="fp32", steps_observed=4)
    out = anatomy.step_anatomy(10.0, launches=launches, **kw)
    comp = out["components_ms"]
    assert abs(sum(comp.values()) - out["step_ms"]) / out["step_ms"] <= 0.05
    assert 95.0 <= out["tile_pct"] <= 105.0
    assert comp["compute_ms"] == pytest.approx(2.5)  # mfu x step
    assert comp["host_gap_ms"] >= 0.0
    assert out["method"]["compute"] == "mfu x step"
    assert out["roofline"]["verdict"] in (
        "compute-bound", "memory-bound", "comms-bound")
    # the profiled step's eight most launched ops, with their launches
    top = out["top_ops"]
    assert len(top) == 8
    assert all(launches[t["op"]] == t["count"] for t in top)
    assert min(t["count"] for t in top) >= max(
        n for op, n in launches.items()
        if op not in {t["op"] for t in top})
    ref = janatomy.step_anatomy(10.0, compiled=None, **kw)
    assert _without_op_table(out) == ref
    assert anatomy.step_anatomy(0.0, mfu=0.5) is None
    assert janatomy.step_anatomy(0.0, mfu=0.5) is None


@pytest.mark.parametrize("kw", [
    {"mfu": 0.2, "steps_observed": 4},
    {"mfu": None, "flops_per_step": 4e8, "steps_observed": 4},
    {"mfu": 0.05, "steps_observed": None},
])
def test_anatomy_amortizes_engine_collective_wait(clean_registries, kw):
    """With the engine's cycle histogram fed (20 ms over 4 steps) the
    collective wait is amortized and the split still tiles; both
    packages read their own registry under the same metric names."""
    for reg in (registry.get_registry(), jregistry.get_registry()):
        hist = reg.histogram("engine.cycle_time_ms")
        for _ in range(4):
            hist.observe(5.0)
    out = anatomy.step_anatomy(10.0, **kw)
    ref = janatomy.step_anatomy(10.0, **kw)
    assert _without_op_table(out) == ref
    comp = out["components_ms"]
    assert sum(comp.values()) == pytest.approx(out["step_ms"], rel=0.05)
    if kw == {"mfu": 0.2, "steps_observed": 4}:
        assert comp["collective_wait_ms"] == pytest.approx(5.0)
        assert comp["compute_ms"] == pytest.approx(2.0)
        assert comp["host_gap_ms"] == pytest.approx(3.0)
        assert out["roofline"]["verdict"] == "comms-bound"  # 50% > 35%
        assert out["method"]["collective_wait"] \
            == "engine.cycle_time_ms histogram"


def test_no_engine_cycles_means_no_collective_wait(clean_registries):
    out = anatomy.step_anatomy(10.0, mfu=0.3, steps_observed=4)
    assert out == janatomy.step_anatomy(10.0, mfu=0.3, steps_observed=4)
    assert out["components_ms"]["collective_wait_ms"] == 0.0
    assert out["method"]["collective_wait"].startswith("no engine cycles")


@pytest.mark.parametrize("case", [
    dict(mfu=0.6, collective_frac=0.5, flops_per_step=None,
         bytes_per_step=None),
    dict(mfu=0.5, collective_frac=0.0, flops_per_step=None,
         bytes_per_step=None),
    dict(mfu=0.05, collective_frac=0.0, flops_per_step=1e9,
         bytes_per_step=1e9),
    dict(mfu=0.05, collective_frac=0.0, flops_per_step=1e12,
         bytes_per_step=1e9),
])
def test_roofline_verdict_thresholds(case):
    """The reference's thresholds (comms outranks MFU; MFU >= 0.4 or an
    intensity at the ridge is compute-bound; else memory-bound) on the
    same inputs give the same verdict, key for key."""
    got = anatomy.roofline_verdict(device_kind="cpu", **case)
    assert got == janatomy.roofline_verdict(device_kind="cpu", **case)
    want = ("comms-bound" if case["collective_frac"] > 0.35
            else "compute-bound" if case["mfu"] >= 0.4
            or case["flops_per_step"] == 1e12 else "memory-bound")
    assert got["verdict"] == want
    assert got["estimate"] is True


def test_h100_roofline_is_not_an_estimate():
    """On the H100 the peak and the bandwidth are the data sheet's: no
    estimate flag, ridge 989e12 / 3.35e12 FLOPs a byte (bf16)."""
    out = anatomy.step_anatomy(30.0, mfu=0.4, device_kind=H100,
                               launches={"flash_fwd_tc": 12.0,
                                         "flash_bwd_dq_tc": 12.0,
                                         "flash_bwd_dkdv_tc": 12.0,
                                         "flash_fwd": 0})
    assert out["roofline"]["estimate"] is False
    assert out["method"]["peak_flops_estimate"] is False
    assert out["roofline"]["ridge_flops_per_byte"] == round(989e12 / 3.35e12,
                                                            2)
    assert out["top_ops"] == [{"op": "flash_bwd_dkdv_tc", "count": 12},
                              {"op": "flash_bwd_dq_tc", "count": 12},
                              {"op": "flash_fwd_tc", "count": 12}]
    assert anatomy.attach_anatomy({}, step_ms="x") == {}
