"""The parallel schedules (ROADMAP A11) on an NVIDIA GPU at a world of one:
``world_check.a11_checks`` on a small fp32 model (4 layers, 4 heads,
emb 64: head_dim 16, the fp32 3xTF32 flash kernels) with every axis of
size one, as ``chip_smoke.py``'s ``parallel`` phase runs it at gpt-small
width.  Ring, zigzag and Ulysses attention, tensor parallelism, the GPipe,
circular and tp-in-pp pipelines, expert parallelism and the sharded
decode, each held against the unsharded model on the card within the
fp32 gates, and the tensor-parallel and pipeline runs launching exactly
the fp32 route's kernels.  The collectives between ranks need more cards
(``python -m horovod_tpu_torch.world_check --only a11`` on four).
Without a GPU it skips: the flash kernels have no CPU mode.

    python -m pytest tests/test_torch_parallel_gpu.py --noconftest -q
"""

from __future__ import annotations

import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu

LAYERS, BATCH = 4, 4


@pytest.fixture
def world_of_one():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import horovod_tpu_torch as hvd

    fa.kernels.build_all()
    hvd.init()
    yield hvd
    hvd.shutdown()


def test_a11_schedules_at_a_world_of_one(world_of_one):
    from horovod_tpu_torch import world_check

    hvd = world_of_one
    checks = world_check.a11_checks(hvd, torch, cpu=False, small=True)
    assert world_check.a11_failures(checks) == []
    path = tuple(fa.kernel_for(p, torch.float32, 16)
                 for p in ("fwd", "dkdv", "dq"))
    assert checks["tp"]["launches"] == {n: LAYERS for n in path}
    for name in ("pp", "pp_circular", "pp_tp"):
        assert checks[name]["launches"] == {
            n: LAYERS * BATCH * (2 if p == "fwd" else 1)
            for n, p in zip(path, ("fwd", "dkdv", "dq"))}, name
    for name in ("sp_ring", "sp_zigzag", "sp_ulysses"):
        assert checks[name]["launches"] == {}, name
    assert not torch.backends.cuda.matmul.allow_tf32
