"""The elastic state tier on an NVIDIA GPU: a 2-layer gpt-nano (bf16
compute, head_dim 64: the tensor-core flash kernels) trained by AdamW on
the card, committed, its snapshot pushed to the replica tier over a real
KV store; a fresh model and optimizer (a respawned worker) restore from
that replica and train on.  The restored run's losses and final
parameters equal the uninterrupted run's bit for bit, and the restore
wrote into the live tensors.  Without a GPU it skips: the flash kernels
have no CPU mode.

    python -m pytest tests/test_torch_elastic_gpu.py --noconftest -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ckpt.replica import ReplicaTier
from horovod_tpu_torch.elastic.context import LocalContext
from horovod_tpu_torch.elastic.state import State
from horovod_tpu_torch.models import gpt
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.run.rendezvous import KVStoreClient, KVStoreServer
from horovod_tpu_torch.train import lm_loss, make_adamw

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    fa.kernels.build_all()
    return torch.device("cuda")


@pytest.fixture
def kv():
    server = KVStoreServer()
    server.start()
    try:
        yield KVStoreClient(f"127.0.0.1:{server.port}", server.secret)
    finally:
        server.stop()


def _build():
    model = gpt("nano", num_layers=2, num_heads=2, dtype=torch.bfloat16)
    return model, make_adamw(model.parameters())


def _step(model, opt, k):
    toks = torch.from_numpy(
        np.random.RandomState(k).randint(0, 1024, (2, 129))).cuda()
    opt.zero_grad()
    loss = lm_loss(model, toks)
    loss.backward()
    opt.step()
    return loss.item()


def test_commit_then_restore_from_the_replica_is_bit_for_bit(cuda, kv):
    model, opt = _build()
    state = State(model=model, opt=opt, step=0)
    state._replica_tier = ReplicaTier(kv, 0, [0])
    for k in range(2):
        _step(model, opt, k)
        state.step += 1
    state.commit()
    fa.reset_launch_counts()
    losses = [_step(model, opt, k) for k in range(2, 4)]
    assert all(fa.LAUNCHES[n] == 2 * 2 for n in
               ("flash_fwd_tc", "flash_bwd_dkdv_tc", "flash_bwd_dq_tc"))
    want = [p.detach().clone() for p in model.parameters()]

    # a respawned worker: fresh seeded weights, an empty optimizer
    model2, opt2 = _build()
    params = list(model2.parameters())
    state2 = State(model=model2, opt=opt2, step=0)
    state2._replica_tier = ReplicaTier(kv, 0, [0])
    state2.sync(LocalContext())
    assert state2.last_restore["source"] == "peer"
    assert state2.last_restore["replica_adopted"] is True
    assert state2.step == 2
    assert all(a is b for a, b in zip(model2.parameters(), params))
    assert all(p.device.type == "cuda" for p in params)
    assert [_step(model2, opt2, k) for k in range(2, 4)] == losses
    for got, ref in zip(model2.parameters(), want):
        assert torch.equal(got, ref)
