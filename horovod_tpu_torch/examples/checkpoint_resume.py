"""The checkpoint / resume pattern, the reference's examples/
checkpoint_resume.py on the port: rank 0 saves, every rank resumes by
broadcast, so no shared filesystem is needed.  ``CKPT_DIR`` names the
directory (default: one under the temporary directory); a second run
resumes from the last checkpoint of the first.

    python -m horovod_tpu_torch.examples.checkpoint_resume
    python -m horovod_tpu_torch.run -np 2 python -m horovod_tpu_torch.examples.checkpoint_resume
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from . import _common


def main(argv=None) -> int:
    args = _common.parser(__doc__).parse_args(argv)

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.checkpoint import (latest_checkpoint_step,
                                              restore_checkpoint,
                                              save_checkpoint)
    from horovod_tpu_torch.models import MLP
    from horovod_tpu_torch.optim import P

    dev = _common.init(args)
    ckpt_dir = os.environ.get(
        "CKPT_DIR", os.path.join(tempfile.gettempdir(), "hvdtpu_ckpt_demo"))

    model = MLP(8, features=(32,), num_classes=10).to(dev)
    x = np.random.RandomState(args.seed).rand(256, 8).astype(np.float32)
    y = (x.sum(-1) * 1.25).astype(np.int64) % 10
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters(),
                                                    lr=1e-2))
    start_step = 0

    # Resume if a checkpoint exists (rank 0 reads, every rank receives).
    # Rank 0 decides and broadcasts: ranks that disagreed on the files
    # would take two collective schedules, and hang.
    resume_step = hvd.broadcast_object(latest_checkpoint_step(ckpt_dir),
                                       root_rank=0)
    if resume_step is not None:
        state = restore_checkpoint(
            ckpt_dir, {"params": model.state_dict(), "step": 0})
        model.load_state_dict(state["params"])
        start_step = int(state["step"])
        if hvd.rank() == 0:
            print(f"resumed from step {start_step}", flush=True)
    else:
        # the branch is the same on every rank: decided by the broadcast
        hvd.broadcast_parameters(  # hvdtpu: disable=HVD003
            model.state_dict(), root_rank=0)

    def local_step(model, opt, xb, yb):
        opt.zero_grad()
        loss = F.cross_entropy(model(xb), yb)
        loss.backward()
        opt.step()
        return model, opt, loss.detach()

    # DistributedOptimizer averages over the ranks, so the step runs on each
    # rank's block of the batch: hvd.distribute wires that up
    step = hvd.distribute(
        local_step, in_specs=(P(), P(), P(hvd.DP_AXIS), P(hvd.DP_AXIS)),
        out_specs=(P(), P(), P()))

    losses = []
    for s in range(start_step, start_step + 50):
        model, opt, loss = step(model, opt, x, y)
        losses.append(float(loss))
        if s % 20 == 0:
            save_checkpoint(ckpt_dir, {"params": model.state_dict(),
                                       "step": s}, step=s, keep=3)
            if hvd.rank() == 0:
                print(f"step {s}: loss {losses[-1]:.4f} (checkpointed)",
                      flush=True)
    _common.report("checkpoint_resume", hvd.rank(), start_step=start_step,
                   saved=latest_checkpoint_step(ckpt_dir), losses=losses)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
