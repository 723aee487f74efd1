"""BERT-base-style distributed training, the reference's examples/
bert_style.py on the port: a transformer whose embedding gradient rows
travel as sparse ``IndexedSlices`` (an allgather of values and indices,
reference tensorflow/__init__.py:74-89) while the dense gradients
allreduce with a gradient predivide factor (part of the averaging before
the sum, the rest after: gentler at large world sizes).

    python -m horovod_tpu_torch.examples.bert_style --smoke
    python -m horovod_tpu_torch.run -np 2 python -m horovod_tpu_torch.examples.bert_style --smoke
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import _common


def main(argv=None) -> int:
    p = _common.parser(__doc__)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    args = p.parse_args(argv)
    if args.smoke:
        args.steps, args.seq_len = 3, 64

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.ops.sparse import (IndexedSlices, allreduce_sparse,
                                              to_dense)
    from horovod_tpu_torch.train import lm_loss, make_adamw

    dev = _common.init(args)
    model = gpt("nano", device=dev)
    n_gpus = hvd.num_devices()
    # the same global batch on every process; hvd.distribute hands each
    # rank its block of rows
    global_batch = args.batch_size * n_gpus
    tokens = torch.from_numpy(np.random.RandomState(args.seed).randint(
        0, model.cfg.vocab_size, size=(global_batch, args.seq_len))).to(dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        make_adamw(model.parameters()),
        # predivide: grads /= factor before the cross-rank sum, the rest of
        # the averaging after (the reference's prescale / postscale split)
        gradient_predivide_factor=float(max(hvd.local_size(), 1)))
    embed = model.wte.weight

    def local_step(model, opt, toks):
        opt.zero_grad()
        loss = lm_loss(model, toks)
        loss.backward()
        # The embedding rows the batch touched travel sparse: an allgather
        # of (values, indices) in place of a dense reduce of the whole
        # vocab x d_model gradient (the BERT embedding pattern).  Shown on
        # the exchange only: the dense reduce in opt.step() owns the update.
        rows = torch.unique(toks)
        sparse = IndexedSlices(embed.grad[rows], rows, tuple(embed.shape))
        to_dense(allreduce_sparse(sparse, name="bert.embed.sparse"))
        opt.step()
        return model, opt, hvd.allreduce(loss.detach())

    step = hvd.distribute(local_step, donate_argnums=(0, 1))

    losses = []
    t0 = time.time()
    for _ in range(args.steps):
        model, opt, loss = step(model, opt, tokens)
        losses.append(float(loss))
    steps_s = args.steps / (time.time() - t0)
    if hvd.rank() == 0:
        print(f"loss={losses[-1]:.4f} {steps_s:.2f} steps/s", flush=True)
    _common.report("bert_style", hvd.rank(), world=n_gpus,
                   steps_per_sec=steps_s, losses=losses)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
