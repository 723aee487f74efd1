"""Pipeline-parallel GPT training, the reference's examples/
pipeline_train.py on the port: the block stack splits into stages over a
``pp`` axis of the world's ranks (``basics.init_axes``; one process per
GPU, so a stage is a rank), trained with both schedules:

* contiguous GPipe (``pp_gpt_loss``: a stage-local head, one scalar
  rejoin, per-tick remat), and
* circular interleaved groups (``--circles``, ``pp_gpt_loss_circular``:
  the bubble divided by the circles).

No Horovod 0.19.1 equivalent: it is data-parallel only.

    python -m horovod_tpu_torch.run -np 2 python -m horovod_tpu_torch.examples.pipeline_train --smoke
    python -m horovod_tpu_torch.examples.pipeline_train --smoke --cpu    # one stage
"""

from __future__ import annotations

import numpy as np
import torch

from . import _common


def main(argv=None) -> int:
    p = _common.parser(__doc__)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--microbatches", type=int, default=4)
    p.add_argument("--circles", type=int, default=0,
                   help=">0 selects the circular schedule with this many "
                        "layer groups per stage")
    args = p.parse_args(argv)
    if args.smoke:
        args.steps, args.seq_len = 3, 32
    if args.steps <= 0:
        raise SystemExit("--steps must be positive")

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.parallel import (local_shard, pp_gpt_loss,
                                            pp_gpt_loss_circular,
                                            stack_pp_params,
                                            stack_pp_params_circular)

    dev = _common.init(args)
    pp, r = hvd.size(), hvd.rank()
    basics.init_axes({"pp": pp})
    # the circular ring buffer needs microbatches >= pp; round the batch UP
    # to the next multiple so the requested workload is kept
    args.microbatches = max(args.microbatches, pp)
    if args.batch_size % args.microbatches:
        rounded = -(-args.batch_size // args.microbatches) * args.microbatches
        print(f"# batch {args.batch_size} -> {rounded} (must divide "
              f"microbatches={args.microbatches})")
        args.batch_size = rounded

    circles = args.circles or 1
    per_group = 1 if args.smoke else 2
    layers = per_group * pp * circles
    size_kw = (dict(num_heads=4, emb_dim=64, vocab_size=512) if args.smoke
               else {})
    model = gpt("nano", device=dev, num_layers=layers, max_len=args.seq_len,
                dtype=torch.float32, attention_impl="reference", **size_kw)
    cfg = model.cfg
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    rng = np.random.RandomState(args.seed)
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (args.batch_size, args.seq_len))).to(dev)
    targets = torch.roll(tokens, -1, dims=1)
    if args.circles:
        staged, replicated = stack_pp_params_circular(model, cfg, pp,
                                                      circles)
    else:
        staged, replicated = stack_pp_params(model, cfg, pp)
    # this rank's stage (the leading dim of 1 shard_map would hand it)
    staged = local_shard(staged, r)
    leaves = [t.requires_grad_() for t in
              torch.utils._pytree.tree_leaves((staged, replicated))]

    def loss_of(staged, replicated):
        if args.circles:
            return pp_gpt_loss_circular(
                staged, replicated, cfg, tokens, targets, "pp",
                microbatches=args.microbatches, circles=circles)
        return pp_gpt_loss(staged, replicated, cfg, tokens, targets, "pp",
                           microbatches=args.microbatches)

    sched = f"circular x{circles}" if args.circles else "gpipe"
    losses = []
    for i in range(args.steps):
        loss = loss_of(staged, replicated)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():  # plain SGD, whose state is empty
            for t, g in zip(leaves, grads):
                t.sub_(0.5 * g)
        losses.append(float(loss))
        if r == 0:
            print(f"[{sched} pp={pp} layers={layers}] step {i} loss "
                  f"{losses[-1]:.4f}", flush=True)
    assert np.isfinite(losses[-1]), "non-finite loss"
    if r == 0:
        print(f"done: final loss {losses[-1]:.4f}", flush=True)
    _common.report("pipeline_train", r, pp=pp, layers=layers,
                   schedule=sched, losses=losses)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
