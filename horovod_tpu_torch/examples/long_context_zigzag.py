"""Long-context training with load-balanced zigzag sequence parallelism,
the reference's examples/long_context_zigzag.py on the port.

A RoPE GPT whose SEQUENCE (not its batch) is split over the ranks: each
rank holds the zigzag chunk pair of every sample, attention runs as the
balanced causal ring (``parallel/ring_attention.py``), and the gradients
average over the same ranks (``DistributedGradientTransform``).  No
Horovod 0.19.1 equivalent: it is data-parallel only.

    python -m horovod_tpu_torch.examples.long_context_zigzag --smoke
    python -m horovod_tpu_torch.run -np 2 python -m horovod_tpu_torch.examples.long_context_zigzag --smoke
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _common


def main(argv=None) -> int:
    p = _common.parser(__doc__)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--seq-len", type=int, default=512)
    args = p.parse_args(argv)
    if args.smoke:
        args.steps, args.seq_len = 3, 128

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.ops.collectives import axis_rank
    from horovod_tpu_torch.optim import P
    from horovod_tpu_torch.parallel.ring_attention import (zigzag_positions,
                                                           zigzag_shard)

    dev = _common.init(args)
    r, n = hvd.rank(), hvd.num_devices()
    if args.seq_len % (2 * n):
        raise SystemExit(f"--seq-len must divide by 2*{n}")
    s_local = args.seq_len // n

    model = gpt("nano", device=dev, max_len=args.seq_len,
                pos_embedding="rope", attention_impl="zigzag",
                sp_axis=hvd.DP_AXIS)
    # every process builds the same global batch, zigzag-reordered once;
    # distribute hands each rank its chunk pair (dim 1)
    tokens = torch.from_numpy(np.random.RandomState(args.seed).randint(
        0, model.cfg.vocab_size, size=(args.batch_size, args.seq_len + 1)))
    inputs = zigzag_shard(tokens[:, :-1], n, axis=1).to(dev)
    targets = zigzag_shard(tokens[:, 1:], n, axis=1).to(dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, eps=1e-8,
                            weight_decay=1e-4)
    tx = hvd.DistributedGradientTransform()
    tx_state = tx.init(None)

    def local_step(model, opt, tok, tgt):
        pos = zigzag_positions(axis_rank(hvd.DP_AXIS), n, s_local,
                               device=tok.device)
        opt.zero_grad()
        logits = model(tok, positions=pos)
        loss = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                               tgt.reshape(-1))
        loss.backward()
        # sequence-split loss: the gradients and the loss both average
        # over the ranks
        named = dict(model.named_parameters())
        grads, _ = tx.update({k: v.grad for k, v in named.items()}, tx_state)
        for k, g in grads.items():
            named[k].grad = g
        opt.step()
        return model, opt, hvd.allreduce(loss.detach())

    hvd.mesh("flat")
    step = hvd.distribute(
        local_step,
        in_specs=(P(), P(), P(None, hvd.DP_AXIS), P(None, hvd.DP_AXIS)),
        out_specs=(P(), P(), P()), donate_argnums=(0, 1))

    losses = []
    for i in range(args.steps):
        model, opt, loss = step(model, opt, inputs, targets)
        losses.append(float(loss))
        if r == 0:
            print(f"step {i}: loss {losses[-1]:.4f}", flush=True)
    assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0], f"did not train: {losses}"
    if r == 0:
        print(f"OK zigzag SP over {n} GPUs: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}", flush=True)
    _common.report("long_context_zigzag", r, world=n, losses=losses)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
