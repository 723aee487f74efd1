"""Drivers of the program's training entries, one module per model
family (named by a configuration's ``family``).  A family module gives:

* ``reference``: its plain reference module (``param_specs``,
  ``comparison_leaves``, ``train``);
* ``Program(cfg, traffic, seed, device, dtype, fault)``: the program's
  step built through its own entry, loaded with the seeded weights, over
  a pool of seeded inputs (:class:`ProgramBase`);
* ``batches(cfg, traffic, seed, device)``: the pool of inputs;
* ``reference_readings(cfg, traffic, seed, device, steps)``;
* ``units(traffic)``, ``step_flops(cfg, traffic)`` and the family's
  per-layer arithmetic.

The helpers here are the ones every family shares: seeded weights made
on the device in one call, and the readings the comparison takes.
"""

from __future__ import annotations

import math

from ..common import generator

FAULTS = ("unchanged", "half")


def seeded_weights(specs: list, seed: int, device) -> dict:
    """``name -> float32 tensor`` from ``specs`` (``param_specs``): every
    normal leaf is a scaled view of one ``randn`` drawn on ``device``."""
    import torch  # noqa: PLC0415

    normal = [(n, s, i[1]) for n, s, i in specs if i[0] == "normal"]
    total = sum(math.prod(s) for _, s, _ in normal)
    flat = torch.randn(total, generator=generator(seed, "weights", device),
                       device=device)
    out, at = {}, 0
    for name, shape, std in normal:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    for name, shape, init in specs:
        if init[0] == "fill":
            out[name] = torch.full(shape, init[1], device=device)
    return out


def leaf_norms(tensors: dict, split) -> dict:
    """``leaf -> L2 norm`` (float) of every comparison leaf of
    ``tensors``, ``split`` the reference's ``comparison_leaves``; one
    device sync."""
    import torch  # noqa: PLC0415

    names, norms = [], []
    for name, t in tensors.items():
        for leaf, part in split(name, t):
            names.append(leaf)
            norms.append(torch.linalg.vector_norm(part.detach().double()))
    values = torch.stack(norms).cpu().tolist() if norms else []
    return dict(zip(names, values))


def innermost_optimizer(opt):
    """The ``torch.optim.Optimizer`` inside the program's optimizer
    wrappers (``DistributedOptimizer``, ``OverlapPlan``)."""
    import torch  # noqa: PLC0415

    while not isinstance(opt, torch.optim.Optimizer):
        opt = opt.optimizer
    return opt


def gradient_from_state(opt, params: dict) -> dict:
    """``name -> gradient`` as the optimizer got it at its first step,
    worked out from its state: Adam's first moment over ``1 - beta1``,
    or the momentum buffer (the first step's buffer is the gradient).  A
    leaf with no state (an optimizer that never stepped) reads zero."""
    import torch  # noqa: PLC0415

    inner = innermost_optimizer(opt)
    beta1 = inner.param_groups[0].get("betas", (None,))[0]
    out = {}
    for name, p in params.items():
        st = inner.state.get(p, {})
        if "exp_avg" in st:
            out[name] = st["exp_avg"] / (1 - beta1)
        elif "momentum_buffer" in st:
            out[name] = st["momentum_buffer"]
        else:
            out[name] = torch.zeros_like(p)
    return out


class ProgramBase:
    """What the window drives: ``step(i)`` runs the program's step on
    pool entry ``i`` and returns its loss (a device tensor);
    ``leaves()``, ``grads()`` give the program's state by the reference's
    names.  Subclasses set ``model``, ``opt``, ``pool`` and ``_call``."""

    split = None  # the reference's comparison_leaves
    fault = None

    def _apply_fault(self) -> None:
        if self.fault == "unchanged":
            innermost_optimizer(self.opt).step = lambda *a, **k: None
        elif self.fault not in (None, "half"):
            raise ValueError(f"unknown fault {self.fault!r}; one of {FAULTS}")

    def load(self, weights: dict) -> None:
        """Copy the seeded weights into the built model; the names and
        shapes must be the reference's exactly."""
        import torch  # noqa: PLC0415

        state = self.leaves()
        if set(state) != set(weights):
            raise RuntimeError(
                f"the program's leaves are not the reference's: only in "
                f"the program {sorted(set(state) - set(weights))[:5]}, only "
                f"in the reference {sorted(set(weights) - set(state))[:5]}")
        with torch.no_grad():
            for name, t in state.items():
                if tuple(t.shape) != tuple(weights[name].shape):
                    raise RuntimeError(f"{name}: program {tuple(t.shape)}, "
                                       f"reference {tuple(weights[name].shape)}")
                t.copy_(weights[name])

    def leaves(self) -> dict:
        return dict(self.model.named_parameters())

    def grads(self) -> dict:
        return gradient_from_state(self.opt, dict(
            self.model.named_parameters()))

    def batch(self, i: int):
        b = self.pool[i % len(self.pool)]
        if self.fault == "half":
            return tuple(t[:t.shape[0] // 2] for t in b)
        return b

    def step(self, i: int):
        return self._call(self.batch(i))

    def close(self) -> None:
        self.model = self.opt = self.pool = self._call = None
