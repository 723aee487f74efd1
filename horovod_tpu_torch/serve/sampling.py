"""Replicated per-request PRNG sampling (counterpart of
``horovod_tpu/serve/sampling.py``): temperature / top-k token picks that
are a pure function of ``(request id, emission index, serve seed)``, so
every rank of a serving world derives the identical token and a replay
that re-prefills ``prompt + resume`` continues the stream bit-exactly.

* ``request_key(seed, rid)`` folds a stable CRC-32 of the request id
  into ``prng_key(seed)`` (never Python's ``hash``, which depends on
  ``PYTHONHASHSEED``): the request's stream root.
* token ``i`` of a request is sampled with ``fold_in(root, i)``, ``i`` the
  request's emission index, not the serving step.
* :func:`sample_token` is the one sampling math, used by the slot engine
  and by the tests.

The keys are jax's (``ops/prng.py``: threefry-2x32, bit for bit), carried
as ``uint32[2]`` values in int64 tensors, so a stream equals the JAX
package's wherever the logits agree.  ``temperature == 0`` is greedy
argmax (the key is ignored).
"""

from __future__ import annotations

import zlib

import torch

from ..ops import prng

__all__ = ["request_key", "token_key", "sample_token", "KEY_SHAPE"]

# Raw key width: the uint32[2] of a jax threefry key.
KEY_SHAPE = (2,)


def request_key(seed: int, rid: str, device=None) -> torch.Tensor:
    """The request's PRNG stream root: ``fold_in(prng_key(seed),
    crc32(rid))``, an int64 ``[2]``."""
    rid_tag = zlib.crc32(rid.encode("utf-8")) & 0x7FFFFFFF
    return prng.fold_in(prng.prng_key(seed, device), rid_tag)


def token_key(base: torch.Tensor, emission_index) -> torch.Tensor:
    """Key of the request's ``emission_index``-th generated token (both
    broadcast: ``base [..., 2]``, ``emission_index`` int or ``[...]``)."""
    return prng.fold_in(base, emission_index)


def sample_token(logits: torch.Tensor, temperature, top_k,
                 key: torch.Tensor) -> torch.Tensor:
    """One token per row of logits: greedy where ``temperature <= 0``,
    else top-k-truncated temperature sampling by the Gumbel-max trick.

    ``logits [..., vocab]``; ``temperature`` float or ``[...]``; ``top_k``
    int or ``[...]`` (0, or >= vocab, keeps every token); ``key [..., 2]``.
    Rows are independent (a batch of rows is the reference's ``vmap``).
    Returns int64 ``[...]``.  A temperature given on the host (a number,
    a numpy array or a CPU tensor) with no row above 0 skips the sampled
    branch, whose result greedy rows discard anyway; one on the device is
    not read back.
    """
    dev = logits.device
    greedy = torch.argmax(logits, dim=-1)
    temperature = torch.as_tensor(temperature, dtype=torch.float32)
    if temperature.device.type == "cpu" and not bool(
            (temperature > 0).any()):
        return greedy
    temperature = temperature.to(dev)
    sampling = temperature > 0
    vocab = logits.shape[-1]
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev)
    safe_t = torch.where(sampling, temperature, 1.0)
    lt = logits.float() / safe_t[..., None]
    # top-k without dynamic shapes: below the k-th largest is -inf
    k_eff = torch.where(top_k > 0, top_k, vocab).clamp(1, vocab)
    k_eff = k_eff.expand(lt.shape[:-1])
    sorted_lt = torch.sort(lt, dim=-1, descending=True).values
    kth = sorted_lt.gather(-1, (k_eff - 1)[..., None])
    lt = torch.where(lt < kth, -torch.inf, lt)
    sampled = torch.argmax(lt + prng.gumbel(key, (vocab,)), dim=-1)
    return torch.where(sampling, sampled, greedy)
