"""Slot engine: the model half of the serving plane (counterpart of
``horovod_tpu/serve/engine.py``).

Wraps the slot-based decode primitives (``models/decode.py``) for the
continuous-batching loop: one ``decode_step`` over the whole slot pool
(its shape never changes) and one ``assign_slot`` per admission, the
prompt right-padded to its power-of-two *bucket* (:func:`prompt_bucket`).
The reference compiles one program per bucket; here the buckets keep the
admission shapes, and so its arithmetic, the same.

Modes:

* ``kv_mode="paged"``: KV rows live in fixed-size pages handed out by the
  pure allocator (``serve/paged.py``); the step gathers each slot's prefix
  through its block table, resident KV bytes track tokens written, and
  admission is judged in free pages (:meth:`SlotEngine.can_admit`).
  ``"contiguous"`` keeps the worst-case-row pool.
* ``width > 1`` (the reference's tensor-parallel serving over a
  ``(replica, width)`` mesh) waits for tensor parallelism and raises
  ``NotPortedError`` naming A11.
* per-request sampling: temperature / top-k picks keyed on ``(request
  id, emission index, serve seed)`` (``serve/sampling.py``), so every rank
  derives the same token and a replay reproduces the stream.
  ``temperature == 0`` (default) is greedy.

Determinism: given the same model, seed and sequence of admit / step /
release calls, an engine produces the same tokens on the same device: the
allocator is a pure state machine, the sampler's keys are pure functions
of the request, and the engine's shapes never change.

The engine's cache and its per-step tensors live on the model's device
(``gpt()`` puts the model on the GPU unless the caller names the CPU).
The reference also registers the cache and the compiled programs with its
memory plane (``obs/memplane.py``); that plane is observability, ROADMAP
A13, and is left out here.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..models.decode import (
    assign_slot, assign_slot_paged, decode_step, decode_step_paged,
    init_cache, init_paged_pool,
)
from . import sampling
from .paged import PagedKV, pages_for

__all__ = ["SlotEngine", "prompt_bucket", "kv_occupancy", "WIDTH_AXIS",
           "REPLICA_AXIS"]

_MIN_BUCKET = 8

# Mesh axis names of the reference's serving width shard (the (replica,
# width) view of its mesh conventions).
REPLICA_AXIS = "replica"
WIDTH_AXIS = "width"


def prompt_bucket(n: int, cache_len: int) -> int:
    """Pad target for an ``n``-token prefill: the next power of two
    (floor ``_MIN_BUCKET``), clamped to the cache length."""
    if n > cache_len:
        raise ValueError(
            f"prompt of {n} tokens exceeds the {cache_len}-token cache"
        )
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return min(b, cache_len)


def kv_occupancy(positions: Sequence[int], active_slots: Sequence[int],
                 cache_len: int, bytes_per_position: float,
                 pool_bytes: Optional[int] = None) -> dict:
    """Occupancy of a fixed-row KV slot pool (a copy of the reference's
    ``obs/memplane.py::kv_occupancy``).

    * ``allocated_bytes``: slots in use x worst-case ``cache_len`` rows.
    * ``live_bytes``: the positions those slots wrote.
    * ``waste_ratio``: ``1 - live / allocated`` (0.0 when idle), the bytes
      paged attention reclaims.
    * ``pool_bytes``: the whole pool's footprint, when given.
    """
    slots = sorted(set(int(s) for s in active_slots))
    allocated = len(slots) * int(cache_len) * float(bytes_per_position)
    live = 0.0
    for s in slots:
        pos = int(positions[s]) if 0 <= s < len(positions) else 0
        live += min(max(pos, 0), int(cache_len)) * float(bytes_per_position)
    out = {
        "slots_in_use": len(slots),
        "allocated_bytes": int(allocated),
        "live_bytes": int(live),
        "waste_ratio": (1.0 - live / allocated) if allocated else 0.0,
    }
    if pool_bytes is not None:
        out["pool_bytes"] = int(pool_bytes)
    return out


def _pick_tokens(logits, temps, topks, keys, sidx):
    """Per-slot token pick: each row samples with its request's key at its
    emission index (``sampling.sample_token``, the math the tests run).
    ``temps``, ``topks``, ``keys [n, 2]`` and ``sidx`` are host arrays;
    when no row samples, the pick is the argmax and no key is derived."""
    if not (np.asarray(temps) > 0).any():
        return torch.argmax(logits, dim=-1)
    dev = logits.device
    keys = sampling.token_key(torch.as_tensor(keys, device=dev),
                              torch.as_tensor(sidx, device=dev))
    return sampling.sample_token(logits, temps, topks, keys)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class SlotEngine:
    """A fixed pool of decode slots over one model.

    ``admit`` prefills a request into one slot (the other slots' caches
    are untouched); ``step`` runs one decode iteration for the active
    slots only (frozen rows ride along masked).  In paged mode eviction
    must be reported through :meth:`release_slot` so the slot's pages
    return to the free list; in contiguous mode an evicted slot is left
    out of the next step's mask and overwritten by the next admission.
    """

    def __init__(self, model, num_slots: int,
                 max_len: Optional[int] = None, *,
                 kv_mode: str = "contiguous",
                 page_size: int = 16,
                 num_pages: Optional[int] = None,
                 width: int = 1,
                 sample_seed: int = 0):
        if int(width or 1) > 1:
            from .. import NotPortedError  # noqa: PLC0415

            raise NotPortedError(
                f"width={width}: width-sharded serving is not ported "
                "yet (ROADMAP A11: tensor parallelism)")
        if kv_mode not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_mode {kv_mode!r}")
        self.model = model
        self.cfg = cfg = model.cfg
        self.num_slots = num_slots
        self.kv_mode = kv_mode
        self.width = 1
        self.sample_seed = int(sample_seed)
        self.device = next(model.parameters()).device
        # Serving context cap: never beyond the model's trained context (a
        # learned-positions model NaN-poisons past max_len, and prefill
        # rejects prompts beyond it).
        self.cache_len = int(max_len or cfg.max_len)
        self.serve_len = min(self.cache_len, int(cfg.max_len))

        self.paged: Optional[PagedKV] = None
        if kv_mode == "paged":
            self.page_size = int(page_size)
            mp = pages_for(self.cache_len, self.page_size)
            # Default pool: the worst case (every slot full); callers size
            # it down to save memory.
            self.num_pages = int(num_pages or num_slots * mp)
            self.paged = PagedKV(num_slots, self.num_pages,
                                 self.page_size, self.cache_len)
            # The virtual slot length the step sees (whole pages).
            self.cache_len = self.paged.max_pages_per_slot * self.page_size
            self.cache = init_paged_pool(model, self.num_pages,
                                         self.page_size, num_slots)
        else:
            self.cache = init_cache(model, num_slots, max_len)
            self.cache_len = int(self.cache["k"].shape[2])
            self.serve_len = min(self.cache_len, int(cfg.max_len))

        # Host-side per-slot state: current input token, sampling
        # parameters, request stream root, emission index.
        self._cur = np.zeros(num_slots, np.int64)
        self._temp = np.zeros(num_slots, np.float32)
        self._topk = np.zeros(num_slots, np.int64)
        self._bkey = np.zeros((num_slots,) + sampling.KEY_SHAPE, np.int64)
        self._sidx = np.zeros(num_slots, np.int64)
        self._tables_dev: Optional[torch.Tensor] = None

    def _tables(self) -> torch.Tensor:
        """Device block tables, kept until an admit / release / page
        allocation changes them."""
        if self._tables_dev is None:
            rows = [self.paged.table_row(s) for s in range(self.num_slots)]
            self._tables_dev = torch.tensor(rows, dtype=torch.int64,
                                            device=self.device)
        return self._tables_dev

    # --------------------------------------------------------- admission

    def can_admit(self, total_len: int) -> bool:
        """Paged mode: does the pool have free pages for this request's
        worst case (prompt + full token budget) on top of every active
        commitment?  Contiguous mode: a free slot is always enough.  A
        round admitting several requests uses :meth:`admission_gate`."""
        if self.paged is None:
            return True
        return self.paged.can_admit(int(total_len))

    def admission_gate(self):
        """One scheduling round's capacity gate ``gate(req, resume) ->
        bool``, accumulating the round's accepted worst cases."""
        if self.paged is None:
            return lambda req, resume: True
        page_gate = self.paged.admission_gate()

        def gate(req, resume) -> bool:
            return page_gate(len(req.prompt) + req.max_new_tokens)

        return gate

    def admit(self, slot: int, prompt: Sequence[int],
              resume: Sequence[int] = (), *,
              total_len: Optional[int] = None,
              temperature: float = 0.0, top_k: int = 0,
              rid: str = "") -> Optional[int]:
        """Prefill ``prompt`` (plus the already emitted ``resume`` tokens
        on a replay) into ``slot``.

        Fresh request: returns its first generated token (emission index
        0 with the request's key; greedy when ``temperature == 0``).
        Replay: the slot is rebuilt to the cache state of the stream so
        far and None is returned; the next ``step`` samples at emission
        index ``len(resume)``.

        ``total_len`` (paged mode): the request's worst case, ``prompt +
        max_new_tokens`` rows, which the allocator commits so a mid-decode
        page allocation never fails; default the serving context.
        """
        if resume:
            seq = list(prompt) + list(resume[:-1])
            cur = int(resume[-1])
        else:
            seq = list(prompt)
            cur = None
        bucket = prompt_bucket(len(seq), self.serve_len)
        padded = np.zeros(bucket, np.int64)
        padded[:len(seq)] = seq
        tokens = torch.as_tensor(padded, device=self.device)
        bkey = sampling.request_key(self.sample_seed, rid)
        if self.paged is not None:
            total = int(total_len or self.serve_len)
            self.paged.admit(slot, len(seq), max(total, len(seq)))
            self._tables_dev = None
            self.cache, last = assign_slot_paged(
                self.model, self.cache, self._tables(), slot, tokens,
                len(seq))
        else:
            self.cache, last = assign_slot(self.model, self.cache, slot,
                                           tokens, len(seq))
        self._temp[slot] = temperature
        self._topk[slot] = top_k
        self._bkey[slot] = bkey.numpy()
        if cur is not None:
            self._cur[slot] = cur
            self._sidx[slot] = len(resume)
            return None
        tok = int(sampling.sample_token(
            last, temperature, top_k,
            sampling.token_key(bkey.to(self.device), 0)))
        self._cur[slot] = tok
        self._sidx[slot] = 1
        return tok

    def release_slot(self, slot: int) -> None:
        """Evict: return the slot's pages to the free list (no-op in
        contiguous mode: the next admission overwrites the rows)."""
        if self.paged is not None:
            self.paged.release(slot)
            self._tables_dev = None

    # ------------------------------------------------------------ decode

    def step(self, active: Iterable[int]) -> Dict[int, int]:
        """One decode iteration: every slot in ``active`` consumes its
        current token and emits the next; the others are frozen.  Returns
        ``{slot: token}`` for the active slots."""
        slots: List[int] = sorted(active)
        if not slots:
            return {}
        mask = np.zeros(self.num_slots, bool)
        mask[slots] = True
        cur = torch.as_tensor(self._cur, device=self.device)
        write_mask = torch.as_tensor(mask, device=self.device)
        if self.paged is not None:
            # A slot whose next position starts a page gets one (cannot
            # fail under the commitment invariant); the device tables
            # refresh only when an allocation changed them.
            for s in slots:
                if self.paged.ensure_capacity(s):
                    self._tables_dev = None
            logits, self.cache = decode_step_paged(
                self.model, self.cache, self._tables(), cur, write_mask)
        else:
            logits, self.cache = decode_step(self.model, self.cache, cur,
                                             write_mask)
        toks = _pick_tokens(logits, np.where(mask, self._temp, 0.0),
                            self._topk, self._bkey, self._sidx)
        toks = toks.cpu().numpy()
        out = {}
        for s in slots:
            self._cur[s] = toks[s]
            self._sidx[s] += 1
            if self.paged is not None:
                self.paged.advance(s)
            out[s] = int(toks[s])
        return out

    # --------------------------------------------------------- profiling

    def step_flops(self) -> float:
        """Model FLOPs of one ``decode_step`` over the full slot pool,
        counted from the shapes (the reference reads XLA's cost model).
        With ``b`` slots, ``L`` layers, width ``e``, kv width ``e_kv =
        kv_heads x head_dim``, MLP ratio ``r``, vocabulary ``V`` and cache
        length ``S``::

            L x (2 b e (e + 2 e_kv)      qkv
                 + 2 b e e               proj
                 + 4 b r e e             fc1, fc2
                 + 4 b e S)              q.K over S keys, p.V
            + 2 b e V                    LM head

        Attention is counted over the whole cache length the step reads
        (masked positions included), as the einsum computes them."""
        cfg = self.cfg
        b, e, s = self.num_slots, cfg.emb_dim, self.cache_len
        e_kv = cfg.kv_heads * cfg.head_dim
        per_layer = (2 * b * e * (e + 2 * e_kv) + 2 * b * e * e
                     + 4 * b * cfg.mlp_ratio * e * e + 4 * b * e * s)
        return float(cfg.num_layers * per_layer
                     + 2 * b * e * cfg.vocab_size)

    # ------------------------------------------------------ kv occupancy

    def kv_stats(self, active: Iterable[int] = ()) -> dict:
        """Allocated against live KV bytes.  Contiguous mode: each busy
        slot charged its full ``cache_len`` row (:func:`kv_occupancy`).
        Paged mode: pages actually handed out (the only waste is each
        slot's partial last page), the page-pool gauges, and what the
        contiguous design would reserve for the same busy slots."""
        pool = _nbytes(self.cache["k"]) + _nbytes(self.cache["v"])
        if self.paged is not None:
            per_pos = pool / float(self.num_pages * self.page_size)
            out = self.paged.stats(per_pos)
            out["pool_bytes"] = pool
            out["contiguous_equiv_bytes"] = int(
                out["slots_in_use"] * self.cache_len * per_pos
            )
            return out
        per_pos = pool / float(self.num_slots * self.cache_len)
        positions = self.cache["pos"].cpu().reshape(-1).tolist()
        if len(positions) < self.num_slots:  # legacy scalar pos
            positions = [positions[0] if positions else 0] * self.num_slots
        return kv_occupancy(positions, list(active), self.cache_len,
                            per_pos, pool_bytes=pool)

    # ---------------------------------------------------------- hot swap

    def set_params(self, params) -> None:
        """Swap the served weights in place between decode steps:
        ``params`` is a state dict of the same model (names and shapes);
        the KV cache is untouched, in-flight requests continue over it."""
        own = self.model.state_dict()
        mismatch = sorted(set(own) ^ set(params)) or [
            n for n in own if tuple(params[n].shape) != tuple(own[n].shape)]
        if mismatch:
            raise ValueError(
                f"hot-swap params tree mismatch: {mismatch[:4]} differ "
                f"from the served model's; this checkpoint belongs to a "
                f"different model")
        with torch.no_grad():
            self.model.load_state_dict(params)

    # ------------------------------------------------------------- reset

    def reset(self) -> None:
        """Drop every slot: a fresh zero cache, a free page pool, zero
        cursors."""
        if self.paged is not None:
            self.paged.reset()
            self._tables_dev = None
            self.cache = init_paged_pool(self.model, self.num_pages,
                                         self.page_size, self.num_slots)
        else:
            self.cache = init_cache(self.model, self.num_slots,
                                    self.cache_len)
        self._cur[:] = 0
        self._temp[:] = 0.0
        self._topk[:] = 0
        self._bkey[:] = 0
        self._sidx[:] = 0
