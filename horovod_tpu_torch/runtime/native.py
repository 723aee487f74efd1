"""ctypes binding to the native eager engine (counterpart of
``horovod_tpu/runtime/native.py``): the port's copy of the reference's C++
engine, ``csrc/engine/``, built at first use into ``_build/`` by
``runtime/native_build.py``.

Reference: horovod/common/basics.py loads the built shared library and
wraps its ``extern "C"`` surface (operations.cc:661-799); async handles
follow horovod/torch/handle_manager.cc.  :class:`NativeEngine` has the
Python :class:`~horovod_tpu_torch.runtime.engine.EagerEngine`'s interface
(``enqueue`` / ``join`` / ``barrier`` / ``shutdown`` returning futures),
so ``ops/eager.py`` does not know which engine runs; ``_engine_registry``
selects this one for ``HVDTPU_EAGER_ENGINE=native``.

Division of labour: Python exchanges the engine's TCP addresses (a
fixed-width all-gather on the world's gloo group, the analog of the
reference's gloo rendezvous, gloo_context.cc:113-157) and hands the C++
engine the whole eager path: the TCP mesh, rank-0 negotiation, the
response cache, fusion, the ring and VHDD collectives, the timeline and
stall inspection.  Even a world of one runs the C++ cycle.

The TCP wire carries host bytes, as the reference's does, and the port
gives it no device plane.  A CUDA payload is copied to pinned host memory
on the caller's current stream, behind whatever wrote it there (the hook
optimizer's gradients are still being written when their hooks fire),
and handed to the engine only once that copy's event has completed; the
pump thread hands payloads over in enqueue order.  Each result goes back
to its input's device on a stream of the binding's, and ``synchronize``
makes the caller's stream wait on its completion event, as it does for
the Python engine's results.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Deque, Dict, Optional

import torch
import torch.distributed as dist

from ..basics import global_topology
from ..exceptions import HorovodShutdownError
from ..obs import flightrec as obs_flightrec
from ..obs import get_registry
from ..obs import progress as obs_progress
from ..obs import trace as obs_trace
from ..testing.faults import maybe_fail
from ..utils import env as envmod
from . import native_build
from . import timeline as timeline_mod
from .engine import SHUT_DOWN_ERROR
from .messages import RequestType

LOG = logging.getLogger(__name__)

# DataType enum of csrc/engine/common.h
_DTYPES = {
    torch.uint8: 0,
    torch.int8: 1,
    torch.int32: 2,
    torch.int64: 3,
    torch.float16: 4,
    torch.bfloat16: 5,
    torch.float32: 6,
    torch.float64: 7,
    torch.bool: 8,
}
# the fixed width of one rank's "host:port" in the address exchange
_ADDR_BYTES = 64
# hvdtpu_stats's slots, in order
_STATS = ("cycles", "responses", "fused_responses", "largest_response_bytes")


def _load(path) -> ctypes.CDLL:
    """The library at ``path`` with every function's signature declared
    (the reference's ``_load``, native.py:73-115, and ``hvdtpu_stats``)."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"native engine: cannot load {path}: {e}") from e
    ll, i, d, p, s = (ctypes.c_longlong, ctypes.c_int, ctypes.c_double,
                      ctypes.c_void_p, ctypes.c_char_p)
    sigs = {
        "hvdtpu_listen": (i, []),
        "hvdtpu_connect": (i, [i, i, s, ll, d, i, d, d, s, i]),
        "hvdtpu_enqueue": (ll, [i, s, p, ctypes.POINTER(ll), i, i, i, i, d,
                                d]),
        "hvdtpu_join": (ll, []),
        "hvdtpu_poll": (i, [ll]),
        "hvdtpu_error": (s, [ll]),
        "hvdtpu_result_nbytes": (ll, [ll]),
        "hvdtpu_result_ndim": (i, [ll]),
        "hvdtpu_result_shape": (None, [ll, ctypes.POINTER(ll)]),
        "hvdtpu_result_copy": (i, [ll, p]),
        "hvdtpu_release": (None, [ll]),
        "hvdtpu_shutdown": (None, []),
        "hvdtpu_is_shutdown": (i, []),
        "hvdtpu_set_params": (None, [ll, d, i]),
        "hvdtpu_perf_bytes": (ll, []),
        "hvdtpu_stats": (None, [ctypes.POINTER(ll)]),
        "hvdtpu_get_fusion_bytes": (ll, []),
        "hvdtpu_get_cycle_ms": (d, []),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _my_ip() -> str:
    """Routable address of this host (the TCP mesh spans hosts)."""
    host = os.environ.get(envmod.MESH_ADDR)
    if host:
        return host
    from ..run.allocate import routable_ip  # noqa: PLC0415

    coordinator = os.environ.get(envmod.COORDINATOR, "")
    probe = coordinator.rsplit(":", 1)[0] if coordinator else "127.0.0.1"
    return routable_ip(probe)


@dataclass
class _Op:
    """One enqueued op on its way to the C++ engine and back.  ``payload``
    is the host tensor to hand over (pinned for a CUDA input; dropped once
    the engine has copied it), ``ready`` the event after its copy from the
    card, ``device`` where a CUDA input's result goes."""

    op: RequestType
    name: str
    dtype: Optional[torch.dtype]
    payload: Optional[torch.Tensor]
    ready: Optional[torch.cuda.Event]
    device: Optional[torch.device]
    future: concurrent.futures.Future
    reduce_op: int
    root_rank: int
    prescale: float
    postscale: float
    t_enq: Optional[float]


class NativeEngine:
    """Eager engine backed by the port's build of the C++ engine (the
    reference's drop-in for ``EagerEngine``)."""

    def __init__(self):
        topo = global_topology()
        self.rank = topo.process_rank
        self.world = topo.process_count
        self.lib = _load(native_build.build())
        # The engine-cycle internals live in C++, but completed collectives
        # resolve here: counting them here keeps the metrics dump and the
        # progress beat engine-agnostic.
        self._m_completed = get_registry().counter(
            "engine.collectives_completed")

        # The hierarchical knob has no consumer in the TCP data plane; say
        # so instead of silently ignoring it.
        if envmod.env_bool(envmod.HIERARCHICAL_ALLREDUCE):
            LOG.warning(
                "hierarchical allreduce requested but the native TCP data "
                "plane has no two-level schedule; downgrading to flat (use "
                "HVDTPU_EAGER_ENGINE=python for the two-level NCCL path)")

        port = self.lib.hvdtpu_listen()
        if port < 0:
            raise RuntimeError("native engine: listen failed (is another "
                               "native engine running in this process?)")
        addrs = self._exchange_addrs(f"{_my_ip()}:{port}", topo)

        fusion = envmod.env_int(envmod.FUSION_THRESHOLD,
                                envmod.DEFAULT_FUSION_BYTES)
        cycle_ms = envmod.env_float(envmod.CYCLE_TIME, 5.0)
        cache_cap = envmod.env_int(envmod.CACHE_CAPACITY, 1024)
        stall_warn = envmod.env_float(envmod.STALL_CHECK_TIME, 60.0)
        stall_shutdown = envmod.env_float(envmod.STALL_SHUTDOWN_TIME, 0.0)
        if envmod.env_bool(envmod.STALL_CHECK_DISABLE):
            stall_warn = 1e18
        # each rank writes its own file (the C++ writer stamps pid=rank);
        # the launcher merges them at the job's end (obs/timeline_merge.py)
        raw_timeline = os.environ.get(envmod.TIMELINE, "")
        timeline_path = (timeline_mod.resolve_path(raw_timeline, self.rank)
                         if raw_timeline else "")
        mark_cycles = 1 if envmod.env_bool(envmod.TIMELINE_MARK_CYCLES) else 0
        rc = self.lib.hvdtpu_connect(
            self.rank, self.world, ",".join(addrs).encode(), fusion,
            cycle_ms, cache_cap, stall_warn, stall_shutdown,
            timeline_path.encode(), mark_cycles)
        if rc != 0:
            raise RuntimeError(f"native engine: mesh connect failed (rc={rc})")

        self._lock = threading.Lock()
        self._staged: Deque[_Op] = collections.deque()
        self._outstanding: Dict[int, _Op] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._pump_wake = threading.Event()
        self._stop = False
        self._closed = False
        self._barrier_seq = 0
        # ops handed to the engine; CUDA payloads copied to the host
        self.counts = {"enqueued": 0, "device_payloads": 0,
                       "device_payload_bytes": 0}
        self._pump = threading.Thread(target=self._pump_loop,
                                      name="hvdtpu_native_pump", daemon=True)
        self._pump.start()

        # Autotune (reference parameter_manager.cc): rank 0 runs the tuner
        # against the engine's bytes counter; proposals go down through
        # hvdtpu_set_params and ride the negotiation to every rank.
        self._tuner: Optional[threading.Thread] = None
        if self.rank == 0 and envmod.env_bool(envmod.AUTOTUNE):
            from .autotune import (  # noqa: PLC0415
                ParameterManager,
                TunedParams,
                build_categories,
            )

            self._pm = ParameterManager(
                enabled=True,
                initial=TunedParams(fusion_bytes=fusion,
                                    cycle_s=cycle_ms / 1000.0),
                log_path=os.environ.get(envmod.AUTOTUNE_LOG) or None,
                # the fusion and cycle knobs and the cache toggle; the TCP
                # plane has no two-level schedule and no schedule replay
                categories=build_categories(
                    multislice=topo.num_slices > 1, replay_enabled=False,
                    hierarchical_capable=False),
            )
            self._tuner = threading.Thread(
                target=self._tuner_loop, name="hvdtpu_autotune", daemon=True)
            self._tuner.start()

    # ---------------------------------------------------------- rendezvous

    def _exchange_addrs(self, mine: str, topo) -> list:
        """Every rank's ``host:port``: a fixed-width all-gather on the
        world's gloo group (the engine's control group)."""
        if self.world == 1:
            return [mine]
        raw = mine.encode()
        if len(raw) > _ADDR_BYTES:
            raise ValueError(f"address too long: {mine}")
        buf = torch.zeros(_ADDR_BYTES, dtype=torch.uint8)
        buf[:len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
        out = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(out, buf, group=topo.engine_groups.control)
        return [bytes(t.tolist()).rstrip(b"\0").decode() for t in out]

    # ----------------------------------------------------------------- API

    def enqueue(self, op: RequestType, name: str,
                tensor: Optional[torch.Tensor], *, reduce_op: int = 0,
                root_rank: int = -1, prescale: float = 1.0,
                postscale: float = 1.0) -> concurrent.futures.Future:
        # the same chaos point and black-box event as the Python engine's
        # enqueue: fault specs and post-mortems do not depend on the engine
        maybe_fail("enqueue", name=name)
        obs_flightrec.record("enqueue", name=name, detail=op.name)
        fut: concurrent.futures.Future = concurrent.futures.Future()
        if tensor is not None and tensor.dtype not in _DTYPES:
            fut.set_exception(TypeError(
                f"unsupported dtype for eager collectives: {tensor.dtype}"))
            return fut
        payload, ready, device = self._to_host(tensor)
        item = _Op(op, name, None if tensor is None else tensor.dtype,
                   payload, ready, device, fut, int(reduce_op),
                   int(root_rank), float(prescale), float(postscale),
                   time.time() if obs_trace.enabled() else None)
        with self._lock:
            if self._stop:
                fut.set_exception(HorovodShutdownError(SHUT_DOWN_ERROR))
                return fut
            if ready is None and not self._staged:
                self._submit(item)
            else:
                if ready is None and payload is not None:
                    # behind a CUDA payload still on its way: the caller
                    # may reuse its tensor before this one is handed over
                    item.payload = payload.clone()
                self._staged.append(item)
        self._pump_wake.set()
        return fut

    def _to_host(self, tensor: Optional[torch.Tensor]):
        """``(payload, ready, device)``.  A CPU tensor is handed over as it
        is (the engine copies it at enqueue).  A CUDA tensor is copied into
        pinned memory on the caller's current stream, and ``ready`` is
        recorded after the copy."""
        if tensor is None:
            return None, None, None
        src = tensor.detach()
        if not src.is_cuda:
            return src.contiguous(), None, None
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        with self._lock:
            self.counts["device_payloads"] += 1
            self.counts["device_payload_bytes"] += host.numel() * \
                host.element_size()
        return host, ready, src.device

    def _submit(self, item: _Op) -> None:
        """Hand ``item`` to the C++ engine (with ``_lock`` held, so ops
        reach it in enqueue order)."""
        t = item.payload
        if t is not None:
            shape = tuple(t.shape)
            data = ctypes.c_void_p(t.data_ptr())
            code = _DTYPES[t.dtype]
        else:
            shape, data, code = (), None, _DTYPES[torch.float32]
        shape_arr = (ctypes.c_longlong * max(len(shape), 1))(*shape)
        handle = self.lib.hvdtpu_enqueue(
            int(item.op), item.name.encode(), data, shape_arr, len(shape),
            code, item.reduce_op, item.root_rank, item.prescale,
            item.postscale)
        item.payload = None  # the engine copied it
        self._outstanding[handle] = item
        self.counts["enqueued"] += 1

    def join(self) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._drain_staged()
        with self._lock:
            handle = self.lib.hvdtpu_join()
            self._outstanding[handle] = _Op(
                RequestType.JOIN, "join", None, None, None, None, fut, 0, -1,
                1.0, 1.0, None)
        self._pump_wake.set()
        return fut

    def barrier(self) -> concurrent.futures.Future:
        # Sequence-numbered: overlapping barriers queue instead of hitting
        # the duplicate-name guard; the Nth call on every rank pairs up.
        with self._lock:
            self._barrier_seq += 1
            seq = self._barrier_seq
        return self.enqueue(RequestType.BARRIER, f"hvdtpu.barrier.{seq}",
                            None)

    @property
    def stats(self) -> dict:
        """The engine's counters: cycles, responses executed, fused
        responses, the largest fused allreduce's bytes, the bytes its
        collectives moved (``wire_bytes``, the autotuner's score), and the
        binding's ops handed over and CUDA payloads copied to the host."""
        buf = (ctypes.c_longlong * len(_STATS))()
        self.lib.hvdtpu_stats(buf)
        out = dict(zip(_STATS, buf))
        out["wire_bytes"] = self.lib.hvdtpu_perf_bytes()
        with self._lock:
            out.update(self.counts)
        return out

    # ------------------------------------------------------------ autotune

    def _tuner_loop(self) -> None:
        """Rank 0's scoring loop: one tick per engine cycle of wall clock;
        scores the bytes counter's delta and pushes the tuner's moves into
        the engine (reference parameter_manager.cc's Update / Tune
        cadence)."""
        last_bytes = 0
        while not self._stopping() and not self.lib.hvdtpu_is_shutdown():
            time.sleep(max(self.lib.hvdtpu_get_cycle_ms() / 1000.0, 0.001))
            now_bytes = self.lib.hvdtpu_perf_bytes()
            self._pm.record_bytes(now_bytes - last_bytes)
            last_bytes = now_bytes
            proposal = self._pm.cycle()
            if proposal is not None:
                self.lib.hvdtpu_set_params(
                    proposal.fusion_bytes, proposal.cycle_s * 1000.0,
                    1 if proposal.cache_enabled else 0)
            if self._pm.converged:
                return

    def _stopping(self) -> bool:
        with self._lock:
            return self._stop

    def shutdown(self) -> None:
        """Coordinated shutdown (the C++ engine's flag rides the next
        negotiation; a peer's pending ops fail with
        ``HorovodShutdownError``).  Ops still waiting on their copy from
        the card fail the same way."""
        with self._lock:
            if self._closed:
                return
            self._closed = self._stop = True
            staged, self._staged = list(self._staged), collections.deque()
        for item in staged:
            item.future.set_exception(HorovodShutdownError(SHUT_DOWN_ERROR))
        self._pump_wake.set()
        self.lib.hvdtpu_shutdown()
        if self._pump.is_alive() and \
                threading.current_thread() is not self._pump:
            self._pump.join(timeout=10)
        if self._tuner is not None and self._tuner.is_alive():
            self._tuner.join(timeout=10)

    # ---------------------------------------------------------------- pump

    def _drain_staged(self) -> None:
        """Wait until every staged payload is handed to the engine."""
        while True:
            with self._lock:
                if not self._staged or self._stop:
                    return
            self._pump_wake.set()
            time.sleep(0.0005)

    def _hand_over(self) -> bool:
        """Hand the staged ops whose copies from the card are done to the
        engine, in order.  Returns whether any was."""
        moved = False
        with self._lock:
            while self._staged and (self._staged[0].ready is None
                                    or self._staged[0].ready.query()):
                self._submit(self._staged.popleft())
                moved = True
        return moved

    def _pump_loop(self) -> None:
        """Hand staged payloads over and resolve futures as native handles
        complete: one thread for all handles (the reference resolves
        through per-op callbacks; ctypes callbacks from a C++ thread are
        brittle at interpreter shutdown, polling from a Python thread is
        not)."""
        while True:
            progressed = self._hand_over()
            with self._lock:
                items = list(self._outstanding.items())
                idle = not items and not self._staged
                stop = self._stop
            if idle:
                if stop:
                    return
                self._pump_wake.wait(timeout=0.05)
                self._pump_wake.clear()
                continue
            for handle, item in items:
                st = self.lib.hvdtpu_poll(handle)
                if st == 0:
                    continue
                progressed = True
                with self._lock:
                    self._outstanding.pop(handle, None)
                try:
                    self._resolve(handle, st, item)
                finally:
                    self.lib.hvdtpu_release(handle)
            if not progressed:
                time.sleep(0.001)

    def _resolve(self, handle: int, st: int, item: _Op) -> None:
        fut, name = item.future, item.name
        if st != 1:
            msg = self.lib.hvdtpu_error(handle).decode()
            obs_flightrec.record("error", name=name, detail=msg[:200])
            if "same name as another tensor" in msg:
                exc: Exception = ValueError(msg)
            elif "has been shut down" in msg:
                exc = HorovodShutdownError(SHUT_DOWN_ERROR)
            else:
                exc = RuntimeError(msg)
            fut.set_exception(exc)
            return
        if item.op == RequestType.JOIN:
            fut.set_result(self.world - 1)
            return
        try:
            result = self._fetch_result(handle, item)
        except Exception as e:  # noqa: BLE001 - reported through the future
            fut.set_exception(e)
            return
        fut.set_result(result)
        # the progress beat, metrics and black-box source, with the Python
        # engine's semantics (_perform_operation)
        obs_flightrec.record("complete", name=name)
        self._m_completed.inc()
        obs_progress.tick()
        if item.t_enq is not None:
            obs_trace.add_span("engine", "collective", item.t_enq,
                               time.time(), op=name)

    def _fetch_result(self, handle: int, item: _Op):
        """The result as a tensor of the input's dtype on the input's
        device (None for a barrier).  A CUDA result is copied to the card
        on the binding's stream; the future carries the copy's event
        (``_hvd_done``), which ``synchronize`` makes the caller's stream
        wait on."""
        nbytes = self.lib.hvdtpu_result_nbytes(handle)
        ndim = self.lib.hvdtpu_result_ndim(handle)
        shape_arr = (ctypes.c_longlong * max(ndim, 1))()
        self.lib.hvdtpu_result_shape(handle, shape_arr)
        shape = tuple(shape_arr[i] for i in range(ndim))
        if nbytes == 0 and not shape:
            return None  # barrier
        dtype = item.dtype
        out = torch.empty(shape, dtype=dtype,
                          pin_memory=item.device is not None)
        if out.numel() * out.element_size() != nbytes:
            raise RuntimeError(f"native engine: {item.name}'s result holds "
                               f"{nbytes} bytes, not {shape} of {dtype}")
        if nbytes:
            self.lib.hvdtpu_result_copy(handle, ctypes.c_void_p(
                out.data_ptr()))
        if item.device is None:
            return out
        stream = self._streams.get(item.device)
        if stream is None:
            stream = self._streams[item.device] = torch.cuda.Stream(
                item.device)
        with torch.cuda.device(item.device), torch.cuda.stream(stream):
            res = out.to(item.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        item.future._hvd_done = done
        return res
