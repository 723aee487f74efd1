"""Wire messages for the eager-path negotiation protocol (a copy of
``horovod_tpu/runtime/messages.py``, which imports no JAX; the port keeps
its own copy so it never imports the JAX package).

Reference: horovod/common/message.h:47-194 (Request/RequestList/Response/
ResponseList, serialized with FlatBuffers, wire/message.fbs).  The TPU
build's control plane moves little data and already has a reliable ordered
transport (the coordination-service allgather), so the wire format is a
compact self-describing tuple encoding via pickle of primitive types —
the schema lives here, in one place, like message.fbs did.
"""

from __future__ import annotations

import enum
import pickle
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class RequestType(enum.IntEnum):
    """reference message.h:52-58."""

    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ADASUM = 4
    ALLTOALL = 5
    BARRIER = 6
    # 7 reserved (ResponseType.ERROR) — request->response maps by value
    REDUCESCATTER = 8


class ResponseType(enum.IntEnum):
    """reference message.h:137-144."""

    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ADASUM = 4
    ALLTOALL = 5
    BARRIER = 6
    ERROR = 7
    REDUCESCATTER = 8


@dataclass(frozen=True)
class Request:
    """One rank's declaration that a named tensor is ready
    (reference message.h:47-100)."""

    request_rank: int
    request_type: RequestType
    tensor_name: str
    dtype: str
    shape: Tuple[int, ...]
    reduce_op: int = 0  # ReduceOp value for ALLREDUCE/ADASUM
    root_rank: int = -1  # BROADCAST only
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    # Payload lives on an accelerator (reference Request::device,
    # message.h:47-100): when every rank's request is device-resident the
    # response executes on the device data plane (NCCL on CUDA tensors in
    # the port); any host payload demotes the whole op to the host plane.  Part of the negotiated
    # signature so the plane choice is identical on all ranks.
    device: bool = False

    def key(self) -> tuple:
        """Identity under negotiation (name + everything that must agree)."""
        return (self.tensor_name, self.request_type)


@dataclass
class RequestList:
    """reference message.h:103-129: requests + shutdown flag.

    `tuned_params` is the TPU build's parameter-sync channel: rank 0's
    autotuner attaches its current TunedParams wire tuple here and every
    rank applies it after negotiation — the descendant of the reference's
    rank-0 parameter Bcast (controller.cc:33-47 SynchronizeParameters)."""

    requests: List[Request] = field(default_factory=list)
    shutdown: bool = False
    joined: bool = False
    tuned_params: Optional[tuple] = None

    def serialize(self) -> bytes:
        payload = (
            [
                (
                    r.request_rank,
                    int(r.request_type),
                    r.tensor_name,
                    r.dtype,
                    tuple(r.shape),
                    r.reduce_op,
                    r.root_rank,
                    r.prescale_factor,
                    r.postscale_factor,
                    r.device,
                )
                for r in self.requests
            ],
            self.shutdown,
            self.joined,
            self.tuned_params,
        )
        return pickle.dumps(payload, protocol=4)

    @staticmethod
    def deserialize(data: bytes) -> "RequestList":
        reqs, shutdown, joined, tuned = pickle.loads(data)
        return RequestList(
            tuned_params=tuned,
            requests=[
                Request(
                    request_rank=a,
                    request_type=RequestType(b),
                    tensor_name=c,
                    dtype=d,
                    shape=tuple(e),
                    reduce_op=f,
                    root_rank=g,
                    prescale_factor=h,
                    postscale_factor=i,
                    device=j,
                )
                for (a, b, c, d, e, f, g, h, i, j) in reqs
            ],
            shutdown=shutdown,
            joined=joined,
        )


@dataclass
class Response:
    """Coordinator's instruction to execute one (possibly fused) op
    (reference message.h:132-194)."""

    response_type: ResponseType
    tensor_names: List[str]
    error_message: str = ""
    # Per-rank dim-0 sizes for ragged allgather (reference
    # Response::tensor_sizes, controller.cc:453-518).
    tensor_sizes: List[int] = field(default_factory=list)
