"""Environment knob names and parsing (counterpart of
``horovod_tpu/utils/env.py``, copied, not imported: only the names this
package reads).

The rendezvous contract is the ``hvdrun`` launcher's (``HVDTPU_*``);
``torchrun``'s names are read when those are absent.
"""

from __future__ import annotations

import os

# hvdrun's per-rank environment (horovod_tpu/basics.py:244-306)
RANK = "HVDTPU_RANK"
SIZE = "HVDTPU_SIZE"
LOCAL_RANK = "HVDTPU_LOCAL_RANK"
LOCAL_SIZE = "HVDTPU_LOCAL_SIZE"
CROSS_RANK = "HVDTPU_CROSS_RANK"
CROSS_SIZE = "HVDTPU_CROSS_SIZE"
COORDINATOR = "HVDTPU_COORDINATOR"  # host:port of the rendezvous store
START_TIMEOUT = "HVDTPU_START_TIMEOUT"

# torchrun's per-rank environment
TORCHRUN_RANK = "RANK"
TORCHRUN_WORLD_SIZE = "WORLD_SIZE"
TORCHRUN_LOCAL_RANK = "LOCAL_RANK"
TORCHRUN_LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"
TORCHRUN_GROUP_RANK = "GROUP_RANK"
TORCHRUN_MASTER_ADDR = "MASTER_ADDR"
TORCHRUN_MASTER_PORT = "MASTER_PORT"

# Tensor fusion: grouped_allreduce bins per dtype up to this many bytes
# (reference operations.cc:419 default of 64 MB).
FUSION_THRESHOLD = "HVDTPU_FUSION_THRESHOLD"
DEFAULT_FUSION_BYTES = 64 * 1024 * 1024


def env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default
