"""Test-support machinery shipped with the package: the deterministic
fault-injection registry (the points of ``horovod_tpu/testing/faults.py``
that the port wires)."""

from . import faults  # noqa: F401
