"""The tail of the window's step times (ms): where the host's issue
comes near the device's time, its hiccups show here first."""

from benchmark.readers import step_ms_p95 as read  # noqa: F401
