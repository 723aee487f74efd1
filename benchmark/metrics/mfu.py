"""The whole training step's model FLOPs utilisation (%)."""

from benchmark.readers import mfu_pct as read  # noqa: F401
