"""The device's idle share of the traced steps (%)."""

from benchmark.readers import idle_pct as read  # noqa: F401
