"""The host's issue time of a training step (ms, median of the window)."""

from benchmark.readers import host_issue_ms as read  # noqa: F401
