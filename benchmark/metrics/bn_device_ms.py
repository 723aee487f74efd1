"""Device ms a step of the BatchNorm kernels the data file names."""

from benchmark.readers import device_ms as read  # noqa: F401
