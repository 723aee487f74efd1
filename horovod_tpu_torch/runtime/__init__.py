"""Runtime knobs of horovod_tpu_torch (counterpart of
``horovod_tpu/runtime/``; only what the port calls so far)."""
