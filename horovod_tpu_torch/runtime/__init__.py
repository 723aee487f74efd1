"""The eager-path runtime of horovod_tpu_torch (counterpart of
``horovod_tpu/runtime/``): the background engine (``engine``), its data
planes (``device_plane``), the negotiation protocol (``controller``,
``messages``, ``response_cache``), the timeline and the autotuner.  See
``runtime/engine.py`` for the architecture notes.  ``native.py`` binds the
C++ engine (the port's copy of its sources in ``csrc/engine/``, built by
``native_build.py``)."""
