"""Framework frontends on the port's eager engine (counterpart of
``horovod_tpu/interop``): ``interop.torch``, the ``horovod.torch``
surface."""
