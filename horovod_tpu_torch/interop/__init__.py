"""Framework frontends on the port's eager engine (counterpart of
``horovod_tpu/interop``): ``interop.torch``, the ``horovod.torch``
surface; ``interop.tf``, ``interop.tf_keras`` / ``interop.keras`` and
``interop.mxnet``, the ``horovod.tensorflow``, ``horovod.keras`` and
``horovod.mxnet`` surfaces on host tensors.  Importing this package
imports none of them: TensorFlow is imported only by ``interop.tf`` and
the Keras modules, and MXNet only when an MXNet entry point runs."""
