"""``horovod_tpu_torch.interop.keras`` — alias of :mod:`.tf_keras`
(counterpart of ``horovod_tpu/interop/keras.py``).

The reference exposes the same Keras bindings twice (``horovod.keras`` and
``horovod.tensorflow.keras``, both delegating to the shared ``horovod._keras``
impl); scripts migrate from either spelling.
"""

from .tf_keras import *  # noqa: F401,F403
from .tf_keras import callbacks, load_model  # noqa: F401
