"""The reference's examples (``examples/*.py`` of the JAX package) on the
port, one module each with ``main(argv=None)``::

    python -m horovod_tpu_torch.examples.mnist --smoke
    python -m horovod_tpu_torch.run -np 2 python -m horovod_tpu_torch.examples.mnist --smoke

Each keeps the reference example's flags, makes its synthetic data from
``--seed`` (nothing is downloaded), runs on this process's GPU unless
``--cpu`` is given, and prints, on rank 0, one JSON line last with its
figures (``{"example": name, ...}``).  ``keras_mnist`` and ``tf2_mnist``
need TensorFlow (the port's ``interop`` frontends); without it they raise
``ImportError`` naming it.
"""

NAMES = ("adasum_small_model", "bert_style", "checkpoint_resume",
         "cluster_run", "elastic_train", "estimator_train", "keras_mnist",
         "long_context_zigzag", "mnist", "pipeline_train",
         "synthetic_benchmark", "tf2_mnist", "torch_mnist")
