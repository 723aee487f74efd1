"""The benchmark of ``horovod_tpu_torch``, the PyTorch and CUDA port.
``python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` (see ``run.py``)."""
