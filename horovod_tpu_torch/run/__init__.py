"""hvdrun — the port's launcher (counterpart of ``horovod_tpu/run``;
reference: horovod/run, the ``horovodrun`` CLI).

Starts N worker processes (local or over ssh), gives each its
rank / local_rank / cross_rank slot and the rendezvous address of a
``torch.distributed`` world, and maps CLI and config knobs onto
``HVDTPU_*`` env vars for every rank; ``--elastic`` runs the elastic
launcher instead (failure detection, respawn, the KV rendezvous).

Entry point: ``python -m horovod_tpu_torch.run -np 4 python train.py``;
the function-shipping API ``run(fn, np=4)`` (:mod:`.api`) returns each
rank's result, and ``horovod_tpu_torch.elastic.launch`` ships a function
to elastic workers.
"""

from .api import run  # noqa: F401
from .runner import main, parse_args  # noqa: F401
