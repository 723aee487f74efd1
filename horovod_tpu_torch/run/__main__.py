"""``python -m horovod_tpu_torch.run`` — the hvdrun CLI entry point
(reference: bin/horovodrun -> run_commandline, runner.py:713)."""

import sys

from .runner import main

if __name__ == "__main__":
    sys.exit(main())
