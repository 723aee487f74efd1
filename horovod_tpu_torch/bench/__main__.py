"""``python -m horovod_tpu_torch.bench``: the bench's command line."""

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
