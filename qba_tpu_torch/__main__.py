"""``python -m qba_tpu_torch`` — see :mod:`qba_tpu_torch.cli`."""

import sys

from qba_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
