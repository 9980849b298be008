"""``python -m rife_tpu_torch`` — same CLI as ``python -m rife_tpu_torch.cli``
(the reference ships a single binary; this is the module-level equivalent)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
