"""``python -m myraytracer_tpu_torch render|fit|bench`` (see cli.py)."""

import sys

from myraytracer_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
