"""``python -m lzma_tpu_torch e|d [switches] in out`` (see cli.py)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
