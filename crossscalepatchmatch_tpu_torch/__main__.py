"""python -m crossscalepatchmatch_tpu_torch: the command-line driver
(cli.main)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
