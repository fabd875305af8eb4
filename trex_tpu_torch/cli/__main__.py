"""``python -m trex_tpu_torch.cli``: the trex CLI."""
import sys

from .trex import main

if __name__ == "__main__":
    sys.exit(main())
