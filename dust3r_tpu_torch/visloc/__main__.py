"""`python -m dust3r_tpu_torch.visloc`: see `cli.py`."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
