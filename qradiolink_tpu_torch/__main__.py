"""`python -m qradiolink_tpu_torch modes | rx | tx | loopback` (app/cli.py)."""

import sys

from qradiolink_tpu_torch.app.cli import main

if __name__ == "__main__":
    sys.exit(main())
