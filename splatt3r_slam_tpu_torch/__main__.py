"""`python -m splatt3r_slam_tpu_torch`: the SLAM run (see `cli.py`)."""

import sys

from splatt3r_slam_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
