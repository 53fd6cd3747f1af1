"""``python -m paddle_tpu_torch`` — see paddle_tpu_torch/cli.py."""

import sys

from paddle_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
