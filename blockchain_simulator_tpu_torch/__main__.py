"""``python -m blockchain_simulator_tpu_torch`` — see cli.py."""

import sys

from blockchain_simulator_tpu_torch.cli import main

sys.exit(main())
