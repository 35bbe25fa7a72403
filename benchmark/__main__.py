"""``python -m benchmark ...``: the same as ``python3 benchmark/run.py ...``."""

import sys

from benchmark.run import main

sys.exit(main())
