"""The benchmark's own CPU tests: the repository's root on the path, so that
``portbench`` and ``tpuseg_torch`` import from any working directory."""
import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

# one thread a test process: the tests run in parallel workers
torch.set_num_threads(1)
