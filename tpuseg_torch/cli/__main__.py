import sys

from tpuseg_torch.cli.main import main

sys.exit(main())
