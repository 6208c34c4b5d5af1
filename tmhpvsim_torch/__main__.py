import sys

from tmhpvsim_torch.cli import main

sys.exit(main())
