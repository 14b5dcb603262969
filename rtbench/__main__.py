import sys

from rtbench.harness import main

sys.exit(main())
