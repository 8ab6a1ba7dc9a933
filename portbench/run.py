"""Run one benchmark cell once and print its result as one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program (``ray_tpu_torch``).
"""

import os
import sys

# The checkout's root, not this folder, goes first on the path: the
# benchmark's modules are imported as ``portbench.*``.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
