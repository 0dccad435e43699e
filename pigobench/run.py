"""The benchmark of pigo_tpu_torch: one run of one cell (lib/harness.py).

    python3 pigobench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

`setup_s` is timed from the start of this file: the interpreter's own
start before it (some 50 ms) is not counted, as no clock of the process
reads it reliably on every host.
"""

import os
import sys
import time

T_ENTRY = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pigobench.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_ENTRY))
