"""The benchmark of fibergen_tpu_torch: one run of one cell.

    python3 fgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards.  The
last line of standard output is the result (JSON); the last lines of
standard error are the compared numbers beside their limits.  See
fgbench/README.md.
"""
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The process's start on the perf_counter clock (from /proc, to 10
    ms), or now where /proc does not say."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()
T_SCRIPT = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# Python's bytecode of everything the run imports (torch above all), kept
# in the checkout at a fixed path: where the interpreter is told not to
# write it (PYTHONDONTWRITEBYTECODE) beside sources that have none, every
# run would compile torch anew, some seconds that vary from run to run.
sys.pycache_prefix = str(ROOT / ".pycache")
sys.dont_write_bytecode = False

from fgbench.harness import cell  # noqa: E402

cell.SETUP += [("interpreter", T_SCRIPT), ("imports", time.perf_counter())]

if __name__ == "__main__":
    sys.exit(cell.main(sys.argv[1:], T_PROCESS))
