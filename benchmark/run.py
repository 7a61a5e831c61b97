#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result as the last line
of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for (`BENCHMARK.json`).  Without them it exits non-zero and prints no result.
"""
import os
import sys
import time


def _process_start() -> float:
    """The process's start on the `perf_counter` clock (Linux: from
    /proc/self/stat; elsewhere: now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


if __name__ == "__main__":
    T_START = _process_start()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from benchmark.core import runner

    sys.exit(runner.main(sys.argv[1:], T_START))
