"""The NCC kernel's share of its roofline: the least time the chip could
take for the window's correlations (``flops.bound_seconds`` of the FLOP
and bytes these inputs need), over the device time of the ops whose names
match :data:`PATTERN` in the traced window."""

import re

PATTERN = re.compile(r"ncc_score")


def read(run):
    if run.trace is None:
        return None
    ms = sum(d for name, d in run.trace["device_events"] if PATTERN.search(name))
    if ms <= 0 or run.ncc_bound_s <= 0:
        return None
    return 100.0 * run.ncc_bound_s / (ms / 1e3)
