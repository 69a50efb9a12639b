"""The device's idle share of the traced window: 1 - the union of its
kernel, copy and set intervals over the window (``trace.trace_summary``)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * run.trace["summary"]["idle_share"]
