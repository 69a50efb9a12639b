"""The program's ``score`` stage on the calling thread (each stage ends in
a device synchronise), over the window."""


def read(run):
    s = run.stage_delta.get("score", 0.0)
    return 100.0 * s / run.window_s if s > 0 else None
