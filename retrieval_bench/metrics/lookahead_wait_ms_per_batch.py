"""The program's ``lookahead-wait`` span per batch: the calling thread's
wait for the lookahead thread's features, the part of the next batch's
extraction that the scoring did not hide. ``None`` where the program has no
such span (no lookahead, or a program without the span)."""


def read(run):
    s = run.stage_delta.get("lookahead-wait")
    return None if s is None else 1e3 * s / len(run.batch_seconds)
