"""The program's ``cache`` stage (the gallery's maps at rest moved to the
card and its scoring cache built) per batch."""


def read(run):
    s = run.stage_delta.get("cache", 0.0)
    return 1e3 * s / len(run.batch_seconds) if s > 0 else None
