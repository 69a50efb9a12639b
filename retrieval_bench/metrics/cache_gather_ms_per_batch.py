"""The program's ``cache.gather`` span per batch: each gallery block's
host gather from the maps at rest (only the enqueue where they lie on the
card), inside the ``cache`` stage on the calling thread. ``None`` where the
program has no such span."""


def read(run):
    s = run.stage_delta.get("cache.gather")
    return None if s is None else 1e3 * s / len(run.batch_seconds)
