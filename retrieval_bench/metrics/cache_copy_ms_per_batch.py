"""The program's ``cache.copy`` span per batch: each gallery block's copy
to the card as the host sees it (from a pageable source the call returns
once every byte is staged), inside the ``cache`` stage on the calling
thread. ``None`` where the program has no such span."""


def read(run):
    s = run.stage_delta.get("cache.copy")
    return None if s is None else 1e3 * s / len(run.batch_seconds)
