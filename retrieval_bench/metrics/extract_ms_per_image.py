"""The program's ``ingest``, ``extract-query`` and ``extract-gallery``
stages per image extracted. Read only where those stages run on the
calling thread inside the window (each job one cluster, no lookahead);
where the window's extraction runs on the lookahead thread they hold
nothing of it, and the reader returns nothing."""

STAGES = ("ingest", "extract-query", "extract-gallery")


def read(run):
    s = sum(run.stage_delta.get(k, 0.0) for k in STAGES)
    return 1e3 * s / run.images_extracted if s > 0 and run.images_extracted else None
