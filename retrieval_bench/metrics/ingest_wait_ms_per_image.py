"""The program's ``<stage>.ingest-wait`` spans on the calling thread
(``extract-query.ingest-wait``, ``extract-gallery.ingest-wait``) per image
extracted: the extracting thread's wait for the stream worker's next
prepared chunk. ``None`` where the calling thread has no such span (its
extraction not streamed, or on the lookahead thread) or extracted
nothing."""


def read(run):
    waits = [v for k, v in run.stage_delta.items() if k.endswith(".ingest-wait")]
    if not waits or not run.images_extracted:
        return None
    return 1e3 * sum(waits) / run.images_extracted
