"""The readers of the program's spans: ``cache.gather``, ``cache.copy``,
``lookahead-wait`` and the ``*.ingest-wait`` spans, over hand-built runs.
Each gives its value where the span is in the stage seconds, ``0.0`` where
it is there and empty, and ``None`` where it is missing (a program without
the span)."""

from __future__ import annotations

import pytest

from retrieval_bench.harness import Run
from retrieval_bench.metrics import (
    cache_copy_ms_per_batch,
    cache_gather_ms_per_batch,
    ingest_wait_ms_per_image,
    lookahead_wait_ms_per_batch,
)

PER_BATCH = {"cache_gather_ms_per_batch": (cache_gather_ms_per_batch, "cache.gather"),
             "cache_copy_ms_per_batch": (cache_copy_ms_per_batch, "cache.copy"),
             "lookahead_wait_ms_per_batch": (lookahead_wait_ms_per_batch, "lookahead-wait")}


def run_of(stages, batches=4, images=0):
    return Run(setup_s=1.0, window_s=5.0 * batches, batch_seconds=[5.0] * batches,
               marks=32 * batches, stage_delta=dict(stages), images_extracted=images,
               backbone_flop=0.0, ncc_flop=0.0, ncc_bound_s=0.0)


@pytest.mark.parametrize("name", PER_BATCH)
def test_per_batch_readers(name):
    reader, key = PER_BATCH[name]
    stages = {"cache": 8.0, "score": 12.0, key: 2.5}
    assert reader.read(run_of(stages)) == pytest.approx(1e3 * 2.5 / 4)
    assert reader.read(run_of({**stages, key: 0.0})) == 0.0
    assert reader.read(run_of({"cache": 8.0, "score": 12.0})) is None


def test_per_batch_readers_read_only_their_own_key():
    stages = {"cache": 8.0, "cache.gather": 3.0, "cache.copy": 1.0, "lookahead-wait": 0.2,
              "extract-query.ingest-wait": 9.0}
    got = {name: reader.read(run_of(stages)) for name, (reader, _) in PER_BATCH.items()}
    assert got == pytest.approx({"cache_gather_ms_per_batch": 750.0,
                                 "cache_copy_ms_per_batch": 250.0,
                                 "lookahead_wait_ms_per_batch": 50.0})


def test_ingest_wait_sums_the_calling_threads_waits_per_image():
    stages = {"extract-query": 1.0, "extract-query.ingest-wait": 0.25,
              "extract-gallery": 6.0, "extract-gallery.ingest-wait": 1.75,
              "cache.gather": 4.0}
    run = run_of(stages, batches=2, images=2 * (16 + 1175))
    assert ingest_wait_ms_per_image.read(run) == pytest.approx(1e3 * 2.0 / (2 * 1191))
    empty = {k: (0.0 if k.endswith(".ingest-wait") else v) for k, v in stages.items()}
    assert ingest_wait_ms_per_image.read(run_of(empty, images=1191)) == 0.0


def test_ingest_wait_without_a_wait_or_an_image_is_none():
    no_wait = {"extract-query": 1.0, "extract-gallery": 6.0, "ingest": 2.0}
    assert ingest_wait_ms_per_image.read(run_of(no_wait, images=1191)) is None
    waits = {"extract-query.ingest-wait": 0.5}
    assert ingest_wait_ms_per_image.read(run_of(waits, images=0)) is None
