"""The end-to-end reader: the rate over whole batches."""

from __future__ import annotations

from retrieval_bench.harness import Run
from retrieval_bench.metrics import marks_per_s


def run_of(seconds, marks_each=32):
    return Run(setup_s=1.0, window_s=sum(seconds),
               batch_seconds=list(seconds), marks=marks_each * len(seconds), stage_delta={},
               images_extracted=0, backbone_flop=0.0, ncc_flop=0.0, ncc_bound_s=0.0)


def test_rate_counts_whole_batches_over_the_whole_window():
    run = run_of([4.0, 4.5, 3.5])   # the third batch crossed a 10 s mark
    assert marks_per_s.read(run) == 96 / 12.0
