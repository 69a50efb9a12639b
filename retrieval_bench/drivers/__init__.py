"""Gallery-state modes, one module each, found by the ``mode`` a cell's
file names: ``drivers/<mode>.py`` defines ``Driver(pipeline_cls, config,
weights_dir, device, traffic)`` with ``step() -> Batch`` (one batch of
marks ranked; the harness times it), ``plan()`` (the cluster plan the
program made), ``stage_seconds()`` (the program's calling-thread stage
seconds so far) and ``close()``."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Batch:
    """One batch as the program returned it: its marks' files (sorted, the
    order of the rows), their true matches' ranks and gallery indices, the
    (marks, prints) score matrix in gallery-file order, and the images the
    batch extracted."""

    files: list[str]
    ranks: np.ndarray
    true_index: list[int]
    scores: np.ndarray
    extracted_marks: int
    extracted_prints: int
