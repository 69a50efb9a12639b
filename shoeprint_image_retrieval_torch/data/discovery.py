"""Dataset discovery, image-ID parsing and query->gallery match resolution.

The port's own copy of ``shoeprint_image_retrieval_tpu/data/discovery.py``
(pure Python; kept identical so both packages index the same gallery).
Mirrors the reference dataloader's dataset conventions (reference
dataloader.py:29-113): a dataset directory containing ``Gallery/``
(shoeprints) and ``Query/`` (shoemarks); IDs parsed from filenames per
dataset type; matching pairs by gallery-index lookup, except FID-300 which
maps through ``label_table.csv`` (reference dataloader.py:97-107).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Sequence

DATASET_TYPES = ("FID-300", "Impress", "WVU2019")


def parse_image_id(filename: str, dataset_type: str) -> int:
    """Filename -> integer id (reference dataloader.py:244-250)."""
    if dataset_type == "Impress":
        return int(filename.split("_")[0].split(".")[0])
    if dataset_type == "WVU2019":
        return int(filename[:3])
    if dataset_type == "FID-300":
        return int(filename[:-4])
    raise ValueError(f"unknown dataset type {dataset_type!r}")


class Dataset:
    """Discovered dataset: sorted file lists + id/match resolution."""

    def __init__(self, dataset_dir: str | Path, dataset_type: str):
        if dataset_type not in DATASET_TYPES:
            raise ValueError(f"unknown dataset type {dataset_type!r}")
        self.dir = Path(dataset_dir)
        self.type = dataset_type
        self.gallery_dir = self.dir / "Gallery"
        self.query_dir = self.dir / "Query"
        # sorted-by-name ordering is load-bearing: gallery index order defines
        # matching-pair indices (reference dataloader.py:133, 174-176)
        self.gallery_files = sorted(p.name for p in self.gallery_dir.iterdir())
        self.query_files = sorted(p.name for p in self.query_dir.iterdir())

    def summary(self) -> str:
        return (
            "The dataset contains: \n"
            f"     {len(self.gallery_files)} reference shoeprints\n"
            f"     {len(self.query_files)} shoemarks"
        )

    def gallery_ids(self) -> list[int]:
        return [parse_image_id(f, self.type) for f in self.gallery_files]

    def matching_pairs(self, query_files: Sequence[str]) -> list[int]:
        """Gallery *index* of the true match for each query file.

        Many-to-one for Impress/WVU2019 via id lookup; FID-300 maps through
        ``label_table.csv`` where row ``(query_id, gallery_id)`` is 1-based
        (reference dataloader.py:97-107).
        """
        query_ids = [parse_image_id(f, self.type) for f in query_files]
        if self.type != "FID-300":
            gids = self.gallery_ids()
            return [gids.index(qid) for qid in query_ids]
        table: dict[int, int] = {}
        with (self.dir / "label_table.csv").open() as fh:
            for row in csv.reader(fh):
                table[int(row[0])] = int(row[1])
        return [table[qid] - 1 for qid in query_ids]
