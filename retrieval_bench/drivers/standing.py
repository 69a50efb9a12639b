"""A standing gallery: one pipeline, the gallery extracted once in set-up
and kept at rest in the engine's gallery cache, the marks ranked in
batches against it.

Each batch is one ``Pipeline.run_cluster`` call on a slice of the planned
cluster (``dataclasses.replace(plan, files=...)``), with the next slice as
``next_plan``, as ``Pipeline.run`` passes the next cluster: the next
batch's marks are extracted on the engine's lookahead thread while this one
scores. The slices wrap around the marks.
"""

from __future__ import annotations

from dataclasses import replace

from . import Batch


class Driver:
    def __init__(self, pipeline_cls, config: dict, weights_dir: str, device: str, traffic: dict):
        self.pipe = pipeline_cls(config, weights_dir=weights_dir, verbose=False, device=device)
        if len(self.pipe.plans) != 1:
            raise RuntimeError(f"the planner made {len(self.pipe.plans)} clusters, the cell "
                               "asks for one")
        plan = self.pipe.plans[0]
        files = sorted(plan.files)
        b = int(traffic["batch"])
        self.slices = [replace(plan, files=files[i : i + b]) for i in range(0, len(files), b)]
        self.next = 0

    def plan(self):
        return self.pipe.plans[0]

    def step(self) -> Batch:
        """Rank the next slice's marks."""
        k = self.next
        self.next = (k + 1) % len(self.slices)
        out = self.pipe.run_cluster(self.slices[k], self.slices[self.next])
        files = sorted(self.slices[k].files)
        return Batch(files, out.ranks, out.matching_pairs, out.scores,
                     extracted_marks=len(files), extracted_prints=0)

    def stage_seconds(self) -> dict:
        return dict(self.pipe.stage_seconds)

    def close(self) -> None:
        self.pipe.close()
        self.pipe = None
