"""No standing gallery: every batch is a job as ``run.py`` starts it, a
fresh ``Pipeline(config)`` and ``run()`` over the dataset, its gallery
ingested, equalised and extracted inside the job. The dataset plans one
cluster, so the job's stages all run on the calling thread.
"""

from __future__ import annotations

from . import Batch


class Driver:
    def __init__(self, pipeline_cls, config: dict, weights_dir: str, device: str, traffic: dict):
        self.make = lambda: pipeline_cls(config, weights_dir=weights_dir, verbose=False,
                                         device=device)
        self.stages: dict[str, float] = {}
        self._plan = None

    def plan(self):
        return self._plan

    def step(self) -> Batch:
        """One whole job."""
        pipe = self.make()
        if len(pipe.plans) != 1:
            raise RuntimeError(f"the planner made {len(pipe.plans)} clusters, the cell asks "
                               "for one")
        self._plan = pipe.plans[0]
        (out,) = list(pipe.run())
        for k, v in pipe.stage_seconds.items():
            self.stages[k] = self.stages.get(k, 0.0) + v
        files = sorted(self._plan.files)
        return Batch(files, out.ranks, out.matching_pairs, out.scores,
                     extracted_marks=len(files),
                     extracted_prints=len(pipe.dataset.gallery_files))

    def stage_seconds(self) -> dict:
        return dict(self.stages)

    def close(self) -> None:
        pass
