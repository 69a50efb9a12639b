"""One retrieval step over an n-device mesh, held against one device.

The port of ``__graft_entry__.dryrun_multichip``. It runs the two ways the
engine uses a mesh (``parallel/``), each through the engine's own code,
on small shapes:

* data parallelism: a batch of images extracted with each chunk split over
  the mesh, one backbone replica a distinct device
  (``Pipeline._extract``), against the same batch on one device;
* gallery parallelism: ``Pipeline._score_cluster`` at the production sweep
  (7 rotations x 3 scales, 25 variants a probe, class-major) with the probe
  batch a multiple of the mesh (the probe-sharded stack build), the gallery
  sharded in two blocks (``gallery_block``) and the ranks made on the device
  (``rank_on_device``), against the one-device, one-block, host-rank path.
  Scores within 1e-6, ranks equal.

    python -m shoeprint_image_retrieval_torch.dryrun N [--device cuda|cpu]

On a card the mesh is N visible CUDA devices; on the CPU, the CPU N times.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

SCORE_TOL = 1e-6  # each pair is scored alone, by the same scorer, on either path
# sharded vs one-device features, relative to the activation scale: the
# convolutions run on other batch sizes, so in other algorithms
FEATURE_TOL = 1e-4


def _pipeline(root: Path, devices, **tpu):
    """The bench's engine ``Pipeline`` (the reference sweep, the kernel on a
    card) over ``devices``, probe batch ``len(devices)``, with ``tpu`` set."""
    from . import bench

    root.mkdir()
    pipe = bench.engine_pipeline(root, len(devices), devices[0], mesh_devices=devices)
    pipe.config["tpu"].update(tpu)
    return pipe


def dryrun_multichip(n_devices: int, devices: Sequence[str | torch.device] | None = None) -> dict:
    """Extraction and scoring over a mesh of ``n_devices`` (from
    ``devices``, repeats allowed; default the visible CUDA devices), each
    against the one-device path on the same inputs; raises on a mismatch."""
    from .metrics import ranks_from_scores
    from .parallel.mesh import visible_devices
    from .retrieval.engine import DeviceScores

    if devices is None:
        devices = visible_devices("cuda")
    devices = list(devices)[:n_devices]
    if len(devices) != n_devices:
        raise ValueError(f"dryrun_multichip: {n_devices} devices asked for, {len(devices)} given")
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as tmp:
        root = Path(tmp)

        # --- data-parallel extraction: two images a device ------------------
        rng = np.random.default_rng(0)
        batch = 2 * n_devices
        images = [rng.integers(0, 256, (int(rng.integers(33, 49)), int(rng.integers(33, 49))),
                               dtype=np.uint8) for _ in range(batch)]
        feats = []
        for mesh_shape in (n_devices, 1):
            pipe = _pipeline(root / f"extract{mesh_shape}", devices, mesh_shape=mesh_shape,
                             extraction_batch=batch)
            model = pipe._model_for_block(4)
            maps, valid = pipe._extract(model, images)
            feats.append((torch.as_tensor(maps).cpu().numpy(), valid, dict(pipe.mesh_runs)))
            pipe.close()
        (m_mesh, v_mesh, runs), (m_one, v_one, _) = feats
        scale = float(np.abs(m_one).max())
        feature_err = float(np.abs(m_mesh - m_one).max()) / max(scale, 1e-30)
        want_runs = {f"extract:{n_devices}": 1} if n_devices > 1 else {}
        if runs != want_runs or not np.array_equal(v_mesh, v_one) or feature_err > FEATURE_TOL:
            raise AssertionError(f"dryrun_multichip({n_devices}): sharded extraction differs "
                                 f"({feature_err} of the scale; runs {runs})")

        # --- gallery-sharded scoring, two blocks, ranks on the device ---------
        rng = np.random.default_rng(5)
        c, hc, wc = 4, 14, 14
        n_q, n_g = n_devices + 2, 11  # a padded tail probe batch; two gallery blocks
        q_maps = rng.normal(size=(n_q, c, hc, wc)).astype(np.float32)
        g_maps = rng.normal(size=(n_g, c, hc, wc)).astype(np.float32)
        q_hw = np.stack([rng.integers(11, hc + 1, n_q), rng.integers(11, wc + 1, n_q)], 1)
        g_hw = np.full((n_g, 2), hc, np.int64)
        for arr, hw in ((q_maps, q_hw), (g_maps, g_hw)):
            for i, (h, w) in enumerate(hw):
                arr[i, :, h:, :] = 0.0
                arr[i, :, :, w:] = 0.0
        q_valid, g_valid = q_hw.astype(np.int32), g_hw.astype(np.int32)
        pairs = np.asarray([(3 * i + 1) % n_g for i in range(n_q)])

        pipe = _pipeline(root / "mesh", devices, mesh_shape=n_devices, gallery_block=6,
                         rank_on_device=True)
        dev_scores = pipe._score_cluster(q_maps, q_valid, g_maps, g_valid)
        if not isinstance(dev_scores, DeviceScores):
            raise AssertionError("rank_on_device did not keep the scores on the device")
        mesh_ranks = dev_scores.ranks(pairs)
        mesh_mat = dev_scores.materialize()
        blocks, mesh_runs = pipe.gallery_blocks_scored, dict(pipe.mesh_runs)
        pipe.close()
        ctrl = _pipeline(root / "one", devices, mesh_shape=1)
        ctrl_mat = np.asarray(ctrl._score_cluster(q_maps, q_valid, g_maps, g_valid))
        ctrl.close()
    err = float(np.abs(mesh_mat - ctrl_mat).max())
    if mesh_mat.shape != ctrl_mat.shape or err > SCORE_TOL:
        raise AssertionError(f"dryrun_multichip({n_devices}): sharded scores differ by {err}")
    if not np.array_equal(mesh_ranks, ranks_from_scores(ctrl_mat, pairs)):
        raise AssertionError(f"dryrun_multichip({n_devices}): device ranks differ from the "
                             "one-device host ranks")
    gb = -(-6 // n_devices) * n_devices
    if blocks != -(-n_g // gb) or (n_devices > 1 and mesh_runs != {f"score:{n_devices}": 1}):
        raise AssertionError(f"dryrun_multichip({n_devices}): {blocks} blocks, {mesh_runs}")
    return {"devices": [str(d) for d in devices], "feature_err": feature_err,
            "score_err": err, "gallery_blocks": blocks, "ranks": mesh_ranks.tolist()}


def main(argv: list[str] | None = None) -> dict:
    from .device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m shoeprint_image_retrieval_torch.dryrun")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    devices = [dev] * args.n_devices if dev.type == "cpu" else None
    result = dryrun_multichip(args.n_devices, devices)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
