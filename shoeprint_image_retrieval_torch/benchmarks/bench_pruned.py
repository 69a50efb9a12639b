"""Pruned scoring against the full path: prune rate, pairs scored, probes/s.

The port of ``benchmarks/bench_pruned.py``. ``retrieval/pruned.pruned_ranks``
(``tpu.pruned_scoring``) with the engine's ``_score_cluster`` as its score
function, against the full engine path, on a seeded gallery of G = 1024
prints (C = 176, 38-46 px) and Q = 56 probes (28-36 px), PB = 56, the
reference's 25-variant sweep, prefix k = 22 (C // 8), maps on the device.
The ranks must equal the full path's (the mode's whole contract). Two
workloads:

* ``planted`` — each probe is an exact sub-window of its true match's maps,
  so its true-match score is ~1 and the bound prunes most of the field;
* ``random`` — i.i.d. normal probes: true-match scores sit at the field's
  level, far below the bound's ``(C - k) / C`` floor, so nothing prunes and
  the mode costs about ``1 + k / C`` plus pass 0 of the full path.

It also reports how far pass 0's true-match scores (query blocks of 32
against their own prints) lie from the full path's scores of the same pairs
(``t_vs_full_max_abs_diff``): how far a pair's score follows the call it is
scored in. Pass 1 prunes against them with a margin far wider than that;
pass 2 ranks against its own score of the true pair.

    python -m shoeprint_image_retrieval_torch.benchmarks.bench_pruned
        [--workload planted|random] [--g 1024] [--q 56] [--k 22] [--plain-check]
        [--quick] [--device cuda|cpu]

Prints one JSON line. Each path runs once (host clock around calls that end
by pulling their scores), after one small call that builds the kernel and
sets the card up. With ``--device cpu`` every time is the CPU's;
``--quick`` shrinks the shapes for that.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import bench
from ..device import resolve_device
from ..metrics import ranks_from_scores
from ..ops import ncc_kernel
from ..retrieval.pruned import pruned_ranks, true_match_scores

PB = 56
PLAIN_BLOCK = 256  # prints a plain-scorer call takes in plain_check


def make_workloads(g: int = 1024, q: int = 56, quick: bool = False) -> dict:
    """Both workloads from one seeded generator (the JAX bench's draw
    order): one gallery, true matches and probe sizes; ``planted`` probes
    copy their match's top-left sub-window, ``random`` probes are the
    generator's next normals."""
    if quick:
        g, c, q = 32, 16, 6
        g_lo, g_hi, q_lo, q_hi = 18, 24, 14, 18
    else:
        c = 176
        g_lo, g_hi, q_lo, q_hi = 38, 46, 28, 36
    rng = np.random.default_rng(0)
    g_sizes = np.stack([rng.integers(g_lo, g_hi + 1, g), rng.integers(g_lo, g_hi + 1, g)],
                       1).astype(np.int32)
    gal = np.zeros((g, c, g_hi, g_hi), np.float32)
    for i, (h, w) in enumerate(g_sizes):
        gal[i, :, :h, :w] = rng.normal(size=(c, h, w)).astype(np.float32)
    pairs = rng.permutation(g)[:q].astype(np.int64)
    q_sizes = np.stack([rng.integers(q_lo, q_hi + 1, q), rng.integers(q_lo, q_hi + 1, q)],
                       1).astype(np.int32)
    out = {}
    for kind in ("planted", "random"):
        sizes = q_sizes.copy()
        qmaps = np.zeros((q, c, q_hi, q_hi), np.float32)
        for qi in range(q):
            h, w = int(sizes[qi, 0]), int(sizes[qi, 1])
            if kind == "planted":
                h, w = min(h, int(g_sizes[pairs[qi], 0])), min(w, int(g_sizes[pairs[qi], 1]))
                sizes[qi] = (h, w)
                qmaps[qi, :, :h, :w] = gal[pairs[qi], :, :h, :w]
            else:
                qmaps[qi, :, :h, :w] = rng.normal(size=(c, h, w)).astype(np.float32)
        out[kind] = {"kind": kind, "gal": gal, "g_sizes": g_sizes, "qmaps": qmaps,
                     "q_sizes": sizes, "pairs": pairs}
    return out


def run(w: dict, k: int = 22, quick: bool = False, device: str | torch.device = "cuda",
        plain_check: bool = False) -> dict:
    """Both paths on one of :func:`make_workloads`' workloads, with the NCC
    kernel's launches counted in each (``launches_full``,
    ``launches_pruned``: the count reset just before the path and read just
    after it). With ``plain_check``, the pruned path runs once more, each of
    its scoring calls made by the kernel and by the plain scorer
    (``ncc_backend = "direct"``) on the same inputs: ``plain_check`` then
    holds the largest |kernel - plain| of each pass's calls, and the plain
    path's ranks, which must equal the kernel's."""
    dev = resolve_device(device)
    workload = w["kind"]
    pairs, q_sizes, g_sizes = w["pairs"], w["q_sizes"], w["g_sizes"]
    k = 2 if quick else k
    launch = ncc_kernel.launch_ncc
    with tempfile.TemporaryDirectory(prefix="bench_pruned_") as tmp:
        pb = min(4 if quick else PB, len(pairs))
        (Path(tmp) / "kernel").mkdir()
        pipe = bench.engine_pipeline(Path(tmp) / "kernel", pb, dev)
        q_in, g_in = torch.from_numpy(w["qmaps"]).to(dev), torch.from_numpy(w["gal"]).to(dev)

        def score_fn(qm, qv, gm, gv):
            return pipe._score_cluster(qm, qv, gm, gv)

        score_fn(q_in[:1], q_sizes[:1], g_in[:2], g_sizes[:2])  # build + first launch
        launch.launches = 0
        t0 = time.perf_counter()
        full = score_fn(q_in, q_sizes, g_in, g_sizes)
        ranks_full = ranks_from_scores(full, pairs)
        dt_full = time.perf_counter() - t0
        launches_full = launch.launches
        launch.launches = 0
        t0 = time.perf_counter()
        ranks, stats = pruned_ranks(score_fn, q_in, q_sizes, g_in, g_sizes, pairs, k=k)
        dt_pruned = time.perf_counter() - t0
        launches_pruned = launch.launches
        t, _ = true_match_scores(score_fn, q_in, q_sizes, g_in, g_sizes, pairs)
        check = (_plain_check(pipe, Path(tmp) / "plain", pb, w, q_in, g_in, k)
                 if plain_check else None)
        pipe.close()
    delta = np.abs(t - full[np.arange(len(pairs)), pairs])
    identical = bool(np.array_equal(ranks, ranks_full))
    out = {"metric": "probes_per_sec_pruned", "workload": workload, "g": len(g_sizes),
           "q": len(pairs), "k": stats["k"], "prune_rate": stats["prune_rate"],
           "pair_frac": stats["pair_frac"], "survivors": stats["survivors"],
           "pps_full": len(pairs) / dt_full, "pps_pruned": len(pairs) / dt_pruned,
           "speedup": dt_full / dt_pruned, "ranks_identical": identical,
           "launches_full": launches_full, "launches_pruned": launches_pruned,
           "t_vs_full_max_abs_diff": float(delta.max()),
           "t_vs_full_pairs_differing": int((delta > 0).sum()),
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if not identical:
        bad = np.nonzero(ranks != ranks_full)[0]
        raise RuntimeError(f"bench_pruned {workload}: ranks differ from the full path at "
                           f"{bad.tolist()}: pruned {ranks[bad].tolist()}, full "
                           f"{ranks_full[bad].tolist()}; {out}")
    if check is not None:
        plain_ranks = check.pop("ranks")
        check["ranks_identical"] = bool(np.array_equal(plain_ranks, ranks))
        out["plain_check"] = check
        if not check["ranks_identical"]:
            raise RuntimeError(f"bench_pruned {workload}: the plain scorer's pruned ranks "
                               f"{plain_ranks.tolist()} differ from the kernel's "
                               f"{ranks.tolist()}")
    return out


def _plain_check(pipe, root: Path, pb: int, w: dict, q_in: torch.Tensor, g_in: torch.Tensor,
                 k: int) -> dict:
    """The pruned path once more, each call scored by ``pipe`` and by a plain
    pipeline (``ncc_backend = "direct"``) on the same inputs -> per pass the
    calls' shapes and largest |kernel - plain|, and the ranks of the plain
    scores. The plain pipeline scores in gallery blocks of
    ``PLAIN_BLOCK`` prints (its (N, G, Hb, Wb) temporaries), which leaves
    its scores unchanged: it scores each print alone."""
    root.mkdir()
    plain = bench.engine_pipeline(root, pb, q_in.device)
    plain.config["tpu"].update(ncc_backend="direct", gallery_block=PLAIN_BLOCK)
    c = q_in.shape[1]
    calls = []

    def both(qm, qv, gm, gv):
        got = pipe._score_cluster(qm, qv, gm, gv)
        want = plain._score_cluster(qm, qv, gm, gv)
        # pass 1 is the one prefix call; the full-depth calls before it are pass 0's
        after = any(call["pass"] == 1 for call in calls)
        calls.append({"pass": 1 if qm.shape[1] < c else (2 if after else 0),
                      "queries": len(qm), "prints": len(gm), "channels": qm.shape[1],
                      "max_abs_diff": float(np.abs(got - want).max())})
        return want

    ranks, _ = pruned_ranks(both, q_in, w["q_sizes"], g_in, w["g_sizes"], w["pairs"], k=k)
    plain.close()
    per_pass = {}
    for call in calls:
        per_pass.setdefault(str(call["pass"]), []).append(call)
    return {"calls": per_pass, "max_abs_diff": max(c["max_abs_diff"] for c in calls),
            "ranks": ranks}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m shoeprint_image_retrieval_torch.benchmarks.bench_pruned")
    ap.add_argument("--workload", choices=("planted", "random"), default="planted")
    ap.add_argument("--g", type=int, default=1024)
    ap.add_argument("--q", type=int, default=56)
    ap.add_argument("--k", type=int, default=22, help="prefix depth (0 = C // 8)")
    ap.add_argument("--quick", action="store_true", help="small workload (for the CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--plain-check", action="store_true",
                    help="also hold every pruned call against the plain scorer")
    args = ap.parse_args(argv)
    w = make_workloads(args.g, args.q, args.quick)[args.workload]
    result = run(w, args.k, args.quick, args.device, args.plain_check)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
