"""One run of one cell: ``python -m retrieval_bench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.

Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last: each compared number beside its limit) and exits 0, or
exits non-zero with no result where the cell's CUDA devices are missing or
a JAX module was loaded. ``--control 1`` judges the reference computed in
float32 with TF32 on in the program's place (the lower-precision control,
which has to come out not correct; not for the benchmark's own runs).
Heavy imports wait for :func:`main`: the dataset generator's worker
processes import this module.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--workers", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from retrieval_bench.harness import run_cell

    return run_cell(args, T_START)


if __name__ == "__main__":
    raise SystemExit(main())
