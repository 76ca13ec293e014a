"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` beside ``bench/``).  The
last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers the correctness check compared,
each beside its limit.  ``--trace 1`` reports the cell's per-layer
metrics, read over a ``torch.profiler`` slice after the window and the
engine's counters over the window; ``--trace 0`` its end-to-end metrics.

``--control 1`` puts the fp8 control in the program's place for the check
(the tokens it puts first over the same sample are judged, so the run
reports ``correct`` false), with the program's own readings printed
beside; it serves setting a limit, and the benchmark's own runs leave it
off.

Exits non-zero, printing no result, without CUDA or with fewer cards
than the cell asks for, when the port is not there, and when ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded once the window
has closed.
"""
import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(BENCH))
    import harness
    t_start = harness.process_start_time() or T_IMPORT

    manifest = harness.load_json(REPO / "BENCHMARK.json")
    cell = harness.Cell(args.workload, manifest)

    import torch
    if not torch.cuda.is_available():
        harness.log("[bench] CUDA is not available: no result")
        return 2
    if torch.cuda.device_count() < cell.chips:
        harness.log(f"[bench] {cell.name} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} visible: no result")
        return 2
    sys.path.insert(0, str(REPO / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        harness.log(f"[bench] the port is not importable ({e}): no result")
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    harness.log(f"[bench] {cell.name} seed {args.seed}, "
                f"{args.seconds} s, trace {args.trace}; card "
                f"{harness.power_limit()}")

    result, found = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), t_start,
        control=bool(args.control))

    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"[bench] loaded in this process: {', '.join(bad)}; "
                    f"the port runs without JAX: no result")
        return 3
    harness.log(f"[bench] readings {json.dumps(found)}")
    for name, c in result["checks"].items():
        harness.log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
