"""Run one cell of the benchmark of fastqueeze_tpu_torch once.

    python3 fqbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1> [--control lossy]

From the root of a checkout, on a machine with the CUDA cards the cell
asks for.  Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1``
``breakdown``, ``setup_parts`` (``setup_s`` split: start, kernel build,
input, warm-up job), and last ``checks``: each number compared beside its
limit, which also end standard error.  Exits non-zero, with no result,
without a CUDA card, with fewer cards than the cell asks for, or when
the JAX package or JAX is loaded in this process.

``--control lossy`` runs the cell's control instead of the program as
the configuration states it: the program's own lossy quality path (-l),
which breaks the lossless guarantee, so ``correct`` comes out false.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fqbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("lossy",), default=None)
    args = ap.parse_args(argv)
    age = harness.process_age_s()
    t_start = _T0 if age is None else time.perf_counter() - age

    cell = harness.load_cell(args.workload)
    harness.set_caches()
    inp = harness.start_input(cell, args.seed)
    import torch
    if not torch.cuda.is_available():
        print("fqbench: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"fqbench: {args.workload} needs {cell.chips} CUDA cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", args.control, t_start, inp)
    bad = harness.forbidden_modules()
    if bad:
        print(f"fqbench: modules loaded that the port may not load: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
