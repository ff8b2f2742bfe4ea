"""The readings the limits of ``correct`` are set from, at a cell's own
size on the card, in one process (the benchmark's own runs never run
this):

- ``program``: the numbers of sound windows of the program, one a seed
  (the lower readings);
- ``control``: the plain reference at the precision below the
  configuration's (bfloat16 for float32) put in the program's place, on
  the windows of the first ``--control`` seeds (the upper readings);
- for a fit, ``fault_half_batch``: the reference put in the program's
  place with its loss taken over half of the rows only (the mean over the
  rest); a state left unchanged reads 1 on ``change_gap`` and
  ``final_gap`` by definition.

    python3 benchmark/control.py --workload CELL --seconds S --seeds N... \\
        [--control K]

One JSON line a reading.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from benchmark import check, harness, loops  # noqa: E402


def half_batch_fit(c: harness.Cell):
    """The reference's whole fit with the loss over the first half of
    the rows: a fit that leaves half of its batch out."""
    t = c.traffic
    return check.reference_fit(c.config, t, c.time0, c.root, c.device,
                               rows=(t["height"] // 2) * t["width"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    c = harness.Cell(ROOT, args.workload, device)
    for k, seed in enumerate(args.seeds):
        c.prepare(seed)
        rec = c.window(loops.stop_after(seconds=args.seconds))
        line = dict(workload=args.workload, seed=seed,
                    requests=rec["requests"], frames=rec.get("frames"))
        t0 = time.perf_counter()
        numbers = c.numbers(rec)
        print(json.dumps(line | dict(
            reading="program", numbers=numbers,
            reference_s=time.perf_counter() - t0)), flush=True)
        if k < args.control:
            print(json.dumps(line | dict(
                reading="control",
                numbers=c.numbers(rec, dt=torch.bfloat16))), flush=True)
            if not c.render:
                print(json.dumps(line | dict(
                    reading="fault_half_batch",
                    numbers=c.numbers(rec, program=half_batch_fit(c)))),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
