"""Run a probe:

    python -m rt_torch.probes lane_gather [--iters 512] [--device cpu]
    python -m rt_torch.probes r5_mxu [--reps 200] [--chunks 64] [--device cpu]

``lane_gather`` runs what ``tools/exp_lane_gather.py`` runs, ``r5_mxu`` what
``tools/exp_r5_mxu.py`` runs, on the card unless ``--device cpu`` (the
plain versions) is given.  Exit code 1 if a ``lane_gather`` line is not
correct.
"""

from __future__ import annotations

import argparse
import sys

from rt_torch.probes import lane_gather, r5_mxu


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m rt_torch.probes")
    sub = p.add_subparsers(dest="probe", required=True)
    lg = sub.add_parser("lane_gather", help="P1: per-lane dynamic gather")
    lg.add_argument("--iters", type=int, default=lane_gather.ITERS)
    mx = sub.add_parser("r5_mxu", help="P2: M-T scan against a bf16 Woop "
                                       "product on the tensor cores")
    mx.add_argument("--reps", type=int, default=200)
    mx.add_argument("--chunks", type=int, default=64)
    for q in (lg, mx):
        q.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.probe == "lane_gather":
        results = lane_gather.main(args.device, args.iters)
        return 0 if all(r["correct"] for r in results) else 1
    r5_mxu.main(args.device, args.reps, args.chunks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
