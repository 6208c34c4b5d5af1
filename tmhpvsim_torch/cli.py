"""Command line of the torch port: ``python -m tmhpvsim_torch pvsim ...``.

Only reduce mode exists so far; the flags mirror the JAX package's
``pvsim --backend jax`` flags of that mode.
"""

from __future__ import annotations

import argparse
import datetime as _dt
import sys


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tmhpvsim_torch")
    sub = p.add_subparsers(dest="command", required=True)
    pv = sub.add_parser("pvsim", help="PV + meter simulation -> CSV")
    pv.add_argument("file")
    pv.add_argument("--output", choices=["reduce"], required=True,
                    help="reduce: per-chain statistics + an ensemble row")
    pv.add_argument("--realtime", dest="realtime", action="store_true",
                    default=True)
    pv.add_argument("--no-realtime", dest="realtime", action="store_false",
                    help="switch off rate limiting (required)")
    pv.add_argument("--chains", type=int, default=1)
    pv.add_argument("--duration", type=int, required=True,
                    help="simulated seconds")
    pv.add_argument("--block-s", type=int, default=None,
                    help="seconds per block, a multiple of 60 "
                         "(default: min(8640, duration))")
    pv.add_argument("--seed", type=int, default=0)
    pv.add_argument("--start", default=None,
                    help="start time 'YYYY-MM-DD HH:MM:SS' (default: now)")
    pv.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) runs the kernels; cpu runs their "
                         "plain torch versions")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.realtime:
        raise SystemExit("pvsim: reduce mode needs --no-realtime")
    from tmhpvsim_torch.apps.pvsim import pvsim_reduce

    start = args.start or _dt.datetime.now().replace(
        microsecond=0).isoformat(" ")
    pvsim_reduce(args.file, args.duration, args.chains, args.seed, start,
                 block_s=args.block_s, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
