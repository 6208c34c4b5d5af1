"""Command line of the torch port: ``python -m tmhpvsim_torch pvsim ...``.

The flags mirror the JAX package's ``pvsim --backend jax`` flags of the
ported slice: the three output modes, ``--chain``, site grids
(``--site-grid`` / ``--sites-csv``), heterogeneous fleets (``--fleet-csv``
/ ``--fleet-synth`` with ``--fleet-seed``), reduce-mode fleet analytics
(``--analytics``), ``--output-overlap`` and ``--realtime``.
``--run-report PATH`` writes a JSON with the run's ``fleet`` section (the
key the JAX package's RunReport fills from ``fleet_summary()``).
"""

from __future__ import annotations

import argparse
import datetime as _dt
import sys


def _parse_site_grid(spec):
    """'LAT0:LAT1:NLAT,LON0:LON1:NLON' -> SiteGrid (None passes through)."""
    if not spec:
        return None
    from tmhpvsim_torch.config import SiteGrid

    try:
        lat_part, lon_part = spec.split(",")
        lat0, lat1, n_lat = lat_part.split(":")
        lon0, lon1, n_lon = lon_part.split(":")
        return SiteGrid.regular((float(lat0), float(lat1)),
                                (float(lon0), float(lon1)), int(n_lat),
                                int(n_lon))
    except ValueError as e:
        raise SystemExit(f"pvsim: bad --site-grid {spec!r} (want "
                         "LAT0:LAT1:NLAT,LON0:LON1:NLON)") from e


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tmhpvsim_torch")
    sub = p.add_subparsers(dest="command", required=True)
    pv = sub.add_parser("pvsim", help="PV + meter simulation -> CSV")
    pv.add_argument("file")
    pv.add_argument("--output", choices=["trace", "reduce", "ensemble"],
                    default="trace",
                    help="trace: per-second CSV rows (one chain); reduce: "
                         "per-chain statistics + an ensemble row; "
                         "ensemble: per-second fleet-mean rows")
    pv.add_argument("--chain", type=int, default=0,
                    help="the chain whose rows trace mode writes")
    pv.add_argument("--realtime", dest="realtime", action="store_true",
                    default=True,
                    help="release rows on the 1 Hz wall-clock grid "
                         "(default)")
    pv.add_argument("--no-realtime", dest="realtime", action="store_false",
                    help="switch off rate limiting (required for reduce)")
    pv.add_argument("--chains", type=int, default=1)
    pv.add_argument("--duration", type=int, required=True,
                    help="simulated seconds")
    pv.add_argument("--block-s", type=int, default=None,
                    help="seconds per block, a multiple of 60 "
                         "(default: min(8640, duration))")
    pv.add_argument("--seed", type=int, default=0)
    pv.add_argument("--start", default=None,
                    help="start time 'YYYY-MM-DD HH:MM:SS' (default: now)")
    grid = pv.add_mutually_exclusive_group()
    grid.add_argument("--fleet-csv", default=None,
                      help="heterogeneous fleet from a CSV (columns "
                           "latitude, longitude [, altitude, surface_tilt, "
                           "surface_azimuth, albedo, dc_capacity_scale, "
                           "ac_limit_w, weather_regime, demand_scale, "
                           "demand_shift_w, cohort]): one chain per row, "
                           "per-site parameters on the device (overrides "
                           "--chains)")
    grid.add_argument("--fleet-synth", type=int, default=None, metavar="N",
                      help="synthetic seeded national fleet of N sites "
                           "(fleet.FleetParams.synthetic; overrides "
                           "--chains)")
    grid.add_argument("--site-grid", default=None,
                      help="multi-site lat/lon grid "
                           "'LAT0:LAT1:NLAT,LON0:LON1:NLON': one chain per "
                           "site, geometry on the device (overrides "
                           "--chains)")
    grid.add_argument("--sites-csv", default=None,
                      help="site list from a CSV (columns latitude, "
                           "longitude [, altitude, surface_tilt, "
                           "surface_azimuth, albedo]): one chain per row "
                           "(overrides --chains)")
    pv.add_argument("--fleet-seed", type=int, default=0,
                    help="seed of the --fleet-synth sampler (independent "
                         "of --seed, which drives the weather and demand "
                         "draws)")
    pv.add_argument("--analytics", choices=["off", "risk", "full"],
                    default="off",
                    help="on-device fleet-risk analytics (reduce mode): "
                         "risk = residual quantile sketch, exceedance "
                         "curve, loss-of-load probability, ramp extrema "
                         "and the per-cohort group-by; full adds "
                         "per-regime sums; reported by --run-report")
    pv.add_argument("--run-report", default=None, metavar="PATH",
                    help="write a JSON with the run's 'fleet' section "
                         "after the run")
    pv.add_argument("--output-overlap", choices=["auto", "off"],
                    default="auto",
                    help="auto: dispatch block N+1 before writing block N's "
                         "rows; off: one block at a time")
    pv.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) runs the kernels; cpu runs their "
                         "plain torch versions")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.realtime and args.output == "reduce":
        raise SystemExit("pvsim: reduce mode needs --no-realtime")
    if args.fleet_synth is not None and args.fleet_synth < 1:
        raise SystemExit("pvsim: --fleet-synth must be >= 1")
    fleet = None
    if args.fleet_csv or args.fleet_synth is not None:
        from tmhpvsim_torch.fleet import FleetParams

        try:
            fleet = (FleetParams.from_csv(args.fleet_csv) if args.fleet_csv
                     else FleetParams.synthetic(args.fleet_synth,
                                                seed=args.fleet_seed))
        except (OSError, ValueError) as e:
            raise SystemExit(f"pvsim: {e}") from e
    if args.sites_csv:
        from tmhpvsim_torch.config import SiteGrid

        try:
            site_grid = SiteGrid.from_csv(args.sites_csv)
        except (OSError, ValueError) as e:
            raise SystemExit(f"pvsim: {e}") from e
    else:
        site_grid = _parse_site_grid(args.site_grid)
    from tmhpvsim_torch.apps.pvsim import pvsim

    start = args.start or _dt.datetime.now().replace(
        microsecond=0).isoformat(" ")
    try:
        pvsim(args.file, args.duration, args.chains, args.seed, start,
              chain=args.chain, block_s=args.block_s,
              realtime=args.realtime, site_grid=site_grid,
              output=args.output, output_overlap=args.output_overlap,
              device=args.device, fleet=fleet, analytics=args.analytics,
              run_report=args.run_report)
    except ValueError as e:
        raise SystemExit(f"pvsim: {e}") from e
    return 0


if __name__ == "__main__":
    sys.exit(main())
