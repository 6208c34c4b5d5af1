"""Command line of the torch port: ``python -m tmhpvsim_torch pvsim ...``
and ``python -m tmhpvsim_torch serve ...``.

The flags mirror the JAX package's ``pvsim --backend jax`` flags of the
ported slice: the three output modes, ``--chain``, site grids
(``--site-grid`` / ``--sites-csv``), heterogeneous fleets (``--fleet-csv``
/ ``--fleet-synth`` with ``--fleet-seed``), reduce-mode fleet analytics
(``--analytics``), the precision levers ``--compute-dtype``,
``--kernel-impl``, ``--geom-stride`` and ``--rng-batch``, the numerics
telemetry and its drift sentinel (``--telemetry``, ``--telemetry-strict``),
the key implementation ``--prng-impl`` (threefry2x32 | rbg),
the formulation ``--block-impl`` and ``--blocks-per-dispatch`` (the JAX
package's choices, defaults and errors), ``--output-overlap`` and
``--realtime``.  ``--run-report PATH`` writes the run report (the JAX
package's RunReport schema: config, the resolved plan, device, and the
``fleet``, ``telemetry`` and ``precision`` sections).

``serve`` runs the scenario server (serve/server.py) with the JAX
package's ``pvsim serve`` defaults on an in-process ``local://``
transport, until SIGINT / SIGTERM.

``--compile-cache DIR`` (both commands) builds and loads the CUDA kernels'
libraries under DIR instead of inside the package (kernels/build.py), so
that an installed, read-only package can build them.
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
                    help="write the run report (the JAX package's RunReport "
                         "schema: config, plan, device, 'fleet' and "
                         "'precision' sections) after the run")
    pv.add_argument("--kernel-impl", choices=["auto", "exact", "table"],
                    default="auto",
                    help="transcendental kernels of the solar / pv models: "
                         "exact = CUDA's libm, table = minimax polynomials "
                         "+ day-of-year LUT (models/tables.py MAX_ULP); "
                         "auto = exact")
    pv.add_argument("--geom-stride", choices=["0", "1", "30", "60"],
                    default="0",
                    help="solar-geometry stride seconds: evaluate the "
                         "geometry every S seconds and lerp the trig-free "
                         "fields to 1 Hz (models/solar.py "
                         "STRIDE_MAX_ABS_ERR); 1 = every second, 0 = auto "
                         "(1)")
    pv.add_argument("--block-impl",
                    choices=["auto", "wide", "scan", "scan2"],
                    default="auto",
                    help="reduce/ensemble block formulation: wide "
                         "materialises each block's meter and pv and folds "
                         "them with the K4 merges; scan and scan2 fold "
                         "inside the block step; auto = scan")
    pv.add_argument("--blocks-per-dispatch", type=int, default=0,
                    help="blocks whose inputs go to the card in one copy "
                         "and whose launches are enqueued back to back: "
                         "0 = auto (1); the same results for every K")
    pv.add_argument("--rng-batch", choices=["auto", "scan", "block"],
                    default="auto",
                    help="second-noise draws per minute tile (scan) or "
                         "hoisted per block (block): the same bits; "
                         "auto = scan")
    pv.add_argument("--compute-dtype", choices=["auto", "f32", "bf16"],
                    default="auto",
                    help="mixed-precision compute path: bf16 narrows the "
                         "per-second RNG streams and the physics chain "
                         "(K12); accumulators and the carry stay f32 and "
                         "the drift sentinel gates it -- telemetry "
                         "auto-escalates to 'light'; auto = f32")
    pv.add_argument("--telemetry", choices=["off", "light", "full"],
                    default="off",
                    help="numerics telemetry (reduce mode): light = "
                         "NaN/Inf counters + moments folded on the card, "
                         "checked per block by the drift sentinel; full "
                         "adds the csi histogram + cloud occupancy; off "
                         "pays nothing")
    pv.add_argument("--telemetry-strict", action="store_true",
                    help="escalate drift-sentinel WARNs (NaN/Inf, "
                         "reference band escape) to a hard error")
    pv.add_argument("--output-overlap", choices=["auto", "off"],
                    default="auto",
                    help="auto: dispatch block N+1 before writing block N's "
                         "rows; off: one block at a time")
    pv.add_argument("--prng-impl", choices=["threefry2x32", "rbg"],
                    default="threefry2x32",
                    help="PRNG: threefry2x32 = fully counter-based "
                         "(default); rbg = threefry-derived keys with "
                         "Philox bits, drawn as jax batches them (K13; "
                         "see config.SimConfig.prng_impl)")
    pv.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) runs the kernels; cpu runs their "
                         "plain torch versions")

    sv = sub.add_parser("serve", help="long-lived scenario server: a warm "
                        "simulation answering what-if queries")
    sv.add_argument("--amqp-url", default="local://default",
                    help="transport URL the server listens on; local://NAME "
                         "(in-process) is the one ported")
    sv.add_argument("--exchange", default="scenario",
                    help="request exchange; replies go to each request's "
                         "reply_to exchange")
    sv.add_argument("-v", "--verbose", action="count", default=0)
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--duration", type=int, default=86_400,
                    help="longest scenario horizon in simulated seconds")
    sv.add_argument("--start", default=None,
                    help="simulation start 'YYYY-MM-DD HH:MM:SS'")
    sv.add_argument("--chains", type=int, default=1024,
                    help="stochastic chains per scenario evaluation")
    sv.add_argument("--block-s", type=int, default=None,
                    help="seconds per block, a multiple of 60 (default: "
                         "min(8640, duration))")
    sv.add_argument("--window-ms", type=float, default=10.0,
                    help="the first pending request waits at most this "
                         "long for company")
    sv.add_argument("--max-batch", type=int, default=16,
                    help="most requests per fused dispatch")
    sv.add_argument("--batch-sizes", default=None, metavar="B1,B2,...",
                    help="batch buckets (default: powers of two up to "
                         "--max-batch)")
    sv.add_argument("--queue-limit", type=int, default=1024,
                    help="pending requests beyond this get a typed 'busy'")
    sv.add_argument("--timeout-s", type=float, default=60.0,
                    help="per-request wall clock before a typed 'timeout'")
    sv.add_argument("--drain-timeout", type=float, default=30.0,
                    help="shutdown drain budget in seconds")
    sv.add_argument("--batching", choices=["window", "continuous"],
                    default="window",
                    help="window: every row of a dispatch retires together; "
                         "continuous: freed slots backfill every block")
    sv.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) runs the kernels; cpu runs their "
                         "plain torch versions")
    for sp in (pv, sv):
        sp.add_argument("--compile-cache", default=None, metavar="DIR",
                        help="directory the CUDA kernels are built into "
                             "and loaded from (default: _build inside "
                             "the package)")
    return p


def serve(args) -> int:
    import asyncio
    import logging

    from tmhpvsim_torch.config import SimConfig
    from tmhpvsim_torch.serve.server import ServeConfig, serve_main

    logging.basicConfig(
        level=max(logging.DEBUG, logging.WARNING - 10 * args.verbose),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    sim_kw = dict(duration_s=args.duration, n_chains=args.chains,
                  seed=args.seed, output="reduce",
                  block_s=args.block_s or min(8640, args.duration))
    if args.start:
        sim_kw["start"] = args.start
    try:
        buckets = tuple(int(b) for b in args.batch_sizes.split(",")) \
            if args.batch_sizes else ()
    except ValueError as e:
        raise SystemExit(f"serve: bad --batch-sizes {args.batch_sizes!r} "
                         "(want B1,B2,...)") from e
    try:
        cfg = ServeConfig(
            sim=SimConfig(**sim_kw), url=args.amqp_url,
            exchange=args.exchange, window_s=args.window_ms / 1e3,
            max_batch=args.max_batch, batch_sizes=buckets,
            queue_limit=args.queue_limit, timeout_s=args.timeout_s,
            drain_timeout_s=args.drain_timeout, batching=args.batching,
            device=args.device)
        asyncio.run(serve_main(cfg))
    except (ValueError, NotImplementedError, RuntimeError) as e:
        raise SystemExit(f"serve: {e}") from e
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.compile_cache is not None:
        from tmhpvsim_torch.kernels import build

        build.set_build_dir(args.compile_cache)
    if args.command == "serve":
        return serve(args)
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
    from tmhpvsim_torch.obs.sentinel import DriftError

    start = args.start or _dt.datetime.now().replace(
        microsecond=0).isoformat(" ")
    try:
        pvsim(args.file, args.duration, args.chains, args.seed, start,
              chain=args.chain, block_s=args.block_s,
              realtime=args.realtime, site_grid=site_grid,
              output=args.output, output_overlap=args.output_overlap,
              device=args.device, fleet=fleet, analytics=args.analytics,
              run_report=args.run_report, kernel_impl=args.kernel_impl,
              geom_stride=int(args.geom_stride), block_impl=args.block_impl,
              blocks_per_dispatch=args.blocks_per_dispatch,
              rng_batch=args.rng_batch, compute_dtype=args.compute_dtype,
              telemetry=args.telemetry,
              telemetry_strict=args.telemetry_strict,
              prng_impl=args.prng_impl)
    except (ValueError, DriftError) as e:
        raise SystemExit(f"pvsim: {e}") from e
    return 0


if __name__ == "__main__":
    sys.exit(main())
