"""Command line of the torch port: ``python -m tmhpvsim_torch pvsim ...``,
``metersim``, ``fanoutbroker`` and ``serve``.

``pvsim``'s flags mirror the JAX package's ``pvsim`` flags of the ported
slice.  Its default backend, ``device``, is the JAX package's ``pvsim
--backend jax`` (the JAX CLI's default is ``asyncio``; the port's default
is the simulation on the card, the path the port exists for, and it has
been the port's only pvsim since the first slice): the three output
modes, ``--chain``, site grids (``--site-grid`` / ``--sites-csv``),
heterogeneous fleets (``--fleet-csv`` / ``--fleet-synth`` with
``--fleet-seed``), reduce-mode fleet analytics (``--analytics``), the
precision levers ``--compute-dtype``, ``--kernel-impl``, ``--geom-stride``
and ``--rng-batch``, the numerics telemetry and its drift sentinel
(``--telemetry``, ``--telemetry-strict``), the key implementation
``--prng-impl`` (threefry2x32 | rbg), the formulation ``--block-impl`` and
``--blocks-per-dispatch`` (the JAX package's choices, defaults and
errors), the runtime autotuner ``--tune`` (off | auto | force,
engine/autotune.py), ``--output-overlap`` and ``--realtime``, checkpoints
and preemption
(``--checkpoint PATH``, ``--checkpoint-keep``, ``--checkpoint-async``,
``--preempt-grace``; a resume without ``--seed`` takes the checkpoint's
seed), and chain-sharded
runs over ``torch.distributed`` (``--sharded`` with ``--coordinator``,
``--num-processes``, ``--process-id`` or a launcher's environment; the
JAX CLI's ``--mesh-scenario`` is refused by name).  ``--run-report PATH``
writes the run report (the JAX package's RunReport schema: config, the
resolved plan, device, and the ``fleet``, ``telemetry`` and ``precision``
sections).  ``--backend asyncio`` is the streaming consumer: it
subscribes to ``--amqp-url`` / ``--exchange``, runs the float64 golden PV
model once per second and joins the meter stream into the CSV; the
device backend's flags are refused there, as the JAX CLI refuses them.

``metersim`` publishes 1 Hz demand to the fanout exchange: by default
from K15 on the card (``--device cpu``: its plain version), with
``--backend asyncio`` from the reference's per-second numpy producer.
``fanoutbroker`` is the in-tree TCP fanout broker behind ``tcp://`` URLs.
``--amqp-url`` takes ``local://NAME`` (in-process, the default),
``tcp://HOST:PORT`` or an AMQP URL (needs aio-pika).  The JAX CLI's
``--trace``, ``--obs-port`` / ``--obs-bind``, ``--metrics``, ``--chaos`` /
``--chaos-seed`` and ``--supervise`` are not ported yet: each is refused
with a usage error that names it.

``serve`` runs the scenario server (serve/server.py) with the JAX
package's ``pvsim serve`` defaults on an in-process ``local://``
transport, until SIGINT / SIGTERM; ``--tune`` resolves the served plan
through the autotuner.

``--compile-cache DIR`` (pvsim, metersim and serve) builds and loads the
CUDA kernels' libraries under DIR instead of inside the package
(kernels/build.py), so that an installed, read-only package can build
them.
"""

from __future__ import annotations

import argparse
import datetime as _dt
import logging
import os
import sys

#: the JAX CLI's flags of the streaming commands that the port has not
#: ported yet (tracing, the live ops plane, metrics sinks, fault
#: injection, the supervisor): refused by name
WAITING_FLAGS = ("--trace", "--obs-port", "--obs-bind", "--metrics",
                 "--chaos", "--chaos-seed", "--supervise")
#: the flags only the device backend of pvsim takes, with their defaults
DEVICE_ONLY = {"output": "trace", "chain": 0, "chains": 1, "block_s": None,
               "fleet_csv": None, "fleet_synth": None, "site_grid": None,
               "sites_csv": None, "fleet_seed": 0, "analytics": "off",
               "kernel_impl": "auto", "geom_stride": "0",
               "block_impl": "auto", "blocks_per_dispatch": 0,
               "rng_batch": "auto", "compute_dtype": "auto",
               "telemetry": "off", "telemetry_strict": False,
               "output_overlap": "auto", "prng_impl": "threefry2x32",
               "compile_cache": None, "sharded": False, "coordinator": None,
               "num_processes": None, "process_id": None,
               "checkpoint": None, "checkpoint_keep": 3,
               "checkpoint_async": "off", "preempt_grace": 0.0,
               "tune": "off"}
#: the process flags of a sharded run
PROCESS_FLAGS = ("coordinator", "num_processes", "process_id")


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


def _waiting_dest(flag: str) -> str:
    return "waiting_" + flag[2:].replace("-", "_")


def _stream_options(sp) -> None:
    """The streaming commands' transport and logging flags, and the JAX
    CLI's flags that wait (hidden; refused by name in ``main``)."""
    sp.add_argument("--amqp-url", default=os.environ.get("AMQP_URL"),
                    help="broker URL: local://NAME (in-process, the "
                         "default 'local://default'), tcp://HOST:PORT (the "
                         "fanoutbroker command) or amqp://... (RabbitMQ, "
                         "needs aio-pika); env AMQP_URL")
    sp.add_argument("--exchange",
                    default=os.environ.get("TMHPVSIM_EXCHANGE", "meter"),
                    help="the fanout exchange (default 'meter'; env "
                         "TMHPVSIM_EXCHANGE)")
    sp.add_argument("-v", "--verbose", action="count", default=0,
                    help="raise the log level from WARNING")
    for flag in WAITING_FLAGS:
        sp.add_argument(flag, dest=_waiting_dest(flag), default=None,
                        help=argparse.SUPPRESS)


def _setup_logging(verbose: int) -> None:
    logging.basicConfig(level=max(logging.DEBUG,
                                  logging.WARNING - 10 * verbose))


def _parse_start(parser, start):
    try:
        return _dt.datetime.fromisoformat(start) if start else None
    except ValueError:
        parser.error(f"bad --start {start!r} (want 'YYYY-MM-DD HH:MM:SS')")


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
    pv.add_argument("--duration", type=int, default=None,
                    help="simulated seconds (required with the device "
                         "backend; asyncio: stop after this many, default "
                         "never)")
    pv.add_argument("--block-s", type=int, default=None,
                    help="seconds per block, a multiple of 60 "
                         "(default: min(8640, duration))")
    pv.add_argument("--seed", type=int, default=None,
                    help="PRNG seed (device backend: default 0; asyncio: "
                         "default nondeterministic)")
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
    pv.add_argument("--tune", choices=["off", "auto", "force"],
                    default="off",
                    help="runtime autotuner: auto = use/populate the "
                         "persistent per-device plan cache (short "
                         "real-block probes on a miss); force = re-probe "
                         "even on a hit; the resolved plan is echoed in "
                         "the logs (device backend, see "
                         "config.SimConfig.tune)")
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
                         "plain torch versions (the asyncio backend is "
                         "host code either way)")
    pv.add_argument("--sharded", action="store_true",
                    help="split the chains over the processes of a "
                         "torch.distributed group, one card each (NCCL; "
                         "--device cpu: gloo), joined from the process "
                         "flags or a launcher's environment "
                         "(torch.distributed.run); with more than one "
                         "process each writes FILE.host<rank>")
    pv.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="rendezvous of a sharded run: HOST:PORT (tcp) or "
                         "a tcp:// / file:// URL; with --num-processes and "
                         "--process-id")
    pv.add_argument("--num-processes", type=int, default=None, metavar="K",
                    help="processes of the sharded run")
    pv.add_argument("--process-id", type=int, default=None, metavar="I",
                    help="this process's rank in [0, K)")
    pv.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="save the run after every block and resume from "
                         "PATH when it exists (the JAX package's format: "
                         "either package resumes the other's); trace and "
                         "ensemble rows are written exactly once across a "
                         "resume; turns --output-overlap off")
    pv.add_argument("--checkpoint-keep", type=int, default=3, metavar="N",
                    help="checkpoint generations kept on disk: the anchor "
                         "plus the newest N rotated .g<gen> snapshots "
                         "named by the integrity manifest; a torn newest "
                         "generation falls back to the newest that "
                         "verifies (default 3)")
    pv.add_argument("--checkpoint-async", choices=["off", "on"],
                    default="off",
                    help="on: the run pays the device-to-host copy only; "
                         "serialisation, checksums, fsync and rotation "
                         "run on a writer thread (default off)")
    pv.add_argument("--preempt-grace", type=float, default=0.0,
                    metavar="S",
                    help="preemption grace seconds: > 0 makes SIGTERM "
                         "finish the block in flight, drain one final "
                         "snapshot and exit 0 (default 0: SIGTERM's "
                         "default)")
    pv.add_argument("--mesh-scenario", dest="mesh_scenario", default=None,
                    help=argparse.SUPPRESS)
    pv.add_argument("--backend", choices=["device", "asyncio"],
                    default="device",
                    help="device (default): the blockwise simulation on the "
                         "card, no broker (the JAX CLI's --backend jax); "
                         "asyncio: the streaming consumer, joining the "
                         "meter stream of --amqp-url with the golden PV "
                         "model (the JAX CLI's default)")
    _stream_options(pv)

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
    sv.add_argument("--tune", choices=["off", "auto", "force"],
                    default="off",
                    help="runtime autotuner for the served plan "
                         "(config.SimConfig.tune)")
    sv.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) runs the kernels; cpu runs their "
                         "plain torch versions")
    mt = sub.add_parser("metersim", help="1 Hz demand producer publishing "
                        "to a fanout exchange")
    _stream_options(mt)
    mt.add_argument("--realtime", dest="realtime", action="store_true",
                    default=True,
                    help="publish on the 1 Hz wall-clock grid (default)")
    mt.add_argument("--no-realtime", dest="realtime", action="store_false",
                    help="switch off rate limiting (for simulation)")
    mt.add_argument("--seed", type=int, default=None,
                    help="PRNG seed (default: nondeterministic)")
    mt.add_argument("--duration", type=int, default=None,
                    help="stop after this many simulated seconds (default: "
                         "run forever)")
    mt.add_argument("--start", default=None,
                    help="simulation start 'YYYY-MM-DD HH:MM:SS' (default: "
                         "now)")
    mt.add_argument("--backend", choices=["device", "asyncio"],
                    default="device",
                    help="device (default): K15 fills 600-second blocks on "
                         "the card (the JAX CLI's --backend jax); asyncio: "
                         "per-second numpy sampling (the reference's)")
    mt.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the device backend's device: cuda (default) "
                         "launches K15; cpu runs its plain version")

    fb = sub.add_parser("fanoutbroker", help="TCP fanout broker for "
                        "tcp:// URLs (the in-tree stand-in for RabbitMQ)")
    fb.add_argument("--host", default="127.0.0.1",
                    help="interface to listen on (default 127.0.0.1)")
    fb.add_argument("--port", type=int, default=5673,
                    help="TCP port (default 5673; 0 picks a free one)")
    fb.add_argument("--max-backlog", type=int, default=None,
                    help="per-subscriber buffered messages before the "
                         "oldest is dropped (default 10000; "
                         "tcpbroker.dropped_total counts the drops)")
    fb.add_argument("-v", "--verbose", action="count", default=0)
    for sp in (pv, mt, sv):
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
                  seed=args.seed, output="reduce", tune=args.tune,
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


def fanoutbroker(args) -> int:
    from tmhpvsim_torch.runtime import asyncrun
    from tmhpvsim_torch.runtime.tcpbroker import (MAX_SUBSCRIBER_BACKLOG,
                                                  TcpFanoutBroker)

    _setup_logging(args.verbose)

    async def run():
        broker = TcpFanoutBroker(
            args.host, args.port,
            max_backlog=(MAX_SUBSCRIBER_BACKLOG if args.max_backlog is None
                         else args.max_backlog))
        await broker.start()
        print(f"fanout broker listening on {broker.host}:{broker.port}",
              file=sys.stderr, flush=True)
        await broker.serve_forever()

    asyncrun(run())
    return 0


def metersim(args, parser) -> int:
    from tmhpvsim_torch.apps.metersim import metersim_main
    from tmhpvsim_torch.runtime import asyncrun

    if args.compile_cache is not None and args.backend != "device":
        parser.error("--compile-cache requires --backend=device")
    start = _parse_start(parser, args.start)
    _setup_logging(args.verbose)
    try:
        asyncrun(metersim_main(args.amqp_url, args.exchange, args.realtime,
                               args.seed, args.duration, start,
                               backend=args.backend, device=args.device))
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"metersim: {e}") from e
    return 0


def pvsim_stream(args, parser) -> int:
    """``pvsim --backend asyncio``: the streaming consumer."""
    from tmhpvsim_torch.apps.pvsim import pvsim_main
    from tmhpvsim_torch.runtime import asyncrun

    for name, default in DEVICE_ONLY.items():
        if getattr(args, name) != default:
            parser.error(f"--{name.replace('_', '-')} requires "
                         "--backend=device")
    start = _parse_start(parser, args.start)
    _setup_logging(args.verbose)
    asyncrun(pvsim_main(args.file, args.amqp_url, args.exchange,
                        args.realtime, args.seed, args.duration, start,
                        run_report_path=args.run_report))
    return 0


def main(argv=None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    for flag in WAITING_FLAGS:
        if getattr(args, _waiting_dest(flag), None) is not None:
            parser.error(f"{flag} is not ported to tmhpvsim_torch yet")
    if getattr(args, "mesh_scenario", None) is not None:
        parser.error("--mesh-scenario (the 2-D (chains, scenario) mesh) is "
                     "not ported to tmhpvsim_torch yet")
    if args.command == "fanoutbroker":
        return fanoutbroker(args)
    if args.command == "pvsim" and args.backend == "asyncio":
        return pvsim_stream(args, parser)
    if args.compile_cache is not None:
        from tmhpvsim_torch.kernels import build

        build.set_build_dir(args.compile_cache)
    if args.command == "serve":
        return serve(args)
    if args.command == "metersim":
        return metersim(args, parser)
    if args.duration is None:
        parser.error("--duration is required with --backend=device")
    if args.checkpoint_keep < 1:
        parser.error("--checkpoint-keep must be >= 1")
    if args.preempt_grace < 0:
        parser.error("--preempt-grace must be >= 0")
    given = [f for f in PROCESS_FLAGS if getattr(args, f) is not None]
    if given and not args.sharded:
        parser.error("--coordinator/--num-processes/--process-id require "
                     "--sharded")
    if given and len(given) != len(PROCESS_FLAGS):
        parser.error("--coordinator, --num-processes and --process-id go "
                     "together")
    if args.num_processes is not None and not (
            args.num_processes >= 1
            and 0 <= args.process_id < args.num_processes):
        parser.error("--process-id must be in [0, --num-processes)")
    if args.sharded and args.prng_impl != "threefry2x32":
        parser.error(f"--prng-impl {args.prng_impl} is not sharded: jax "
                     "draws a batch of such keys from its first key, so a "
                     "shard's draws depend on its batch")
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
    seed = args.seed
    if seed is None and args.checkpoint:
        from tmhpvsim_torch.engine import checkpoint as ckpt

        if ckpt.resumable(args.checkpoint):
            # a resume without --seed takes the checkpoint's seed (the
            # default would fail its config check)
            seed = ckpt.peek_meta(args.checkpoint).get(
                "config", {}).get("seed")
    try:
        pvsim(args.file, args.duration, args.chains,
              0 if seed is None else seed, start,
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
              prng_impl=args.prng_impl, sharded=args.sharded,
              coordinator=args.coordinator,
              num_processes=args.num_processes, process_id=args.process_id,
              checkpoint=args.checkpoint,
              checkpoint_keep=args.checkpoint_keep,
              checkpoint_async=args.checkpoint_async,
              preempt_grace_s=args.preempt_grace, tune=args.tune)
    except (ValueError, NotImplementedError, DriftError) as e:
        raise SystemExit(f"pvsim: {e}") from e
    return 0


if __name__ == "__main__":
    sys.exit(main())
