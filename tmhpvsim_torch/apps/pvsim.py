"""``pvsim`` on the port: a multi-chain PV + meter simulation written as CSV,
in the JAX package's ``pvsim --backend jax`` file formats.

* ``trace`` (the default): one chain's per-second rows ``time, meter, pv,
  residual load`` (the reference CSV format);
* ``ensemble``: the same rows for the per-second fleet means;
* ``reduce``: per-chain summary statistics plus one fleet ``ensemble`` row.

Each runs for a shared site, a per-chain ``SiteGrid`` or a heterogeneous
fleet, in the scan or the wide formulation (``block_impl``), with any
number of blocks per dispatch; reduce mode can fold the fleet analytics.
``compute_dtype='bf16'`` runs the bf16 block step (K12) watched by the
telemetry and, in reduce mode, the drift sentinel (``telemetry``,
``telemetry_strict``).  ``run_report`` writes the run report
(obs/report.py: the JAX package's RunReport schema) with the run's
config, its resolved plan, the analytics' run totals as the ``fleet``
section, the sentinel's verdict as the ``telemetry`` section and the
``precision`` section of the levers ``compute_dtype``, ``kernel_impl``,
``rng_batch`` and ``geom_stride``.
"""

from __future__ import annotations

import csv
import dataclasses
import time
from zoneinfo import ZoneInfo

from tmhpvsim_torch.config import SimConfig
from tmhpvsim_torch.engine.simulation import (REDUCE_STATS, Simulation,
                                              write_csv)
from tmhpvsim_torch.obs.report import simulation_report, write_report


def write_reduced_csv(path: str, reduced: dict, ensemble: dict,
                      chain_start: int = 0) -> None:
    """Per-chain rows plus one fleet ``ensemble`` row; columns follow
    ``REDUCE_STATS`` (``*_sum`` columns are watt-seconds)."""
    keys = list(REDUCE_STATS)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["chain"] + keys)
        n = len(reduced[keys[0]])
        for i in range(n):
            w.writerow([chain_start + i] + [reduced[k][i] for k in keys])
        w.writerow(["ensemble"] + [ensemble[k] for k in keys])


def _paced(blk, rate: float = 1.0):
    """Re-emit a BlockResult as single-row blocks on the wall-clock grid
    (``--realtime``)."""
    t0 = time.monotonic()
    for i in range(len(blk.epoch)):
        behind = (time.monotonic() - t0) - i / rate
        if behind < 0:
            time.sleep(-behind)
        yield dataclasses.replace(
            blk, offset=blk.offset + i, epoch=blk.epoch[i:i + 1],
            meter=blk.meter[:, i:i + 1], pv=blk.pv[:, i:i + 1],
            residual=blk.residual[:, i:i + 1])


def write_run_report(path: str, sim: Simulation) -> dict:
    """The run report of a finished run (``obs.report.simulation_report``):
    config, plan and device, the ``fleet`` section as
    ``sim.fleet_summary()`` gives it (None without analytics), the
    ``telemetry`` section as ``sim.sentinel.report()`` gives it (None when
    no block was observed) and the ``precision`` section as
    ``sim.precision_doc()`` gives it (None with the levers at their
    defaults).  Returns the document."""
    return write_report(path, simulation_report("pvsim", sim))


def pvsim(file: str, duration_s: int, n_chains: int, seed: int, start: str,
          chain: int = 0, block_s: int | None = None, realtime: bool = False,
          site_grid=None, output: str = "trace",
          output_overlap: str = "auto", device: str = "cuda", fleet=None,
          analytics: str = "off", run_report: str | None = None,
          kernel_impl: str = "auto", geom_stride: int = 0,
          block_impl: str = "auto", blocks_per_dispatch: int = 0,
          rng_batch: str = "auto", compute_dtype: str = "auto",
          telemetry: str = "off",
          telemetry_strict: bool = False,
          prng_impl: str = "threefry2x32") -> Simulation:
    """Run one simulation and write ``file``; returns the Simulation.

    A site grid or a fleet sets the chain count (one chain per site).
    ``realtime`` releases trace / ensemble rows on the 1 Hz wall-clock
    grid; reduce mode has no rows to pace and refuses it.  ``analytics``
    folds the fleet-risk sketches in reduce mode (other modes ignore it,
    as the JAX package does); ``run_report`` names the JSON their run
    totals go to.  ``kernel_impl`` ('auto' | 'exact' | 'table') and
    ``geom_stride`` (0 = auto | 1 | 30 | 60) are the precision levers;
    ``block_impl`` ('auto' | 'wide' | 'scan' | 'scan2'),
    ``blocks_per_dispatch`` (0 = auto | K) and ``rng_batch`` ('auto' |
    'scan' | 'block') the plan knobs that give the same run.
    ``compute_dtype`` ('auto' = 'f32' | 'f32' | 'bf16') the compute path;
    ``telemetry`` ('off' | 'light' | 'full', reduce mode) folds the
    numerics telemetry that the drift sentinel checks every block ('off'
    becomes 'light' under bf16), and ``telemetry_strict`` turns the
    sentinel's warnings into ``DriftError``.  ``prng_impl``
    ('threefry2x32' | 'rbg') the key implementation (rbg: K13's Philox
    bits on the card)."""
    if block_s is None:
        block_s = min(8640, max(60, (duration_s // 60) * 60))
    cfg = SimConfig(start=start, duration_s=duration_s, n_chains=n_chains,
                    seed=seed, block_s=block_s, site_grid=site_grid,
                    fleet=fleet, output=output,
                    output_overlap=output_overlap, analytics=analytics,
                    kernel_impl=kernel_impl, geom_stride=geom_stride,
                    block_impl=block_impl,
                    blocks_per_dispatch=blocks_per_dispatch,
                    rng_batch=rng_batch, compute_dtype=compute_dtype,
                    telemetry=telemetry, telemetry_strict=telemetry_strict,
                    prng_impl=prng_impl)
    sim = Simulation(cfg, device=device)
    cfg = sim.config  # a site grid or a fleet sets n_chains
    t0 = time.perf_counter()
    if output == "reduce":
        if realtime:
            raise ValueError("reduce mode has no per-second rows to pace; "
                             "drop --realtime")
        reduced = sim.run_reduced()
        wall = time.perf_counter() - t0
        ensemble = sim.ensemble_stats()
        write_reduced_csv(file, reduced, ensemble)
        print(f"pvsim[reduce]: {cfg.n_chains} chains x {duration_s} s on "
              f"{sim.device} in {wall:.3f} s "
              f"({cfg.n_chains * duration_s / wall:.4g} site-s/s incl. "
              f"set-up); fleet pv_max {ensemble['pv_max']:.1f} W")
        if run_report:
            write_run_report(run_report, sim)
        return sim
    if output == "ensemble" and chain != 0:
        raise ValueError("ensemble mode writes the fleet mean; --chain "
                         "does not apply (drop it or use trace mode)")
    if not 0 <= chain < cfg.n_chains:
        raise ValueError(f"--chain {chain} out of range for "
                         f"{cfg.n_chains} chains")
    runner = sim.run_ensemble if output == "ensemble" else sim.run_blocks

    def blocks():
        for blk in runner():
            if realtime:
                yield from _paced(blk)
            else:
                yield blk

    write_csv(file, blocks(), chain=chain, tz=ZoneInfo(sim.timezone))
    wall = time.perf_counter() - t0
    print(f"pvsim[{output}]: {cfg.n_chains} chains x {duration_s} s on "
          f"{sim.device} in {wall:.3f} s "
          f"({cfg.n_chains * duration_s / wall:.4g} site-s/s incl. set-up "
          "and CSV)")
    if run_report:
        write_run_report(run_report, sim)
    return sim
