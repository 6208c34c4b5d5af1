"""Reduce-mode ``pvsim`` on the port: per-chain summary statistics of a
multi-chain PV + meter simulation, written as CSV (the JAX package's
``pvsim --backend jax --output reduce`` file format)."""

from __future__ import annotations

import csv
import time

from tmhpvsim_torch.config import SimConfig
from tmhpvsim_torch.engine.simulation import REDUCE_STATS, Simulation


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


def pvsim_reduce(file: str, duration_s: int, n_chains: int, seed: int,
                 start: str, block_s: int | None = None,
                 device: str = "cuda") -> Simulation:
    """Run reduce mode and write ``file``; returns the Simulation."""
    if block_s is None:
        block_s = min(8640, max(60, (duration_s // 60) * 60))
    cfg = SimConfig(start=start, duration_s=duration_s, n_chains=n_chains,
                    seed=seed, block_s=block_s, output="reduce")
    sim = Simulation(cfg, device=device)
    t0 = time.perf_counter()
    reduced = sim.run_reduced()
    wall = time.perf_counter() - t0
    ensemble = sim.ensemble_stats()
    write_reduced_csv(file, reduced, ensemble)
    print(f"pvsim[reduce]: {n_chains} chains x {duration_s} s on "
          f"{sim.device} in {wall:.3f} s "
          f"({n_chains * duration_s / wall:.4g} site-s/s incl. set-up); "
          f"fleet pv_max {ensemble['pv_max']:.1f} W")
    return sim
