"""Chain slabs: a large run as sequential slab-sized runs (own port of
tmhpvsim_tpu/engine/slab.py).

A plan whose ``slab_chains`` is below ``n_chains`` runs the chains in
slabs of ``slab_chains``, each a plain ``Simulation`` of chains ``[off,
off + n)`` of the notional whole run (``parallel.distributed.
carve_config``: the keys of ``split(seed key, n_chains)`` sliced at the
offset, the site grid and fleet rows sliced alike), one at a time, each
freed before the next is built.

Under threefry2x32 every draw is keyed by its chain's key and a global
index, so the slabs' reduce rows, concatenated, are the unslabbed rows
bit for bit.  The ensemble series folds the slabs' per-second parts in
the order of one launch over all chains (``kernels.block_step.
series_strands``), so on the card its sums over chains are the
unslabbed bits when ``slab_chains`` is a multiple of the kernels' chains
a CTA (``block_step.THREADS``); on the CPU the parts are each slab's
float64 sums, added in slab order before the one rounding to float32.
The fleet analytics' run totals merge across slabs as across blocks (``obs.analytics.merge``): counts and extrema
exactly.  Under rbg and unsafe_rbg a chain's draws depend on its batch,
so a slab changes them, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from tmhpvsim_torch.config import Plan, SimConfig
from tmhpvsim_torch.kernels import block_step as k3
from tmhpvsim_torch.obs import analytics as flt
from tmhpvsim_torch.obs import metrics as obs_metrics


class SlabScheduler:
    """Sequential slabs of ``config`` under ``plan`` on ``device``; built
    by ``Simulation`` when ``plan.slab_chains < n_chains``."""

    def __init__(self, config: SimConfig, plan: Plan, device=None):
        if config.n_chains_total is not None:
            raise ValueError(
                "SlabScheduler cannot re-slab an explicit chain slab "
                "(n_chains_total is already set)")
        if not 0 < plan.slab_chains < config.n_chains:
            raise ValueError(
                f"slab_chains={plan.slab_chains} must be in "
                f"(0, n_chains={config.n_chains}) to slab")
        from tmhpvsim_torch.parallel.distributed import carve_config

        self.config = config
        self.plan = plan
        self.device = device
        total, slab = config.n_chains, plan.slab_chains
        self.slab_cfgs = [carve_config(config, off,
                                       min(slab, total - off), total=total)
                          for off in range(0, total, slab)]
        #: the fleet analytics' run total over every slab (tensors), None
        #: with the analytics off
        self.fleet_run = None

    def __len__(self):
        return len(self.slab_cfgs)

    def checkpoint_layout(self) -> dict:
        """The whole run's layout, as the unslabbed run writes it."""
        from tmhpvsim_torch.parallel.distributed import chain_layout

        return chain_layout(self.config.n_chains)

    def _slabs(self):
        """``(index, Simulation)`` of each slab in turn, under the plan
        with its slabbing consumed; the slab gauges follow."""
        from tmhpvsim_torch.engine.simulation import Simulation

        reg = obs_metrics.get_registry()
        reg.gauge("slab.total").set(len(self.slab_cfgs))
        done = reg.gauge("slab.completed")
        done.set(0)
        reg.counter("slab.runs_total").inc()
        for si, cfg in enumerate(self.slab_cfgs):
            plan = dataclasses.replace(self.plan, slab_chains=cfg.n_chains)
            yield si, Simulation(cfg, device=self.device, plan=plan)
            done.set(si + 1)

    def run_reduced(self, on_block=None) -> dict:
        """The whole run's per-chain statistics: each slab's
        ``run_reduced`` in chain order.  ``on_block(bi, state, acc)`` gets
        a global block counter, slab-major (slab 0's blocks, then slab
        1's, ...)."""
        outs = []
        gblock = 0
        for _, sim in self._slabs():
            cb = None
            if on_block is not None:
                def cb(bi, state, acc, _g=gblock):
                    return on_block(_g + bi, state, acc)
            outs.append(sim.run_reduced(on_block=cb))
            gblock += sim.n_blocks
            if sim._fleet_run is not None:
                self.fleet_run = flt.merge(self.fleet_run, sim._fleet_run)
            del sim  # free the slab's buffers before the next is built
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def run_ensemble(self) -> Iterator:
        """The whole run's per-second fleet means: each slab runs to its
        end in turn; each block's series parts are folded as they arrive
        into that block's float64 strands (``k3.series_strands``, the
        parts numbered across slabs in chain order), so the host keeps
        ``2 * SUM_STRANDS`` float64 a second of the run, whatever the
        chain count; at the end each block's strands are added
        (``k3.strands_total``) and divided by ``n_chains`` as
        ``Simulation.run_ensemble`` divides."""
        from tmhpvsim_torch.engine.simulation import BlockResult

        blocks = []  # (offset, epoch, n_valid, strands) a block
        first = 0  # parts of the slabs before this one
        for si, sim in self._slabs():
            k = 0
            for bi, (off, ep, nv, p) in enumerate(sim.series_parts()):
                p = torch.from_numpy(p)
                k = p.shape[1]
                if si == 0:
                    blocks.append((off, ep, nv, k3.series_strands(p)))
                else:
                    k3.series_strands(p, blocks[bi][3], first)
            first += k
            del sim
        inv_n = 1.0 / self.config.n_chains
        for off, epoch, n_valid, strands in blocks:
            sums = k3.strands_total(strands).numpy()
            m = sums[0][None, :n_valid] * inv_n
            p = sums[1][None, :n_valid] * inv_n
            yield BlockResult(offset=off, epoch=epoch, meter=m, pv=p,
                              residual=m - p)
