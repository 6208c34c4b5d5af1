"""Chain-parallel runs over processes (own port of the batch half of
tmhpvsim_tpu/parallel/mesh.py's ``ShardedSimulation``).

The JAX package shards the chain axis over a device mesh and reduces the
cross-chain quantities with ``psum`` / ``pmin`` / ``pmax`` inside
``shard_map``.  The port runs one process per card over
``torch.distributed`` (parallel/distributed.py): each rank simulates its
contiguous chains with the card's kernels, exactly as an unsharded run
of a chain slab, and the few cross-chain quantities are reduced once per
block with ``all_reduce``:

* reduce mode: each block's telemetry and analytics deltas in one
  packed tree, right after the launch (so the drift sentinel, the
  metrics and ``fleet_summary`` see the whole run on every rank, and a
  strict sentinel raises on every rank alike), and at the end
  ``ensemble_stats`` (each rank's float64 / int64 fold of its chains,
  then reduced likewise);
* ensemble mode: each block's per-second meter and pv sums over the
  rank's chains, packed into one ``all_reduce``; the means divide by the
  whole run's ``n_chains``;
* trace mode: the rank's chains only, with ``.ensemble`` (``pv_mean``,
  ``residual_mean``) the whole run's per-second means from the wide
  series of the rank's trace, reduced likewise.

Every rank runs every block and so reaches the same collectives in the
same order.  ``self.config`` is the whole run's config (what the CLI
reads back); ``self.local_config`` the rank's carve.

Checkpoints are per process: a rank saves its own chains (with the
layout of its global range, ``checkpoint_layout``), resumes from its own
file, or takes its range of a whole-run checkpoint or of another process
count's files (``resume_chain_slice``, ``checkpoint.load_elastic``).

Left to the JAX package (ROADMAP): ``prng_impl`` 'rbg' and 'unsafe_rbg'
(there a shard's batch decides the draws), the 2-D ``(chains,
scenario)`` mesh, sharded serving and the per-mesh autotuner.
"""

from __future__ import annotations

from typing import Iterator

from tmhpvsim_torch.config import SimConfig
from tmhpvsim_torch.engine.simulation import (REDUCE_STATS, BlockResult,
                                              Simulation, resolve_chains)
from tmhpvsim_torch.kernels import wide
from tmhpvsim_torch.parallel import distributed


def _map_leaves(tree, fn):
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


class ShardedSimulation(Simulation):
    """``Simulation`` of this rank's share of ``config``'s chains in the
    default process group (a world of one without a group).

        distributed.initialize(...)        # or a launcher's environment
        sim = ShardedSimulation(config)    # n_chains divisible by ranks
        rows = sim.run_reduced()           # this rank's chains
        fleet = sim.ensemble_stats()       # the whole run's, every rank

    A rank's per-chain results are the unsharded run's rows of its chains
    (the same keys and site rows, the same kernels, one thread per
    chain); what is summed over chains is summed in another order."""

    def __init__(self, config: SimConfig, device=None):
        if config.prng_impl != "threefry2x32":
            raise NotImplementedError(
                f"SimConfig.prng_impl={config.prng_impl!r} is not sharded: "
                "jax draws a vmapped batch of such keys from its first key, "
                "so a shard's draws depend on its batch; shard "
                "threefry2x32 runs")
        if config.n_chains_total is not None or config.chain_offset:
            raise ValueError("a sharded run carves its ranks' chain slabs "
                             "itself: leave n_chains_total and "
                             "chain_offset unset")
        whole = resolve_chains(config)
        rank, size = distributed.world()
        sl = distributed.local_chain_slice(whole.n_chains, rank, size)
        super().__init__(distributed.carve_process_config(whole, rank, size),
                         device=distributed.rank_device(device))
        self.config = whole
        self.rank, self.world, self.chain_slice = rank, size, sl
        # the ranks partition the chains themselves
        self.allow_slabs = False

    def checkpoint_layout(self) -> dict:
        """The rank's global chain range, the group's processes and its
        cards (one a process)."""
        return distributed.chain_layout(self.config.n_chains, sharded=True)

    def resume_chain_slice(self):
        """The rank's global chains ``(start, stop)`` of a whole-run
        checkpoint; None in a world of one (it holds every chain)."""
        if self.world == 1:
            return None
        return self.chain_slice.start, self.chain_slice.stop

    def _place_resume(self, tree, what: str = "state"):
        """A tree of the whole run's chains (a whole-run state handed to
        every rank) is cut to the rank's chains first; a tree of the
        rank's chains (its own checkpoint, or ``resume_chain_slice`` of
        one) is placed as it is."""
        n = self.config.n_chains
        if self.world > 1:
            sl = self.chain_slice
            tree = _map_leaves(
                tree, lambda v: v[sl] if v.shape[:1] == (n,) else v)
        return super()._place_resume(tree, what)

    def mesh_doc(self) -> dict:
        """The run report's ``mesh`` section."""
        return distributed.mesh_doc(self.config.n_chains, self.rank,
                                    self.world)

    def _share_deltas(self) -> None:
        # an observer that is off leaves its delta None
        self._tel_last, self._fleet_last = distributed.allreduce_deltas(
            self._tel_last, self._fleet_last)

    def _share_series(self, m_sum, p_sum):
        return distributed.allreduce_sums(m_sum, p_sum)

    def _share_stats(self, stats: dict) -> dict:
        return distributed.allreduce_stats(stats, REDUCE_STATS, self.device)

    def any_process(self, flag: bool) -> bool:
        return distributed.any_rank(flag, self.device)

    def run_blocks(self, state=None, start_block: int = 0
                   ) -> Iterator[BlockResult]:
        """Trace mode: BlockResults of this rank's chains, each with
        ``.ensemble`` the whole run's per-second ``pv_mean`` and
        ``residual_mean`` (the rank's wide series of its trace, summed
        over ranks, times ``1 / n_chains`` in host float32)."""
        inv_n = 1.0 / self.config.n_chains

        def step(state, inputs):
            state, meter, pv_ = self.step_trace(state, inputs)
            return (state, meter, pv_,
                    *self._share_series(*wide.wide_series(meter, pv_)))

        def make(off, epoch, n_valid, meter, pv_, m_sum, p_sum):
            m = meter.T[:, :n_valid]
            p = pv_.T[:, :n_valid]
            ms, ps = m_sum[:n_valid], p_sum[:n_valid]
            return BlockResult(offset=off, epoch=epoch, meter=m, pv=p,
                               residual=m - p,
                               ensemble={"pv_mean": ps * inv_n,
                                         "residual_mean": (ms - ps) * inv_n})

        return self._iter_blocks(state, start_block, step, make)
