"""Blockwise simulation on torch (own port of the trace, reduce and ensemble
paths of tmhpvsim_tpu/engine/simulation.py).

Time runs in blocks of ``config.block_s`` seconds, padded to whole blocks
(padding seconds are masked out of every statistic by ``t < duration_s``
and trimmed from every per-second output).  Per block:

1. the host computes the block's calendar in numpy and, for a shared
   site, the whole chain-independent solar geometry in float64; a site
   grid instead ships the float32-safe split time and evaluates its
   geometry per chain on the device (``host_arrays``); the loop computes
   block N+1's inputs, and enqueues their pinned non-blocking copies, right
   after it has enqueued block N, so they overlap the card's work on N;
2. K2 regenerates each chain's sampler windows from global-index-keyed
   draws and advances the Markov carry;
3. the block-step kernel runs every second of the block for every chain
   with one of three epilogues: K3 folds the reduce statistics into the
   on-device accumulator (``run_reduced``), K4 sums meter and pv over the
   chains per second (``run_ensemble``) or writes every chain-second
   (``run_blocks``); a site grid runs its K6 geometry mode.

Three precision levers (``self.plan``, resolved as the JAX package
resolves them): ``kernel_impl='table'`` runs every transcendental of the
solar / pv chain through the table set (K11: the block step's Table
instantiations; the shared site's float64 host geometry stays exact, as in
the JAX package); ``geom_stride`` 30 or 60 evaluates the geometry on a
stride grid and lerps it to 1 Hz — on the host in float64 for a shared
site (the kernel is unchanged), on the card per chain for a site grid
(K6s, the block step's strided mode, fed the sample grid's split time);
``compute_dtype='bf16'`` runs K12, the block step's bf16 instantiations
(the shared site's geometry rows rounded to bf16 on the host, ``doy``
kept float32).  bf16 never runs unwatched: its plan raises telemetry to at
least 'light', and in reduce mode every block's telemetry summary goes to
the metrics registry and to the drift sentinel (obs/sentinel.py, against
the float64 golden model), which raises ``DriftError`` under
``telemetry_strict``.

The formulation (``plan.block_impl``): 'scan' and 'scan2' run the block
step above (the port's one scan kernel draws each minute's random tile in
registers, so 'scan2', ``scan_unroll`` and ``rng_batch`` give the same
bits); 'wide' materialises each block's time-major ``(block_s, n)``
meter and pv with the trace launch, then folds them with the K4 merges
(kernels/wide.py): the statistics, or with an observer on the wide
telemetry and fleet folds, into ``acc`` (``stats_fusion='split'``; 'fused'
is the acc launch, producer, statistics and merge in one), and per
second the sums over chains in ensemble mode.  ``blocks_per_dispatch``
groups blocks: a group's inputs reach the card in one copy and its
launches are enqueued back to back.

A heterogeneous fleet (``config.fleet``) adds K7: each chain's Markov
steps come from its weather regime's table (in K2) and its pv and meter
take its capacity, inverter-limit and demand transforms (in every
epilogue).  In reduce mode the telemetry (K8) alone folds in the acc
launch; with the fleet analytics (K9) on, the acc producer writes the
block's arrays and the observer fold folds both observers over them;
each block's deltas come out
zero-initialised and collapsed, and the host keeps the last telemetry
delta with its summary and merges the analytics into run totals
(``fleet_summary``).

Scenario serving (``serve/``) runs the reduce step batched over scenario
rows: ``scenario_step`` launches K10, which takes each second's meter and
pv once per chain and folds every row's knob transform of them into a
``(B, n)`` accumulator (``init_scenario_acc``) and a per-block ``risk``
FleetAcc delta of the sketch ``scenario_fleet_params``.

``prng_impl='rbg'`` keys (``(n, 4)``) draw their bits from Philox
(K13, csrc/philox.cuh, inlined in K2 and the block step): jax draws a
vmapped batch from its first key, so a chain's values depend on its batch
and on the formulation's draw layout (``_draw_layout``), and the port
reproduces each JAX formulation's own layout.  ``prng_impl='unsafe_rbg'``
keys draw the same bits and derive their keys from Philox rows too (K14:
``split`` / ``fold_in`` are draws, batched by the same rule), so a
chain's keys come from chain 0's and its position in the batch, and a
batched fold over a window's values from the window's first index.  The
key implementation is the plan's ``prng_impl``, passed to every
derivation, draw and launch (``self._impl``); nothing reads it off a
key's shape.

The chain state is O(1) per chain: threefry (or rbg) keys, the Markov
carry, the renewal carry, three construction-time scalars, for a grid the
six site
scalars and, for a fleet, its heterogeneous columns (``state["fleet"]``).
With the block offset (and in reduce mode the accumulator) it is a
complete checkpoint (engine/checkpoint.py, in the JAX package's layout
through ``engine/convert.py``): the run loops take a resumed state and
accumulator as tensors or as that layout's numpy (``_place_resume``).
A plan whose ``slab_chains`` is below ``n_chains`` runs a fresh reduce or
ensemble run as sequential chain slabs (engine/slab.py) with the
unslabbed run's results.
Every kernel wrapper runs its plain torch version on CPU tensors, so
``Simulation(config, device="cpu")`` is the reference implementation of
the same run.
"""

from __future__ import annotations

import csv
import dataclasses
import datetime as _dt
import math
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from tmhpvsim_torch import rng
from tmhpvsim_torch.config import SITE_FIELDS, Plan, SimConfig, resolve_plan
from tmhpvsim_torch.engine import convert
from tmhpvsim_torch.kernels import block_step as k3
from tmhpvsim_torch.kernels import threefry as k1
from tmhpvsim_torch.kernels import wide
from tmhpvsim_torch.kernels import windows as k2
from tmhpvsim_torch.models import clearsky_index as ci
from tmhpvsim_torch.models import renewal, solar
from tmhpvsim_torch.models.timegrid import TimeGridSpec
from tmhpvsim_torch.obs import analytics as flt
from tmhpvsim_torch.obs import metrics as obs_metrics
from tmhpvsim_torch.obs import telemetry as tel

#: BlockInputs' tensors, in the order ``to_device`` packs them
_DEVICE_FIELDS = ("mh_idx", "mh_frac", "rows_i", "rows_f")
_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}

#: Reduce-mode statistics: name -> (reduction kind, dtype kind); the
#: accumulator, the ensemble fold and the summary-CSV columns follow it.
REDUCE_STATS = {
    "pv_sum": ("sum", "f"),
    "pv_max": ("max", "f"),
    "meter_sum": ("sum", "f"),
    "residual_sum": ("sum", "f"),
    "residual_min": ("min", "f"),
    "residual_max": ("max", "f"),
    "n_seconds": ("sum", "i"),
}


def _round_up(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def resolve_device(device) -> torch.device:
    """``None`` means the card.  Asking for CUDA where there is none
    raises; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain torch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass
class BlockResult:
    """One simulated block on the host (trace and ensemble output).

    Arrays are ``(n_chains, length)`` (a leading axis of 1 for the fleet
    mean); ``epoch`` is ``(length,)`` int64 UTC epoch seconds; ``offset``
    is the block start in simulation seconds.  ``ensemble``: a sharded
    trace's whole-run per-second means ``pv_mean`` and ``residual_mean``
    (``(length,)``; the arrays hold the rank's chains only), else None."""

    offset: int
    epoch: np.ndarray
    meter: np.ndarray
    pv: np.ndarray
    residual: np.ndarray
    ensemble: Optional[dict] = None


@dataclasses.dataclass
class HostArrays:
    """One block's chain-independent inputs as numpy (``host_arrays``)."""

    bounds: k2.Bounds
    mh_idx: np.ndarray      # (n_min,) int32 hour index into the window
    mh_frac: np.ndarray     # (n_min,) float32 hour fraction
    rows_i: np.ndarray      # (4, T) int32
    rows_f: np.ndarray      # (13, T) float32; site grid (6, T), strided (7, T)
    epoch: np.ndarray       # (T,) int64 UTC epoch seconds


@dataclasses.dataclass
class BlockInputs:
    """One block's chain-independent inputs, on the simulation's device."""

    bounds: k2.Bounds
    mh_idx: torch.Tensor
    mh_frac: torch.Tensor
    rows_i: torch.Tensor
    rows_f: torch.Tensor
    epoch: np.ndarray


class Simulation:
    """Simulation of ``config.n_chains`` chains (one per site of
    ``config.site_grid`` or row of ``config.fleet`` when given) on
    ``device`` (default: the card).

        sim = Simulation(config)
        stats = sim.run_reduced()        # dict of (n_chains,) numpy arrays
        fleet = sim.ensemble_stats()     # float64 / int64 fleet aggregates
        risk = sim.fleet_summary()       # analytics on: the run's totals
        for blk in sim.run_blocks(): ... # per-chain BlockResults
        for blk in sim.run_ensemble(): ...  # fleet-mean BlockResults

    ``plan`` replaces the resolved plan (``config.resolve_plan``), as the
    JAX package's ``Simulation(config, plan=...)`` does: a ``slab_chains``
    below ``n_chains`` slabs the run (``allow_slabs``).
    """

    def __init__(self, config: SimConfig, device=None,
                 plan: Optional[Plan] = None):
        if config.block_s % 60 != 0:
            raise ValueError("block_s must be a multiple of 60 (minute grid)")
        config = resolve_chains(config)
        fp, grid = config.fleet, config.site_grid
        # slab bounds after the grid override, which rewrites n_chains
        if config.n_chains_total is not None:
            if (config.chain_offset < 0 or config.chain_offset
                    + config.n_chains > config.n_chains_total):
                raise ValueError(
                    f"chain slab [{config.chain_offset}, "
                    f"{config.chain_offset + config.n_chains}) outside "
                    f"n_chains_total={config.n_chains_total}")
        elif config.chain_offset:
            raise ValueError("chain_offset requires n_chains_total")
        self.config = config
        #: the config of the chains this object holds: ``config`` itself,
        #: or a sharded run's carve of its rank's chains, where ``config``
        #: stays the whole run's (parallel/mesh.py)
        self.local_config = config
        #: this process's rank, the processes of the run and the chains
        #: of ``config`` it holds: a world of one holding every chain
        #: (a sharded run's rank sets its own, parallel/mesh.py)
        self.rank, self.world = 0, 1
        self.chain_slice = slice(0, config.n_chains)
        #: the resolved plan (precision levers, formulation, knobs)
        self.plan = resolve_plan(config) if plan is None else plan
        #: cleared by callers that need one state for the whole run (a
        #: checkpointed run, a sharded one): no slab scheduler then
        self.allow_slabs = True
        self._cd = self.plan.compute_dtype
        self.device = resolve_device(device)
        self.timezone = (grid.timezone if grid is not None
                         else config.site.timezone)
        self._padded_s = _round_up(config.duration_s, config.block_s)
        self.spec = TimeGridSpec.from_local_start(
            config.start, self._padded_s, self.timezone)
        self._f0_hour = ci.start_hour_fraction(self.spec)
        self.n_blocks = self._padded_s // config.block_s
        self._n_minute_vals = None
        # sampler windows: a block spans at most block_s//3600 + 1 hour
        # intervals; +1 early start (cloudy value k reads cc[k-1]), +2
        # interpolation upper values, +1 slack — checked per block
        bs = config.block_s
        self._w_hours = bs // 3600 + 5
        self._w_days = bs // 86400 + 3
        self._w_cd = self._w_hours + self._w_days
        #: the key implementation of every derivation, draw and launch
        self._impl = self.plan.prng_impl
        if self._impl in ("rbg", "unsafe_rbg"):
            # the JAX package's build-time rbg / unsafe_rbg warning; a
            # strict run refuses it, as there
            derive = ("; its split and fold_in are draws too, so a "
                      "chain's keys depend on its batch as well"
                      if self._impl == "unsafe_rbg" else "")
            msg = (f"prng_impl={self._impl!r}: jax draws a vmapped batch "
                   "of rbg keys from its first key, so a chain's draws "
                   f"depend on its batch and formulation{derive}, and "
                   "XLA's RngBitGenerator is not guaranteed stable across "
                   "backends; use threefry2x32 unless you are measuring "
                   f"the {self._impl} path itself")
            if config.telemetry_strict:
                raise ValueError(msg)
            import warnings

            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        self._k_chains = rng.split(
            rng.root_key(config.seed, self._impl), 2, self._impl)[0]
        self._turbidity = None if grid is None else torch.tensor(
            np.asarray(grid.linke_turbidity_monthly, np.float32),
            device=self.device)
        self._output_overlap = config.output_overlap == "auto"
        self._last_acc = None
        self.state = None
        self.state_block = 0
        # only a fleet's heterogeneous columns become state leaves and
        # transforms; a neutral column changes nothing
        self._het_demand = fp is not None and fp.het_demand
        self._het_power = fp is not None and fp.het_power
        self._het_regime = fp is not None and fp.het_regime
        # reduce-mode observers (telemetry as the plan escalates it); the
        # cohort group-by needs >= 2 cohorts
        self._telemetry = self.plan.telemetry
        self._analytics = config.analytics
        self._fleet_params = (flt.params_from_config(config)
                              if self._analytics != "off" else None)
        self._n_cohorts = (fp.n_cohorts if fp is not None
                           and self._analytics != "off"
                           and fp.n_cohorts > 1 else 0)
        #: the last block's telemetry delta
        self._tel_last = None
        #: the drift sentinel, built when telemetry observes its first
        #: block (reduce mode); the metrics registry it publishes into
        self.sentinel = None
        self.metrics = obs_metrics.get_registry()
        #: the last block's analytics delta; the run total (int64 /
        #: float64, on the run's device)
        self._fleet_last = None
        self._fleet_run = None
        #: the acc producer's (T, n) arrays, kept from block to block
        #: while the analytics are on (k3.prod_buffers)
        self._prod_held = {}
        #: Observers of the state whose cohort ids they checked
        self._obs = (None, None)
        #: the scenario fold's sketch and, for a fleet with two or more
        #: cohorts, the chains' cohort ids of its cohort selector
        self._scn_params = None
        self._scn_cohort = None

    # ------------------------------------------------------------------
    # chain state
    # ------------------------------------------------------------------

    def init_state(self):
        """Initial chain state: per-chain keys (threefry ``(n, 2)``, rbg or
        unsafe_rbg ``(n, 4)``) from
        ``split(split(key(seed))[0], n_chains_total)`` sliced at
        ``chain_offset``, the 5- and 4-way key splits, the two primer cloud
        covers, the first windspeed, the renewal carry and the
        construction-time cloudy pair; for a grid also the per-chain site
        scalars (``state["site"]``).  On the card this is K1 and K2
        launches plus elementwise torch (K2 derives the 4-way split of
        ``k_arr`` itself, as it does every block); under rbg the splits
        are K1 on each key half and the renewal uniforms K13 launches,
        drawn as jax's vmapped init draws them (the batch's first key);
        under unsafe_rbg the splits are K14 launches, the chains' 5-way
        split (and K2's 4-way split) batched over the slab, so the keys
        depend on ``chain_offset`` through the slab's first key."""
        cfg = self.local_config
        dev = self.device
        impl = self._impl
        total = cfg.n_chains_total or cfg.n_chains
        keys = k1.split(self._k_chains.to(dev), total, impl)
        keys = keys[cfg.chain_offset:cfg.chain_offset + cfg.n_chains]
        s5 = k1.split(keys.contiguous(), 5, impl)
        k_arr, k_min, k_renew, k_scan, k_meter = (
            s5[:, i, :].contiguous() for i in range(5))
        n = cfg.n_chains
        fp = cfg.fleet
        regime = (torch.tensor(np.asarray(fp.weather_regime, np.int32),
                               device=dev) if self._het_regime else None)
        ones = torch.ones(n, dtype=torch.float32, device=dev)
        no_min = (torch.zeros(0, dtype=torch.int32, device=dev),
                  torch.zeros(0, dtype=torch.float32, device=dev))
        # construction-time primers: cc at global hours 0, 1 from state
        # 1.0 (from the chain's own regime table), and the first windspeed
        t1, _ = k2.sampler_windows(
            k_arr, k_min, ones, ones,
            k2.Bounds(0, 2, 0, 0, 0, 0, 0, 1), *no_min, regime=regime,
            impl=impl)
        cc01 = t1["cc"]                                      # (2, n)
        f0 = self._f0_hour
        cc0 = (cc01[0] * (1 - f0) + cc01[1] * f0).contiguous()
        # the frozen cloudy pair (global indices 0, 1) sees cc0
        t2, _ = k2.sampler_windows(
            k_arr, k_min, ones, cc0,
            k2.Bounds(0, 0, 2, 0, 0, 0, 0, 0), *no_min, impl=impl)
        kr = k1.split(k_renew, 2, impl)
        u_cycle = k1.uniform(kr[:, 0, :].contiguous(), impl=impl)
        u_phase = k1.uniform(kr[:, 1, :].contiguous(), impl=impl)
        carry = renewal.init_from_u(u_cycle, u_phase, cc01[0], t1["ws"][0])
        state = {
            "cc_carry": ones.clone(),
            "cc0": cc0,
            "cloudy_pair": t2["cloudy"].T.contiguous(),
            "carry": {k: v.contiguous() for k, v in carry.items()},
            "k_arr": k_arr,
            "k_min": k_min,
            "k_scan": k_scan,
            "k_meter": k_meter,
        }
        grid = cfg.site_grid
        if grid is not None:
            state["site"] = {
                f: torch.tensor(np.asarray(getattr(grid, f), np.float32),
                                device=dev)
                for f in SITE_FIELDS}

        def f32(col):
            return torch.tensor(np.asarray(col, np.float32), device=dev)

        fleet = {}
        if self._het_demand:
            fleet["demand_scale"] = f32(fp.demand_scale)
            fleet["demand_shift_w"] = f32(fp.demand_shift_w)
        if self._het_power:
            fleet["pv_scale"] = f32(fp.dc_capacity_scale)
            fleet["ac_limit_w"] = f32(fp.ac_limit_w)
        if regime is not None:
            fleet["regime"] = regime
        if self._n_cohorts:
            fleet["cohort"] = torch.tensor(np.asarray(fp.cohort, np.int32),
                                           device=dev)
        if fleet:
            state["fleet"] = fleet
        return state

    def init_reduce_acc(self):
        """Zero accumulator: one ``(n_chains,)`` tensor per statistic."""
        n = self.local_config.n_chains
        big = float(np.finfo(np.float32).max)
        init = {"sum": 0.0, "max": -big, "min": big}
        return {
            name: (torch.zeros(n, dtype=torch.int32, device=self.device)
                   if dkind == "i" else
                   torch.full((n,), init[kind], dtype=torch.float32,
                              device=self.device))
            for name, (kind, dkind) in REDUCE_STATS.items()
        }

    # ------------------------------------------------------------------
    # host-side per-block inputs (chain-independent)
    # ------------------------------------------------------------------

    def host_arrays(self, block_i: int) -> HostArrays:
        """The block's calendar rows, geometry rows (shared site: float64
        ``block_geometry`` cast to float32; grid: the split time), minute
        features and sampler-window bounds (indices rebased to the
        windows), as numpy."""
        cfg = self.config
        off = block_i * cfg.block_s
        blk = self.spec.block(off, cfg.block_s)
        block_idx, (mlo, mhi) = ci.host_block_index(self.spec, off,
                                                    cfg.block_s, blk=blk)
        if self._n_minute_vals is None:
            self._n_minute_vals = mhi - mlo
        if mhi - mlo != self._n_minute_vals:
            raise RuntimeError(
                "minute-value count changed across blocks; block_s must keep "
                "the minute grid aligned")
        h_idx, h_frac = self.spec.minute_value_features(mlo, mhi)

        hb, he = int(blk.hour_idx[0]), int(blk.hour_idx[-1])
        db, de = int(blk.day_idx[0]), int(blk.day_idx[-1])
        hour_lo = max(hb - 1, 0)  # cloudy value k reads cc[k-1]
        day_lo = db
        cd_lo = hour_lo + day_lo
        hour_hi_need = max(he + 1, int(h_idx.max()) + 1)
        if hour_hi_need - hour_lo + 1 > self._w_hours:
            raise RuntimeError(
                f"hour sampler window overflow in block {block_i}: need "
                f"[{hour_lo}, {hour_hi_need}] > {self._w_hours} slots")
        if de + 1 - day_lo + 1 > self._w_days:
            raise RuntimeError(
                f"day sampler window overflow in block {block_i}: need "
                f"[{day_lo}, {de + 1}] > {self._w_days} slots")
        if he + de + 1 - cd_lo + 1 > self._w_cd:
            raise RuntimeError(
                f"clear-day sampler window overflow in block {block_i}: "
                f"need [{cd_lo}, {he + de + 1}] > {self._w_cd} slots")
        if block_i + 1 < self.n_blocks:
            nxt = self.spec.block((block_i + 1) * cfg.block_s, 1)
            hour_next_lo = max(int(nxt.hour_idx[0]) - 1, 0)
        else:
            hour_next_lo = hour_lo  # last block: carry stays put

        block_idx["hour_idx"] = block_idx["hour_idx"] - np.int32(hour_lo)
        block_idx["day_idx"] = block_idx["day_idx"] - np.int32(day_lo)
        stride = self.plan.geom_stride
        if cfg.site_grid is None:
            # the stride is a host lever here: the float64 geometry on the
            # stride grid, lerped back to 1 Hz; the rows keep their shapes
            geom = solar.strided_block_geometry(
                blk.epoch.astype(np.float64), blk.doy.astype(np.float64),
                cfg.site, stride)
            rows_i, rows_f = k3.block_rows(block_idx, mlo, geom)
            if self._cd == "bf16":
                # the geometry cast once to bf16 (through float32, as
                # numpy's bfloat16 casts a float64); doy stays float32
                rows_f[k3.BF16_ROWS] = torch.from_numpy(
                    rows_f[k3.BF16_ROWS]).to(torch.bfloat16).float().numpy()
        elif stride > 1:
            # the stride grid's split time (T // s + 1 samples, the last
            # the exact next second, its doy clamped to the block's last)
            ep_s, doy_s = solar.stride_samples(blk.epoch, blk.doy, stride)
            rows_i, rows_f = k3.strided_rows(
                block_idx, mlo, np.asarray(blk.doy, np.float32), {
                    "day2000": np.asarray(ep_s // 86400 - 10957, np.float32),
                    "sec_of_day": np.asarray(ep_s % 86400, np.float32),
                    "doy": np.asarray(doy_s, np.float32)})
        else:
            # per-chain sites: the float32-safe split time; the geometry
            # is evaluated per chain on the device
            rows_i, rows_f = k3.site_rows(block_idx, mlo, {
                "day2000": np.asarray(blk.epoch // 86400 - 10957,
                                      np.float32),
                "sec_of_day": np.asarray(blk.epoch % 86400, np.float32),
                "doy": np.asarray(blk.doy, np.float32),
            })
        return HostArrays(
            bounds=k2.Bounds(hour_lo, self._w_hours, self._w_hours,
                             hour_next_lo, cd_lo, self._w_cd, day_lo,
                             self._w_days, mlo),
            mh_idx=np.asarray(h_idx - hour_lo, np.int32),
            mh_frac=np.asarray(h_frac, np.float32),
            rows_i=rows_i, rows_f=rows_f,
            epoch=np.asarray(blk.epoch, np.int64))

    def to_device(self, hs: list) -> list:
        """Move blocks' numpy inputs (a list of HostArrays) to the device:
        every array of every block packed into one buffer and, on the
        card, through one pinned buffer in one non-blocking copy on the
        current stream (the caching host allocator keeps a pinned buffer
        from reuse until its copy has run).  Returns a BlockInputs per
        block, whose tensors are views of that buffer."""
        arrays = [np.ascontiguousarray(getattr(h, f)) for h in hs
                  for f in _DEVICE_FIELDS]
        ends = np.cumsum([0] + [a.nbytes for a in arrays])
        buf = torch.empty(int(ends[-1]), dtype=torch.uint8,
                          pin_memory=self.device.type == "cuda")
        packed = buf.numpy()
        for a, lo, hi in zip(arrays, ends[:-1], ends[1:]):
            packed[lo:hi] = a.view(np.uint8).ravel()
        if self.device.type == "cuda":
            buf = buf.to(self.device, non_blocking=True)
        views = [buf[lo:hi].view(_TORCH_DTYPES[a.dtype]).view(a.shape)
                 for a, lo, hi in zip(arrays, ends[:-1], ends[1:])]
        k = len(_DEVICE_FIELDS)
        return [BlockInputs(h.bounds, *views[k * j:k * j + k], h.epoch)
                for j, h in enumerate(hs)]

    def host_inputs(self, block_i: int) -> BlockInputs:
        """``host_arrays`` of the block, on the device."""
        return self.to_device([self.host_arrays(block_i)])[0]

    def _inputs_ahead(self, block_i: int) -> list:
        """The loops' lookahead: the inputs of the dispatch group starting
        at ``block_i`` (``plan.blocks_per_dispatch`` blocks, fewer at the
        end; none past the last block), computed and uploaded together.
        Called once the previous group is enqueued, so the host computes
        them while the card runs it."""
        stop = min(block_i + self.plan.blocks_per_dispatch, self.n_blocks)
        if block_i >= stop:
            return []
        return self.to_device([self.host_arrays(bi)
                               for bi in range(block_i, stop)])

    # ------------------------------------------------------------------
    # the block step
    # ------------------------------------------------------------------

    def _draw_layout(self) -> str:
        """The per-second draw layout of the JAX formulation the acc and
        series launches stand for (``clearsky_index.DRAW_LAYOUTS``; only
        rbg and unsafe_rbg keys tell them apart): a wide run is the JAX
        ``_block_step``
        ('trace', as every trace launch), the nested scan with per-minute
        draws 'scan2', every other scan run the flat scan's pre-drawn
        streams ('scan', as the scenario engine's)."""
        p = self.plan
        if p.block_impl == "wide":
            return "trace"
        if p.block_impl == "scan2" and p.rng_batch == "scan":
            return "scan2"
        return "scan"

    def _windows(self, state, inputs: BlockInputs):
        regime = state["fleet"]["regime"] if self._het_regime else None
        return k2.sampler_windows(
            state["k_arr"], state["k_min"], state["cc_carry"], state["cc0"],
            inputs.bounds, inputs.mh_idx, inputs.mh_frac, regime=regime,
            impl=self._impl)

    def fleet_leaves(self, state):
        """K7's per-chain transform leaves of ``state``, or None."""
        if not (self._het_power or self._het_demand):
            return None
        fl = state["fleet"]
        return k3.FleetLeaves(
            pv_scale=fl.get("pv_scale"), ac_limit_w=fl.get("ac_limit_w"),
            demand_scale=fl.get("demand_scale"),
            demand_shift_w=fl.get("demand_shift_w"))

    def observers(self, state):
        """The reduce-mode observers of this run, or None when both are
        off."""
        if self._telemetry == "off" and self._analytics == "off":
            return None
        cohort = state["fleet"]["cohort"] if self._n_cohorts else None
        if self._obs[1] is None or self._obs[0] is not cohort:
            # Observers reads the cohort ids back to check them: once per
            # run, not once per block
            self._obs = (cohort, k3.Observers(
                telemetry=self._telemetry, analytics=self._analytics,
                params=self._fleet_params, n_cohorts=self._n_cohorts,
                cohort=cohort))
        return self._obs[1]

    def geometry_args(self, state):
        """``(surface_tilt, albedo, site)`` of the block-step wrappers."""
        if self.config.site_grid is None:
            site = self.config.site
            return site.surface_tilt, site.albedo, None
        return None, None, k3.SiteGeometry(state["site"], self._turbidity,
                                           self.plan.geom_stride)

    def step_acc(self, state, inputs: BlockInputs, acc):
        """One reduce block: K2 windows, then K3 (K6 for a grid) folds
        every second into ``acc``, with the telemetry (K8) in the same
        launch, or with the analytics (K9) on as the acc producer and then
        the observer fold (``k3.block_step_obs``); their block deltas land in
        ``_tel_last`` / ``_fleet_last``.  The wide formulation's split
        topology, and as in the JAX package any wide run with an observer
        on, instead launches the trace and then the wide fold (K4 merges,
        with the wide observer folds); its fused topology is the acc
        launch, producer, statistics and merge in one.  Returns ``(state,
        acc)`` (on the card both are updated in place)."""
        cfg = self.config
        obs = self.observers(state)
        if self.plan.block_impl == "wide" and (
                obs is not None or self.plan.stats_fusion == "split"):
            state, meter, pv_ = self.step_trace(state, inputs)
            acc, out = wide.wide_fold(meter, pv_, inputs.rows_i[0],
                                      cfg.duration_s, acc, obs)
            if obs is not None:
                self._tel_last, self._fleet_last = out["telemetry"], \
                    out["fleet"]
            return state, acc
        tables, cc_carry = self._windows(state, inputs)
        tilt, albedo, site = self.geometry_args(state)
        args = (tables, inputs.rows_i, inputs.rows_f, state["k_scan"],
                state["k_meter"], state["carry"], acc, cfg.duration_s,
                cfg.meter_max_w, tilt, albedo)
        fleet = self.fleet_leaves(state)
        ks = self.plan.kernel_impl
        lay = self._draw_layout()
        if obs is None:
            carry, acc = k3.block_step_acc(*args, site=site, fleet=fleet,
                                           kernels=ks, compute_dtype=self._cd,
                                           layout=lay, impl=self._impl)
        else:
            carry, acc, out = k3.block_step_obs(*args, site=site,
                                                fleet=fleet, obs=obs,
                                                kernels=ks,
                                                compute_dtype=self._cd,
                                                layout=lay, impl=self._impl,
                                                held=self._prod_held)
            self._tel_last, self._fleet_last = out["telemetry"], \
                out["fleet"]
        return dict(state, carry=carry, cc_carry=cc_carry), acc

    def step_series(self, state, inputs: BlockInputs):
        """One ensemble block: ``(state, meter_sum, pv_sum)``, the sums
        ``(block_s,)`` over chains per second (padding included): the
        ``series_total`` of ``step_series_parts``."""
        state, parts = self.step_series_parts(state, inputs)
        out = k3.series_total(parts)
        return state, out[0], out[1]

    def step_series_parts(self, state, inputs: BlockInputs):
        """One ensemble block up to its last fold: ``(state, parts)``
        (``k3.series_total``'s input); the wide formulation launches the
        trace and then the wide series kernel."""
        if self.plan.block_impl == "wide":
            state, meter, pv_ = self.step_trace(state, inputs)
            return state, wide.wide_series_parts(meter, pv_)
        tables, cc_carry = self._windows(state, inputs)
        tilt, albedo, site = self.geometry_args(state)
        carry, parts = k3.block_step_series_parts(
            tables, inputs.rows_i, inputs.rows_f, state["k_scan"],
            state["k_meter"], state["carry"], self.config.meter_max_w, tilt,
            albedo, site=site, fleet=self.fleet_leaves(state),
            kernels=self.plan.kernel_impl, compute_dtype=self._cd,
            layout=self._draw_layout(), impl=self._impl)
        return dict(state, carry=carry, cc_carry=cc_carry), parts

    def step_trace(self, state, inputs: BlockInputs):
        """One trace block: ``(state, meter, pv)``, time-major
        ``(block_s, n_chains)``."""
        tables, cc_carry = self._windows(state, inputs)
        tilt, albedo, site = self.geometry_args(state)
        carry, meter, pv_ = k3.block_step_trace(
            tables, inputs.rows_i, inputs.rows_f, state["k_scan"],
            state["k_meter"], state["carry"], self.config.meter_max_w, tilt,
            albedo, site=site, fleet=self.fleet_leaves(state),
            kernels=self.plan.kernel_impl, compute_dtype=self._cd,
            layout="trace", impl=self._impl)
        return dict(state, carry=carry, cc_carry=cc_carry), meter, pv_

    # ------------------------------------------------------------------
    # scenario-batched serving dispatch (serve/)
    # ------------------------------------------------------------------

    def scenario_fleet_params(self) -> flt.FleetParams:
        """The sketch of the scenario fold's ``risk`` FleetAcc, from the
        config whatever ``analytics`` is (any request may ask for the
        fleet result mode)."""
        if self._scn_params is None:
            self._scn_params = flt.params_from_config(self.config)
        return self._scn_params

    def scenario_cohort(self):
        """The chains' cohort ids ``(n,)`` int32 for the cohort
        selector, or None when the run is no fleet of two or more
        cohorts (the JAX package folds no selector then)."""
        fp = self.local_config.fleet
        if self._scn_cohort is None and fp is not None and \
                fp.n_cohorts > 1:
            self._scn_cohort = torch.tensor(
                np.asarray(fp.cohort, np.int32), device=self.device)
        return self._scn_cohort

    def init_scenario_acc(self, batch: int) -> dict:
        """Zero accumulator with a leading scenario axis: one ``(batch,
        n_chains)`` tensor per statistic, with ``init_reduce_acc``'s
        values, so row ``i`` of a batch-of-N run folds exactly what a
        batch-of-1 run of scenario ``i`` folds."""
        b, n = int(batch), self.local_config.n_chains
        big = float(np.finfo(np.float32).max)
        init = {"sum": 0.0, "max": -big, "min": big}
        return {
            name: (torch.zeros((b, n), dtype=torch.int32, device=self.device)
                   if dkind == "i" else
                   torch.full((b, n), init[kind], dtype=torch.float32,
                              device=self.device))
            for name, (kind, dkind) in REDUCE_STATS.items()
        }

    def scenario_step(self, state, inputs: BlockInputs, acc, scen):
        """One scenario-batched block: K2 windows, then K10 (the step
        once per chain-second, every row of ``scen`` folding its own
        transform).  ``scen``: ``(B,)`` knob tensors
        (``serve.schema.encode_batch``); ``acc``: ``init_scenario_acc(B)``
        (updated in place on the card).  Returns ``(state, acc,
        fleet_delta)``; ``fleet_delta`` is the block's ``risk`` FleetAcc
        per row, ``(B, ...)`` leaves, zero-initialised for the block."""
        cfg = self.config
        tables, cc_carry = self._windows(state, inputs)
        tilt, albedo, site = self.geometry_args(state)
        carry, acc, delta = k3.block_step_scenario(
            tables, inputs.rows_i, inputs.rows_f, state["k_scan"],
            state["k_meter"], state["carry"], acc, cfg.duration_s,
            cfg.meter_max_w, tilt, albedo, site=site,
            fleet=self.fleet_leaves(state), scen=scen,
            params=self.scenario_fleet_params(),
            cohort=self.scenario_cohort(), kernels=self.plan.kernel_impl,
            compute_dtype=self._cd, impl=self._impl)
        return dict(state, carry=carry, cc_carry=cc_carry), acc, delta

    # ------------------------------------------------------------------
    # run loops
    # ------------------------------------------------------------------

    def _to_host(self, t: torch.Tensor):
        """Start copying a block output to the host: ``(host tensor,
        event)``; on the card a non-blocking copy into pinned memory,
        finished when the event is."""
        if self.device.type != "cuda":
            return t, None
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return h, ev

    def _gather_result(self, pend, make_result) -> BlockResult:
        """Finish one block: wait for its copies and build the result."""
        bi, epoch, outs = pend
        for _, ev in outs:
            if ev is not None:
                ev.synchronize()
        off = bi * self.config.block_s
        n_valid = min(self.config.block_s, self.config.duration_s - off)
        return make_result(off, epoch[:n_valid], n_valid,
                           *(h.numpy() for h, _ in outs))

    def _iter_blocks(self, state, start_block: int, step: Callable,
                     make_result: Callable) -> Iterator[BlockResult]:
        """The per-block loop of the per-second modes: ``step(state,
        inputs) -> (state, *outs)`` on the device, ``make_result(off,
        epoch, n_valid, *outs)`` on the host (padding trimmed).

        With ``output_overlap='auto'`` block N+1 is dispatched before block
        N's result is built and yielded, so the card computes N+1 while
        the host consumes N; N's outputs are copied (ordered after N's
        kernels, before N+1's) into their own pinned buffers.
        ``self.state`` is then a block ahead of the yielded result
        (``self.state_block == block_index + 2``)."""
        self.state = (self.init_state() if state is None
                      else self._resume_tree(state, "state"))
        self.state_block = start_block
        group, g0 = self._inputs_ahead(start_block), start_block
        pend = None
        for bi in range(start_block, self.n_blocks):
            inputs = group[bi - g0]
            self.state, *outs = step(self.state, inputs)
            self.state_block = bi + 1
            cur = (bi, inputs.epoch, [self._to_host(o) for o in outs])
            if bi + 1 == g0 + len(group):
                group, g0 = self._inputs_ahead(bi + 1), bi + 1
            if not self._output_overlap:
                yield self._gather_result(cur, make_result)
                continue
            if pend is not None:
                yield self._gather_result(pend, make_result)
            pend = cur
        if pend is not None:
            yield self._gather_result(pend, make_result)

    def run_blocks(self, state=None, start_block: int = 0
                   ) -> Iterator[BlockResult]:
        """Trace mode: yield per-chain BlockResults (``(n_chains,
        n_valid)`` meter, pv and residual) in time order."""

        def make(off, epoch, n_valid, meter, pv_):
            m = meter.T[:, :n_valid]       # (T, n) time-major -> (n, T)
            p = pv_.T[:, :n_valid]
            return BlockResult(offset=off, epoch=epoch, meter=m, pv=p,
                               residual=m - p)

        return self._iter_blocks(state, start_block, self.step_trace, make)

    def run_ensemble(self, state=None, start_block: int = 0
                     ) -> Iterator[BlockResult]:
        """Fleet-level 1 Hz series: per-second means of meter, pv and
        residual over all chains, as BlockResults with a leading axis of 1
        (the fleet mean), so every trace consumer works unchanged.  Only
        ``(block_s,)`` sums reach the host; the mean is ``sum * (1 /
        n_chains)`` in host float32, as the JAX package takes it."""
        inv_n = 1.0 / self.config.n_chains

        def make(off, epoch, n_valid, m_sum, p_sum):
            m = m_sum[None, :n_valid] * inv_n
            p = p_sum[None, :n_valid] * inv_n
            return BlockResult(offset=off, epoch=epoch, meter=m, pv=p,
                               residual=m - p)

        def step(state, inputs):
            state, m_sum, p_sum = self.step_series(state, inputs)
            return (state, *self._share_series(m_sum, p_sum))

        if state is None and start_block == 0:
            sched = self._slab_scheduler()
            if sched is not None:
                return sched.run_ensemble()
        return self._iter_blocks(state, start_block, step, make)

    def series_parts(self) -> Iterator[tuple]:
        """``run_ensemble`` of a fresh run before its last fold: per block
        ``(offset, epoch, n_valid, parts)``, ``parts`` the ``(2, k, T)``
        host numpy of ``step_series_parts`` (the slab scheduler's input)."""

        def make(off, epoch, n_valid, parts):
            return off, epoch, n_valid, parts

        return self._iter_blocks(None, 0, self.step_series_parts, make)

    def run_reduced(self, state=None, on_block=None, acc=None,
                    start_block: int = 0):
        """Run every block keeping only per-chain running statistics.

        Returns a dict of ``(n_chains,)`` numpy arrays, one per
        ``REDUCE_STATS`` entry.  ``state``/``acc``/``start_block`` resume a
        run (``acc`` is required with ``start_block > 0``; tensors, or a
        checkpoint's numpy in the JAX layout); ``on_block(block_index,
        state, acc)`` runs after each block.  A fresh run under a slabbing
        plan runs as the slab scheduler's slabs (engine/slab.py).

        Blocks go in dispatch groups of ``plan.blocks_per_dispatch`` (the
        last one may be shorter): a group's host inputs are computed while
        the card runs the previous group and reach the card in one copy
        (``_inputs_ahead``), and its blocks are enqueued back to back.  As
        in the JAX package's K-block dispatch, ``on_block`` then runs for
        each block of the group after the group, with the group's end
        state and the block's own accumulator (a copy kept only when a
        callback is given); the results are the same bits whatever the
        group size.  With the observers on, each block's analytics delta
        is merged into the run total on the device; the host reads the
        totals (``fleet_summary``) and the last block's telemetry
        (``tel_summary``) when asked.  With telemetry on, each block's
        summary goes to the metrics registry and the drift sentinel: with
        ``on_block``, once its group is enqueued and before the callback
        sees the block (a strict sentinel's ``DriftError`` keeps it from
        the callback); without, once the next group is enqueued, so the
        card does not wait on the host."""
        if start_block > 0 and acc is None:
            raise ValueError(
                "resuming run_reduced needs the accumulator: pass acc= "
                "alongside state=/start_block=")
        if state is None and acc is None and start_block == 0:
            sched = self._slab_scheduler()
            if sched is not None:
                reduced = sched.run_reduced(on_block=on_block)
                self._last_acc = {k: torch.from_numpy(v)
                                  for k, v in reduced.items()}
                self._fleet_run = sched.fleet_run
                return reduced
        state = (self.init_state() if state is None
                 else self._resume_tree(state, "state"))
        acc = (self.init_reduce_acc() if acc is None
               else self._resume_tree(acc, "acc"))
        self.state = state
        self.state_block = start_block
        bi, group = start_block, self._inputs_ahead(start_block)
        #: (block index, telemetry delta) not yet observed
        tels = []
        while group:
            snaps = []
            for j, inputs in enumerate(group):
                state, acc = self.step_acc(state, inputs, acc)
                self._share_deltas()
                if self._analytics != "off":
                    self._fleet_run = flt.merge(self._fleet_run,
                                                self._fleet_last)
                if self._telemetry != "off":
                    tels.append((bi + j, self._tel_to_host(self._tel_last)))
                if on_block is not None and len(group) > 1:
                    snaps.append(_clone(acc))
            k = len(group)
            group = self._inputs_ahead(bi + k)
            self.state = state
            self.state_block = bi + k
            if on_block is not None:
                self._observe_telemetry(tels)
                tels = []
                for j in range(k):
                    on_block(bi + j, state, snaps[j] if snaps else acc)
            else:
                # no callback: the previous group's telemetry is observed
                # now that this one is enqueued; its copies were recorded
                # before this group's launches, so the host waits for
                # them only and the card runs this group meanwhile (a
                # strict sentinel's DriftError comes one group late)
                self._observe_telemetry([t for t in tels if t[0] < bi])
                tels = [t for t in tels if t[0] >= bi]
            bi += k
        self._observe_telemetry(tels)
        self._last_acc = acc
        return {k: v.cpu().numpy() for k, v in acc.items()}

    def _tel_to_host(self, delta: dict):
        """Start reading a block's telemetry delta back, right after its
        launch: the leaves packed on the device into one float64 buffer
        (exact for every count and float32 extremum) and copied as
        ``_to_host`` copies.  Returns ``(layout, (host buffer, event))``
        for ``_observe_telemetry``."""
        layout = [(k, v.shape, v.dtype) for k, v in delta.items()]
        flat = torch.cat([v.reshape(-1).double() for v in delta.values()])
        return layout, self._to_host(flat)

    def _observe_telemetry(self, deltas) -> None:
        """The telemetry flush of blocks ``[(block index, pending copy),
        ...]`` (the JAX package's ``_observe_telemetry``): each block's
        copy (``_tel_to_host``) waited for, summarised, published into the
        metrics registry under ``device.*`` and handed to the drift
        sentinel, built at the first block."""
        for bi, (layout, (buf, ev)) in deltas:
            if ev is not None:
                ev.synchronize()
            delta, o = {}, 0
            for k, shape, dtype in layout:
                n = math.prod(shape)
                delta[k] = buf[o:o + n].to(dtype).reshape(shape)
                o += n
            summary = tel.summarize(delta)
            tel.publish(self.metrics, summary)
            if self.sentinel is None:
                from tmhpvsim_torch.obs.sentinel import DriftSentinel

                self.sentinel = DriftSentinel(
                    self.config, level=self._telemetry,
                    strict=self.config.telemetry_strict)
            self.sentinel.observe_block(bi, summary)

    @property
    def tel_summary(self):
        """The last block's telemetry summary (``obs.telemetry.summarize``),
        or None when telemetry is off or no block has run."""
        return None if self._tel_last is None else \
            tel.summarize(self._tel_last)

    @property
    def _fleet_total(self):
        """The analytics run total on the host: numpy int64 counts,
        float64 sums, extrema in float32 (None before a block)."""
        if self._fleet_run is None:
            return None
        return {k: v.cpu().numpy() for k, v in self._fleet_run.items()}

    def fleet_summary(self):
        """The run-total ``fleet`` section (``obs.analytics.summarize``
        of the merged totals), or None when analytics is off or no block
        has run."""
        if self._fleet_total is None or self._fleet_params is None:
            return None
        return flt.summarize(self._fleet_total, self._fleet_params)

    def precision_doc(self):
        """The run report's ``precision`` section when a lever is off its
        default (``compute_dtype`` 'bf16', ``kernel_impl`` 'table',
        ``rng_batch`` 'block' or ``geom_stride`` > 1), else None; the JAX
        package's keys."""
        p = self.plan
        if p.compute_dtype == "f32" and p.kernel_impl == "exact" and \
                p.rng_batch == "scan" and p.geom_stride == 1:
            return None
        return {
            "compute_dtype": p.compute_dtype,
            "kernel_impl": p.kernel_impl,
            "rng_batch": p.rng_batch,
            "geom_stride": p.geom_stride,
            "telemetry": self._telemetry,
            "output_overlap": bool(self._output_overlap),
        }

    def ensemble_stats(self) -> dict:
        """Fleet-wide aggregates of the last ``run_reduced``, folded on the
        host in float64 (int64 for counts).  Returns python floats/ints."""
        np_op = {"sum": np.sum, "max": np.max, "min": np.min}
        out = {}
        for name, (kind, dkind) in REDUCE_STATS.items():
            v = np.asarray(self._last_acc[name].cpu().numpy(),
                           np.int64 if dkind == "i" else np.float64)
            out[name] = (int if dkind == "i" else float)(np_op[kind](v))
        return self._share_stats(out)

    # ------------------------------------------------------------------
    # checkpoints and slabs
    # ------------------------------------------------------------------

    def _slab_scheduler(self):
        """The slab scheduler this run delegates to (engine/slab.py), or
        None: the plan does not slab, the config is itself a slab, or a
        caller cleared ``allow_slabs``."""
        cfg = self.config
        if (not self.allow_slabs or cfg.n_chains_total is not None
                or not 0 < self.plan.slab_chains < cfg.n_chains):
            return None
        from tmhpvsim_torch.engine.slab import SlabScheduler

        return SlabScheduler(cfg, self.plan, device=self.device)

    def _resume_signature(self, what: str, key_dtype: str) -> dict:
        """``{leaf path: (dtype, trailing shape)}`` of this build's state
        (``what='state'``) or accumulator, from the table of its leaves
        (no state is built); key leaves as ``key_dtype``."""
        if what == "acc":
            return {k: ("int32" if d == "i" else "float32", ())
                    for k, (_, d) in REDUCE_STATS.items()}
        sig = {k: (key_dtype, (rng.KEY_WIDTH[self._impl],))
               for k in convert.KEY_LEAVES}
        sig.update(cc_carry=("float32", ()), cc0=("float32", ()),
                   cloudy_pair=("float32", (2,)))
        sig.update({f"carry/{k}": ("float32", ())
                    for k in convert.CARRY_LEAVES})
        if self.local_config.site_grid is not None:
            sig.update({f"site/{k}": ("float32", ()) for k in SITE_FIELDS})
        fleet = ((("demand_scale", "demand_shift_w") if self._het_demand
                  else ()) + (("pv_scale", "ac_limit_w") if self._het_power
                              else ())
                 + (("regime",) if self._het_regime else ())
                 + (("cohort",) if self._n_cohorts else ()))
        sig.update({f"fleet/{k}": (np.dtype(convert.FLEET_LEAVES[k]).name,
                                   ()) for k in fleet})
        return sig

    def _check_resume_layout(self, tree, what: str = "state"):
        """Refuse a resumed state or accumulator whose leaves are not this
        build's (a hand-edited or foreign checkpoint), naming the missing,
        unexpected and mistyped leaves.  Tensors are checked in the port's
        layout (int64 keys), numpy in the JAX layout (uint32 key data);
        the chain axis is checked on placement (``_place_resume``)."""
        leaves = dict(_leaf_items(tree))
        port = any(isinstance(v, torch.Tensor) for v in leaves.values())
        want = self._resume_signature(what, "int64" if port else "uint32")
        got = {k: (str(v.dtype).replace("torch.", ""), tuple(v.shape[1:]))
               for k, v in leaves.items()}
        if want != got:
            changed = sorted(f"{k}: expected {want[k]}, got {got[k]}"
                             for k in set(want) & set(got)
                             if want[k] != got[k])
            raise ValueError(
                f"resume {what} does not match this build's layout: "
                f"missing leaves {sorted(set(want) - set(got)) or '{}'}, "
                f"unexpected leaves {sorted(set(got) - set(want)) or '{}'}, "
                f"dtype/shape mismatches {changed or '{}'} — the "
                "checkpoint was written by an incompatible build or "
                "edited by hand")
        return tree

    def _place_resume(self, tree, what: str = "state"):
        """A resumed state or accumulator as this run's own tensors on its
        device: a checkpoint's numpy in the JAX layout through
        ``engine/convert.py`` (key data checked against the run's key
        implementation), tensors copied.  Every leaf must hold this
        object's chains."""
        if any(isinstance(v, torch.Tensor) for _, v in _leaf_items(tree)):
            tree = _clone(tree, self.device)
        elif what == "acc":
            tree = convert.acc_from_numpy(tree, self.device)
        else:
            tree = convert.state_from_numpy(tree, self.device, self._impl)
        n = self.local_config.n_chains
        bad = sorted(k for k, v in _leaf_items(tree) if v.shape[:1] != (n,))
        if bad:
            raise ValueError(f"resume {what} leaves {bad} do not hold this "
                             f"run's {n} chains")
        return tree

    def _resume_tree(self, tree, what: str):
        return self._place_resume(self._check_resume_layout(tree, what),
                                  what)

    def host_local_tree(self, tree):
        """The checkpointable view of a state or accumulator tree: this
        object holds exactly the chains it checkpoints, so the tree
        itself."""
        return tree

    def checkpoint_layout(self) -> dict:
        """``layout`` of this object's checkpoints
        (``checkpoint.save(layout=...)``): the global chains it holds; an
        explicit slab reports its range of the notional whole run."""
        from tmhpvsim_torch.parallel.distributed import chain_layout

        cfg = self.config
        total = cfg.n_chains_total or cfg.n_chains
        lay = chain_layout(total)
        if total != cfg.n_chains or cfg.chain_offset:
            lay.update(chain_start=int(cfg.chain_offset),
                       chain_stop=int(cfg.chain_offset + cfg.n_chains))
        return lay

    def resume_chain_slice(self):
        """The global chains ``(start, stop)`` this process loads from a
        whole-run checkpoint (``checkpoint.load_elastic``), or None for
        all of them."""
        return None

    # ------------------------------------------------------------------
    # the hooks of a sharded run (parallel/mesh.py); here they do nothing
    # ------------------------------------------------------------------

    def _share_deltas(self) -> None:
        """Make the block's observer deltas (``_tel_last``,
        ``_fleet_last``) the whole run's, right after the launch."""

    def _share_series(self, m_sum, p_sum):
        """The whole run's per-second sums of a block's meter and pv sums
        over this object's chains."""
        return m_sum, p_sum

    def _share_stats(self, stats: dict) -> dict:
        """The whole run's ``ensemble_stats`` of this object's."""
        return stats

    def any_process(self, flag: bool) -> bool:
        """True when ``flag`` is set on any process of the run (every
        process must call it at the same point): here ``flag`` itself."""
        return flag

    def mesh_doc(self) -> Optional[dict]:
        """The run report's ``mesh`` section: None for a run that is not
        sharded."""
        return None


def resolve_chains(config: SimConfig) -> SimConfig:
    """``config`` with its chain axis resolved: a fleet's chain i
    simulates fleet row i (a uniform geometry runs on the shared-site
    path, any other derives the site grid; a site grid given beside the
    fleet must pair 1:1 with it), and a site grid sets ``n_chains``."""
    fp = config.fleet
    if fp is not None:
        if config.site_grid is None:
            if fp.uniform_geometry:
                config = dataclasses.replace(
                    config, n_chains=len(fp), site=fp.uniform_site())
            else:
                config = dataclasses.replace(
                    config, site_grid=fp.site_grid())
        elif len(config.site_grid) != len(fp):
            raise ValueError(
                f"fleet has {len(fp)} sites but site_grid has "
                f"{len(config.site_grid)} — they must pair 1:1 on "
                "the chain axis")
    grid = config.site_grid
    if grid is not None and config.n_chains != len(grid):
        config = dataclasses.replace(config, n_chains=len(grid))
    return config


def _clone(tree, device=None):
    """A private copy of a state/acc dict (the run updates it in place),
    on ``device`` when given."""
    if isinstance(tree, dict):
        return {k: _clone(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def _leaf_items(tree, prefix=""):
    """``(path, leaf)`` of a nested dict, paths '/'-joined."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def write_csv(path: str, blocks: Iterator[BlockResult], chain: int = 0,
              tz=None, append: bool = False):
    """Write the reference CSV format — header ``time,meter,pv,residual
    load``, one row per second — for one selected chain.

    ``tz`` converts the grid's UTC epochs to wall time for the ``time``
    column, written as naive local datetimes (default: the process's local
    timezone).  ``append`` skips the header and adds to an existing
    file."""
    mode = "a" if append else "w"
    with open(path, mode=mode, newline="", buffering=1) as f:
        w = csv.writer(f)
        if not append:
            w.writerow(["time", "meter", "pv", "residual load"])
        for blk in blocks:
            for e, m, p, r in zip(blk.epoch, blk.meter[chain],
                                  blk.pv[chain], blk.residual[chain]):
                t = _dt.datetime.fromtimestamp(int(e), tz)
                if tz is not None:
                    t = t.replace(tzinfo=None)
                w.writerow([t, m, p, r])
