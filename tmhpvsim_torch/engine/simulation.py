"""Blockwise reduce-mode simulation on torch (own port of the reduce path
of tmhpvsim_tpu/engine/simulation.py).

Time runs in blocks of ``config.block_s`` seconds, padded to whole blocks
(padding seconds are masked out of every statistic by ``t < duration_s``).
Per block:

1. the host computes the block's calendar and shared-site solar geometry
   in float64 numpy and ships ~17 float32 rows per second
   (``host_inputs``);
2. K2 regenerates each chain's sampler windows from global-index-keyed
   draws and advances the Markov carry;
3. K3 runs every second of the block for every chain and folds the
   reduce statistics into the on-device accumulator.

The chain state is O(1) per chain: threefry keys, the Markov carry, the
renewal carry and three construction-time scalars.  With the block offset
it is a complete checkpoint; ``engine/convert.py`` moves it to and from the
JAX package's layout.  Every kernel wrapper runs its plain torch version on
CPU tensors, so ``Simulation(config, device="cpu")`` is the reference
implementation of the same run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tmhpvsim_torch import rng
from tmhpvsim_torch.config import SimConfig
from tmhpvsim_torch.kernels import block_step as k3
from tmhpvsim_torch.kernels import threefry as k1
from tmhpvsim_torch.kernels import windows as k2
from tmhpvsim_torch.models import clearsky_index as ci
from tmhpvsim_torch.models import renewal, solar
from tmhpvsim_torch.models.timegrid import TimeGridSpec

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
class BlockInputs:
    """One block's chain-independent inputs, on the simulation's device."""

    bounds: k2.Bounds
    mh_idx: torch.Tensor     # (n_min,) int32 hour index into the window
    mh_frac: torch.Tensor    # (n_min,) float32 hour fraction
    rows_i: torch.Tensor     # (4, T) int32
    rows_f: torch.Tensor     # (13, T) float32


class Simulation:
    """Reduce-mode simulation of ``config.n_chains`` chains on ``device``
    (default: the CUDA card).

        sim = Simulation(config)
        stats = sim.run_reduced()      # dict of (n_chains,) numpy arrays
        fleet = sim.ensemble_stats()   # float64 / int64 fleet aggregates
    """

    def __init__(self, config: SimConfig, device=None):
        if config.block_s % 60 != 0:
            raise ValueError("block_s must be a multiple of 60 (minute grid)")
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
        self.device = resolve_device(device)
        self._padded_s = _round_up(config.duration_s, config.block_s)
        self.spec = TimeGridSpec.from_local_start(
            config.start, self._padded_s, config.site.timezone)
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
        self._k_chains = rng.split(rng.key(config.seed), 2)[0]
        self._last_acc = None

    # ------------------------------------------------------------------
    # chain state
    # ------------------------------------------------------------------

    def init_state(self):
        """Initial chain state: per-chain keys from
        ``split(split(key(seed))[0], n_chains_total)`` sliced at
        ``chain_offset``, the 5- and 4-way key splits, the two primer cloud
        covers, the first windspeed, the renewal carry and the
        construction-time cloudy pair.  On the card this is K1 and K2
        launches plus elementwise torch (K2 derives the 4-way split of
        ``k_arr`` itself, as it does every block)."""
        cfg = self.config
        dev = self.device
        total = cfg.n_chains_total or cfg.n_chains
        keys = k1.split(self._k_chains.to(dev), total)
        keys = keys[cfg.chain_offset:cfg.chain_offset + cfg.n_chains]
        s5 = k1.split(keys.contiguous(), 5)
        k_arr, k_min, k_renew, k_scan, k_meter = (
            s5[:, i, :].contiguous() for i in range(5))
        n = cfg.n_chains
        ones = torch.ones(n, dtype=torch.float32, device=dev)
        no_min = (torch.zeros(0, dtype=torch.int32, device=dev),
                  torch.zeros(0, dtype=torch.float32, device=dev))
        # construction-time primers: cc at global hours 0, 1 from state
        # 1.0, and the first windspeed
        t1, _ = k2.sampler_windows(
            k_arr, k_min, ones, ones,
            k2.Bounds(0, 2, 0, 0, 0, 0, 0, 1), *no_min)
        cc01 = t1["cc"]                                      # (2, n)
        f0 = self._f0_hour
        cc0 = (cc01[0] * (1 - f0) + cc01[1] * f0).contiguous()
        # the frozen cloudy pair (global indices 0, 1) sees cc0
        t2, _ = k2.sampler_windows(
            k_arr, k_min, ones, cc0,
            k2.Bounds(0, 0, 2, 0, 0, 0, 0, 0), *no_min)
        kr = k1.split(k_renew, 2)
        u_cycle = k1.uniform(kr[:, 0, :].contiguous())
        u_phase = k1.uniform(kr[:, 1, :].contiguous())
        carry = renewal.init_from_u(u_cycle, u_phase, cc01[0], t1["ws"][0])
        return {
            "cc_carry": ones.clone(),
            "cc0": cc0,
            "cloudy_pair": t2["cloudy"].T.contiguous(),
            "carry": {k: v.contiguous() for k, v in carry.items()},
            "k_arr": k_arr,
            "k_min": k_min,
            "k_scan": k_scan,
            "k_meter": k_meter,
        }

    def init_reduce_acc(self):
        """Zero accumulator: one ``(n_chains,)`` tensor per statistic."""
        n = self.config.n_chains
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
    # host-side per-block inputs (chain-independent, float64 precompute)
    # ------------------------------------------------------------------

    def host_inputs(self, block_i: int) -> BlockInputs:
        """The block's calendar rows, shared-site geometry rows, minute
        features and sampler-window bounds (indices rebased to the
        windows)."""
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
        geom = solar.block_geometry(blk.epoch.astype(np.float64),
                                    blk.doy.astype(np.float64), cfg.site)
        rows_i, rows_f = k3.block_rows(block_idx, mlo, geom)
        dev = self.device
        return BlockInputs(
            bounds=k2.Bounds(hour_lo, self._w_hours, self._w_hours,
                             hour_next_lo, cd_lo, self._w_cd, day_lo,
                             self._w_days, mlo),
            mh_idx=torch.from_numpy(
                np.asarray(h_idx - hour_lo, np.int32)).to(dev),
            mh_frac=torch.from_numpy(np.asarray(h_frac, np.float32)).to(dev),
            rows_i=torch.from_numpy(rows_i).to(dev),
            rows_f=torch.from_numpy(rows_f).to(dev),
        )

    # ------------------------------------------------------------------
    # the block step
    # ------------------------------------------------------------------

    def step_acc(self, state, inputs: BlockInputs, acc):
        """One block: K2 windows, then K3 folds every second into ``acc``.
        Returns ``(state, acc)`` (on the card both are updated in place)."""
        cfg = self.config
        tables, cc_carry = k2.sampler_windows(
            state["k_arr"], state["k_min"], state["cc_carry"], state["cc0"],
            inputs.bounds, inputs.mh_idx, inputs.mh_frac)
        carry, acc = k3.block_step_acc(
            tables, inputs.rows_i, inputs.rows_f, state["k_scan"],
            state["k_meter"], state["carry"], acc, cfg.duration_s,
            cfg.meter_max_w, cfg.site.surface_tilt, cfg.site.albedo)
        return dict(state, carry=carry, cc_carry=cc_carry), acc

    def run_reduced(self, state=None, on_block=None, acc=None,
                    start_block: int = 0):
        """Run every block keeping only per-chain running statistics.

        Returns a dict of ``(n_chains,)`` numpy arrays, one per
        ``REDUCE_STATS`` entry.  ``state``/``acc``/``start_block`` resume a
        run (``acc`` is required with ``start_block > 0``);
        ``on_block(block_index, state, acc)`` runs after each block."""
        if start_block > 0 and acc is None:
            raise ValueError(
                "resuming run_reduced needs the accumulator: pass acc= "
                "alongside state=/start_block=")
        state = self.init_state() if state is None else _clone(state)
        acc = self.init_reduce_acc() if acc is None else _clone(acc)
        self.state = state
        for bi in range(start_block, self.n_blocks):
            state, acc = self.step_acc(state, self.host_inputs(bi), acc)
            self.state = state
            if on_block is not None:
                on_block(bi, state, acc)
        self._last_acc = acc
        return {k: v.cpu().numpy() for k, v in acc.items()}

    def ensemble_stats(self) -> dict:
        """Fleet-wide aggregates of the last ``run_reduced``, folded on the
        host in float64 (int64 for counts).  Returns python floats/ints."""
        np_op = {"sum": np.sum, "max": np.max, "min": np.min}
        out = {}
        for name, (kind, dkind) in REDUCE_STATS.items():
            v = np.asarray(self._last_acc[name].cpu().numpy(),
                           np.int64 if dkind == "i" else np.float64)
            out[name] = (int if dkind == "i" else float)(np_op[kind](v))
        return out


def _clone(tree):
    """A private copy of a state/acc dict (the run updates it in place)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()
