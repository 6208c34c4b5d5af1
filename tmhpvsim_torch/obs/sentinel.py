"""Drift sentinel: streamed device telemetry vs golden CPU reference (own
copy of tmhpvsim_tpu/obs/sentinel.py; numpy only).

Consumes the per-block summaries produced by ``obs/telemetry.py`` and
answers two questions the host otherwise cannot, until a wrong CSV
surfaces hours later:

* **Is the graph numerically healthy?**  Any nonzero NaN/Inf counter in
  a block summary trips the sentinel immediately (WARN, or
  :class:`DriftError` under ``strict``), localised to field and block.
* **Is the ensemble drifting?**  Per-block ensemble means of csi / pv /
  meter / residual are compared against reference bands derived from
  the float64 golden models (``engine/golden.py``).  The golden stream
  is a *realization*, not an expectation, so the band half-width is
  estimated from the spread of several independent golden realizations
  (plus an analytic band for the uniform meter) rather than a
  per-second std — robust at small block sizes where realization-to-
  realization variance dominates.

Reference moments are computed lazily on first use (a few golden
block-seconds on the host, once per run) and only for the first
``ref_blocks`` blocks — later blocks get NaN/Inf checks only, which is
the cheap steady-state contract.  Reference failures (exotic configs
the golden path cannot mirror) degrade to NaN/Inf-only checking with a
WARN; they never kill the run they observe.
"""

from __future__ import annotations

import datetime as _dt
import logging
import math
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

#: golden realizations per reference block (band = spread of their means)
REF_REALIZATIONS = 4

#: floors for the band half-width, per field (units of the field) — a
#: zero spread (e.g. pv overnight: all realizations exactly 0) must not
#: produce a zero-width band
_BAND_FLOORS = {"csi": 0.02, "pv": 1.0}


class DriftError(RuntimeError):
    """Raised under ``strict`` on NaN/Inf appearance or band escape."""


def _golden_reference(config, n_blocks: int,
                      realizations: int = REF_REALIZATIONS) -> list:
    """Per-block reference bands from ``realizations`` golden streams.

    Returns a list (one entry per block) of ``{field: (mean, band)}``
    where ``band`` is the 1-sigma-equivalent tolerance denominator.
    Fields: csi always; pv/residual only for single-site configs (the
    golden physics chain models one site); meter is analytic and
    handled at observe time (its band depends on the observed count).
    """
    from tmhpvsim_torch.engine.golden import GoldenClearskyIndex
    from tmhpvsim_torch.models import pv as pvmod
    from tmhpvsim_torch.models import solar
    from tmhpvsim_torch.data import SANDIA_INVERTER, SAPM_MODULE

    start = _dt.datetime.fromisoformat(config.start)
    total_s = min(n_blocks * config.block_s, config.duration_s)
    n_blocks = -(-total_s // config.block_s)
    fp = getattr(config, "fleet", None)
    # heterogeneous per-site power transforms move the ensemble pv mean
    # away from the one-site golden chain, so those bands are dropped the
    # same way multi-site geometry drops them
    single_site = config.site_grid is None and (
        fp is None or not fp.het_power)
    # chains on non-default weather regimes draw from step tables the
    # golden chain does not model — the csi ensemble mean is a regime
    # mixture, so its band is dropped too (NaN/Inf checks remain)
    with_csi = fp is None or not fp.het_regime

    times = [start + _dt.timedelta(seconds=i) for i in range(total_s)]
    if single_site:
        from zoneinfo import ZoneInfo

        tz = ZoneInfo(config.site.timezone)
        epoch = np.asarray(
            [int(t.replace(tzinfo=tz).timestamp()) for t in times],
            dtype=np.float64)
        doy = np.asarray([t.timetuple().tm_yday for t in times],
                         dtype=np.float64)
        geom = solar.block_geometry(epoch, doy, config.site)

    # per-realization, per-block means: [realization][block][field]
    csi_means = np.empty((realizations, n_blocks))
    pv_means = np.empty((realizations, n_blocks)) if single_site else None
    for k in range(realizations):
        rng = np.random.default_rng((config.seed, 7700 + k))
        model = GoldenClearskyIndex(start, config.options, rng)
        csi = np.empty(total_s)
        for i, t in enumerate(times):
            csi[i] = model.next(t)
        if single_site:
            ac = pvmod.power_from_csi_np(csi, geom, SAPM_MODULE,
                                         SANDIA_INVERTER)
        for b in range(n_blocks):
            sl = slice(b * config.block_s,
                       min((b + 1) * config.block_s, total_s))
            csi_means[k, b] = csi[sl].mean()
            if single_site:
                pv_means[k, b] = ac[sl].mean()

    def band(means_col, floor):
        spread = float(means_col.std(ddof=1)) if realizations > 1 else 0.0
        # inflate for the sampled-mean's own uncertainty about the true
        # expectation (K realizations estimate it with SE spread/sqrt(K))
        return max(spread * math.sqrt(1.0 + 1.0 / realizations), floor)

    refs = []
    for b in range(n_blocks):
        entry = {}
        if with_csi:
            entry["csi"] = (float(csi_means[:, b].mean()),
                            band(csi_means[:, b], _BAND_FLOORS["csi"]))
        if single_site:
            entry["pv"] = (float(pv_means[:, b].mean()),
                           band(pv_means[:, b], _BAND_FLOORS["pv"]))
        refs.append(entry)
    return refs


class DriftSentinel:
    """Streaming per-block health verdicts against golden references.

    Parameters
    ----------
    config : SimConfig
        The run's config (start / block_s / seed / site drive the
        golden reference).
    level : str
        Telemetry level ('light' | 'full') — recorded in the report.
    strict : bool
        Raise :class:`DriftError` instead of WARN-and-continue.
    tol_std : float
        Band-escape threshold in band units (the band is a 1-sigma
        equivalent; 4.0 keeps the false-positive rate negligible while
        catching the order-of-magnitude drifts that matter).
    ref_blocks : int
        Number of leading blocks with full moment bands; later blocks
        get NaN/Inf checks only.
    """

    def __init__(self, config, *, level: str = "light",
                 strict: bool = False, tol_std: float = 4.0,
                 ref_blocks: int = 2):
        self.config = config
        self.level = level
        self.strict = bool(strict)
        self.tol_std = float(tol_std)
        self.ref_blocks = int(ref_blocks)
        self.blocks_checked = 0
        self.worst_z: dict = {}
        self.nan_event: Optional[dict] = None
        self.drift_events: list = []
        self._verdict = "ok"
        self._ref = None
        self._ref_failed = False

    # -- reference -------------------------------------------------------

    def _reference(self) -> list:
        if self._ref is None and not self._ref_failed:
            try:
                self._ref = _golden_reference(self.config, self.ref_blocks)
            except Exception as e:
                self._ref_failed = True
                self._ref = []
                logger.warning(
                    "drift sentinel: golden reference unavailable (%s); "
                    "falling back to NaN/Inf checks only", e)
        return self._ref

    # -- per-block observation -------------------------------------------

    def observe_block(self, block_idx: int, summary: dict) -> str:
        """Check one block summary; returns the verdict so far."""
        self.blocks_checked += 1

        # 1. finiteness: any nonzero counter is an immediate event
        for f, s in summary["fields"].items():
            bad = s["nan"] + s["inf"]
            if bad and self.nan_event is None:
                self.nan_event = {
                    "field": f, "block": int(block_idx),
                    "nan": s["nan"], "inf": s["inf"],
                }
                self._verdict = "nan"
                msg = (f"drift sentinel: non-finite values in field "
                       f"{f!r} at block {block_idx} "
                       f"(nan={s['nan']}, inf={s['inf']})")
                if self.strict:
                    raise DriftError(msg)
                logger.warning(msg)

        # 2. moment bands for the leading reference blocks
        ref = self._reference()
        if block_idx < len(ref):
            self._check_bands(block_idx, summary, ref[block_idx])
        return self._verdict

    def _check_bands(self, block_idx: int, summary: dict,
                     ref_entry: dict) -> None:
        count = summary["count"]
        bands = dict(ref_entry)
        # meter: analytic uniform[0, meter_max_w) moments; the ensemble
        # mean over `count` samples has SE = std / sqrt(count)
        mmax = float(self.config.meter_max_w)
        if count > 0:
            fp = getattr(self.config, "fleet", None)
            if fp is not None and fp.het_demand:
                # per-site affine demand: meter_i ~ scale_i*U(0,mmax)
                # + shift_i, so the ensemble mean recenters on the
                # fleet-average transform and the SE widens by the RMS
                # of the scales (cohort-aware widening — every site's
                # variance contributes, not the nominal one)
                sc = np.asarray(fp.demand_scale, dtype=np.float64)
                sh = np.asarray(fp.demand_shift_w, dtype=np.float64)
                center = float(sc.mean()) * mmax / 2.0 + float(sh.mean())
                m_se = (mmax * math.sqrt(float((sc * sc).mean()) / 12.0)
                        / math.sqrt(count))
            else:
                center = mmax / 2.0
                m_se = (mmax / math.sqrt(12.0)) / math.sqrt(count)
            bands["meter"] = (center, max(m_se, 1e-9 * max(mmax, 1.0)))
            if "pv" in ref_entry:
                pv_mean, pv_band = ref_entry["pv"]
                bands["residual"] = (
                    center - pv_mean,
                    math.sqrt(pv_band ** 2 + m_se ** 2),
                )
        for f, (ref_mean, band) in bands.items():
            s = summary["fields"].get(f)
            if s is None or not s["observed"] or s["nan"] or s["inf"]:
                continue  # unobserved or already flagged non-finite
            z = abs(s["mean"] - ref_mean) / band
            if z > self.worst_z.get(f, 0.0):
                self.worst_z[f] = z
            if z > self.tol_std:
                event = {"field": f, "block": int(block_idx),
                         "z": z, "mean": s["mean"], "ref_mean": ref_mean,
                         "band": band}
                self.drift_events.append(event)
                if self._verdict == "ok":
                    self._verdict = "drift"
                msg = (f"drift sentinel: field {f!r} escaped its band at "
                       f"block {block_idx}: mean={s['mean']:.6g} vs "
                       f"ref={ref_mean:.6g} (z={z:.2f} > "
                       f"tol={self.tol_std})")
                if self.strict:
                    raise DriftError(msg)
                logger.warning(msg)

    # -- report ----------------------------------------------------------

    @property
    def verdict(self) -> str:
        return self._verdict

    def report(self) -> dict:
        """JSON-able section for RunReport.telemetry."""
        return {
            "level": self.level,
            "strict": self.strict,
            "verdict": self._verdict,
            "blocks_checked": self.blocks_checked,
            "tolerance_std": self.tol_std,
            "worst_z": {f: round(z, 4) for f, z in self.worst_z.items()},
            "nan": self.nan_event,
            "drift": self.drift_events or None,
        }
