"""Host-side time grid precomputation.

The reference advances a wall-clock ``datetime`` one second at a time and
derives, per step, (a) minute/hour/day fractions and (b) rollover events that
advance its interpolated samplers (clearskyindexmodel.py:113-126).  Data-
dependent calendar logic like that cannot live inside ``jit``; the TPU-native
design therefore precomputes every time-derived feature on the host as flat
numpy arrays over the (regular, 1 Hz) simulation grid and feeds them to the
device as scan inputs.  Everything here is deterministic, cheap (O(duration)
integer numpy), and computed *blockwise* so 10-year grids never materialise
at once.

Semantics matched to the reference:

* fractions — ``min_fraction = second/60``, ``hour_fraction = (minute +
  min_fraction)/60``, ``day_fraction = (hour + hour_fraction)/24`` of the
  *local* wall clock (clearskyindexmodel.py:113-118); computed here as
  modular arithmetic on local epoch seconds (identical, incl. across DST).
* rollovers — fire when the local minute/hour/day *field* differs from the
  previous second (clearskyindexmodel.py:120-126).  Note the asymmetry this
  implies around DST: on the backward transition the hour field repeats, so
  no hour rollover fires for two consecutive wall hours; on the forward
  transition a single rollover fires.  We reproduce both exactly by carrying
  the timezone's transition instants.
* the t=0 step never fires a rollover (the model is constructed at the grid
  start; ``prev_time is None`` branch at clearskyindexmodel.py:117-120).

Timezone handling uses stdlib ``zoneinfo`` (the reference uses pytz,
pvmodel.py:19); offsets are resolved once into a piecewise-constant table.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from zoneinfo import ZoneInfo

import numpy as np

_UTC = _dt.timezone.utc


def _probe_offset(tz: ZoneInfo, epoch: int) -> int:
    """UTC offset in seconds at the given epoch."""
    dt = _dt.datetime.fromtimestamp(epoch, tz)
    return int(dt.utcoffset().total_seconds())


def _offset_table(tz: ZoneInfo, lo: int, hi: int):
    """Piecewise-constant UTC offsets over [lo, hi).

    Returns (breaks, offsets): ``offsets[i]`` applies for epochs in
    ``[breaks[i], breaks[i+1])``.  Transition instants are located by hourly
    probing + bisection to 1 s (DST rules are hour-aligned in practice, but we
    do not rely on it).
    """
    lo, hi = int(lo) - 2 * 86400, int(hi) + 2 * 86400
    probes = np.arange(lo, hi + 3600, 3600, dtype=np.int64)
    offs = np.asarray([_probe_offset(tz, int(p)) for p in probes], dtype=np.int64)
    breaks = [lo]
    offsets = [int(offs[0])]
    for i in np.nonzero(np.diff(offs))[0]:
        a, b = int(probes[i]), int(probes[i + 1])
        while b - a > 1:  # bisect the exact transition second
            m = (a + b) // 2
            if _probe_offset(tz, m) == offs[i]:
                a = m
            else:
                b = m
        breaks.append(b)
        offsets.append(int(offs[i + 1]))
    return np.asarray(breaks, dtype=np.int64), np.asarray(offsets, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class TimeBlock:
    """Per-second time features for one contiguous block of the grid.

    All arrays have length ``len(epoch)``; ``*_idx`` are *global* sampler
    pair indices (0 at simulation start), so sampler value arrays generated
    once per run can be gathered per block.
    """

    offset: int                 # block start, seconds since simulation start
    epoch: np.ndarray           # int64, UTC epoch seconds
    local_sec: np.ndarray       # int64, epoch + utcoffset
    min_fraction: np.ndarray    # float64 in [0, 1)
    hour_fraction: np.ndarray   # float64 in [0, 1)
    day_fraction: np.ndarray    # float64 in [0, 1)
    new_min: np.ndarray         # bool: minute field changed vs previous second
    new_hour: np.ndarray        # bool
    new_day: np.ndarray         # bool
    min_idx: np.ndarray         # int64 global minute-interval index
    hour_idx: np.ndarray        # int64
    day_idx: np.ndarray         # int64
    month0: np.ndarray          # int64, local month, 0-based (turbidity gather)
    doy: np.ndarray             # int64, local day of year (1-based)


@dataclasses.dataclass(frozen=True)
class TimeGridSpec:
    """A 1 Hz local-calendar time grid of ``duration_s`` seconds.

    Construct with :meth:`from_local_start`; materialise features blockwise
    with :meth:`block`.
    """

    start_epoch: int
    duration_s: int
    tz_name: str
    tz_breaks: np.ndarray       # piecewise offset table
    tz_offsets: np.ndarray
    backward_transitions: np.ndarray  # epochs where the offset decreases
    midnight_epochs: np.ndarray  # epoch of each local midnight covering grid
    day_month0: np.ndarray       # per local day (aligned to midnight_epochs)
    day_doy: np.ndarray
    min_phase: int               # local_sec(start) % 60
    hour_phase: int              # local_sec(start) % 3600

    @classmethod
    def from_local_start(cls, start, duration_s: int, tz_name: str = "Europe/Berlin"):
        if isinstance(start, str):
            start = _dt.datetime.fromisoformat(start)
        tz = ZoneInfo(tz_name)
        if start.tzinfo is None:
            start = start.replace(tzinfo=tz)
        start_epoch = int(start.timestamp())
        end_epoch = start_epoch + int(duration_s)

        breaks, offsets = _offset_table(tz, start_epoch, end_epoch)
        backward = breaks[1:][np.diff(offsets) < 0]

        # Local midnights covering [start, end]: walk local dates.
        first_local = _dt.datetime.fromtimestamp(start_epoch, tz).date()
        last_local = _dt.datetime.fromtimestamp(end_epoch, tz).date()
        n_days = (last_local - first_local).days + 2
        midnights, months, doys = [], [], []
        for d in range(n_days):
            date = first_local + _dt.timedelta(days=d)
            mid = _dt.datetime(date.year, date.month, date.day, tzinfo=tz)
            midnights.append(int(mid.timestamp()))
            months.append(date.month - 1)
            doys.append(date.timetuple().tm_yday)

        local0 = start_epoch + offsets[np.searchsorted(breaks, start_epoch, "right") - 1]
        return cls(
            start_epoch=start_epoch,
            duration_s=int(duration_s),
            tz_name=tz_name,
            tz_breaks=breaks,
            tz_offsets=offsets,
            backward_transitions=backward,
            midnight_epochs=np.asarray(midnights, dtype=np.int64),
            day_month0=np.asarray(months, dtype=np.int64),
            day_doy=np.asarray(doys, dtype=np.int64),
            min_phase=int(local0 % 60),
            hour_phase=int(local0 % 3600),
        )

    # ---- sampler array sizes -------------------------------------------
    def _count(self, phase: int, period: int) -> int:
        """Number of epoch-phase boundaries in (start, start+duration]."""
        return int((self.duration_s - 1 + phase) // period)

    @property
    def n_minute_intervals(self) -> int:
        """Distinct minute pair-indices touched by the grid (max min_idx + 1)."""
        return self._count(self.min_phase, 60) + 1

    @property
    def n_hour_intervals(self) -> int:
        return self._count(self.hour_phase, 3600) + 1

    @property
    def n_day_intervals(self) -> int:
        last = self.start_epoch + self.duration_s - 1
        base = np.searchsorted(self.midnight_epochs, self.start_epoch, "right")
        return int(np.searchsorted(self.midnight_epochs, last, "right") - base) + 1

    # ---- hour features at arbitrary epochs -----------------------------
    def _hour_features(self, epoch: np.ndarray):
        """(hour_idx, hour_fraction) at given epochs — shared by block() and
        minute_value_features()."""
        off = self.tz_offsets[np.searchsorted(self.tz_breaks, epoch, "right") - 1]
        local = epoch + off
        rel = epoch - self.start_epoch
        n_back = np.searchsorted(self.backward_transitions, epoch, "right") \
            - np.searchsorted(self.backward_transitions, self.start_epoch, "right")
        hour_idx = (rel + self.hour_phase) // 3600 - n_back
        return local, hour_idx, (local % 3600) / 3600.0

    def minute_value_features(self, lo: int, hi: int):
        """Hour-interpolation features at the *draw instants* of minute-sampler
        values with indices in [lo, hi).

        Value i of a minute-rate InterpolatedSampler is drawn at the (i-1)-th
        minute rollover for i >= 2; values 0 and 1 are primed at the grid
        start (clearskyindexmodel.py:29-32,90-95).  The minute-noise draw
        reads the hourly cloud cover interpolated at its draw instant
        (clearskyindexmodel.py:86-88), so each value needs (hour pair index,
        hour fraction) at that instant.

        Returns (hour_idx[int64], hour_fraction[float64]) of length hi-lo.
        """
        i = np.arange(lo, hi, dtype=np.int64)
        j = np.maximum(i - 1, 1)
        rel = np.where(i >= 2, 60 * j - self.min_phase, 0)
        epoch = self.start_epoch + rel
        _, hour_idx, hour_frac = self._hour_features(epoch)
        return hour_idx, hour_frac

    # ---- blockwise feature materialisation -----------------------------
    def block(self, offset: int, length: int) -> TimeBlock:
        length = min(length, self.duration_s - offset)
        epoch = self.start_epoch + offset + np.arange(length, dtype=np.int64)
        local, hour_idx, hour_fraction = self._hour_features(epoch)

        min_fraction = (local % 60) / 60.0
        day_fraction = (local % 86400) / 86400.0

        rel = epoch - self.start_epoch
        t_pos = rel > 0  # no rollover fires at simulation start

        min_idx = (rel + self.min_phase) // 60
        new_min = ((rel + self.min_phase) % 60 == 0) & t_pos

        hour_boundary = (rel + self.hour_phase) % 3600 == 0
        is_backward = np.isin(epoch, self.backward_transitions)
        new_hour = hour_boundary & ~is_backward & t_pos

        base = np.searchsorted(self.midnight_epochs, self.start_epoch, "right")
        day_pos = np.searchsorted(self.midnight_epochs, epoch, "right")
        day_idx = day_pos - base
        new_day = np.isin(epoch, self.midnight_epochs) & t_pos

        day_number = day_pos - 1  # index into per-day calendar arrays
        return TimeBlock(
            offset=offset,
            epoch=epoch,
            local_sec=local,
            min_fraction=min_fraction,
            hour_fraction=hour_fraction,
            day_fraction=day_fraction,
            new_min=new_min,
            new_hour=new_hour,
            new_day=new_day,
            min_idx=min_idx,
            hour_idx=hour_idx,
            day_idx=day_idx,
            month0=self.day_month0[day_number],
            doy=self.day_doy[day_number],
        )
