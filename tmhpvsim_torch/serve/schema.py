"""Request/reply wire schema of scenario serving (own copy of the JAX
package's serve/schema.py).

Requests and replies ride the transports' out-of-band metadata channel
(``Message.meta``), so a message body stays a plain JSON float.

Request meta (on the server's request exchange)::

    {"op": "scenario", "id": "<1..64 chars>", "reply_to": "<exchange>",
     "mode": "reduce" | "quantiles" | "fleet",     # default "reduce"
     "scenario": {                                 # all knobs optional
        "demand_scale":     float in [0, 8],       # default 1
        "demand_shift_w":   float in [-1e7, 1e7],  # default 0
        "dc_capacity_scale":float in [0, 8],       # default 1
        "weather_bias":     float in [0.25, 4],    # default 1
        "curtail_w":        float >= 0 or null,    # default null (no cap)
        "horizon_s":        int in [1, server max] # default server max
        "site_index":       int in [0, n_sites),   # default -1 (all sites)
        "cohort":           int in [0, n_cohorts)  # default -1 (all cohorts)
     }}

``site_index`` (a chain-axis index of a multi-site run) and ``cohort`` (a
tag of a fleet with more than one cohort) bound a what-if to one site or
one cohort; they are mutually exclusive and accepted only where the
served config can answer them.

Reply meta (on ``reply_to``)::

    {"op": "scenario-reply", "id": ..., "ok": true,
     "mode": ..., "result": {...}, "t": {queue/dispatch/batch timings}}
    {"op": "scenario-reply", "id": ..., "ok": false,
     "error": {"code": "<ERROR_CODES>", "message": ...,
               "retry_after_ms": <optional int: busy/unavailable hint>}}

Validation is strict: unknown knobs, non-finite and out-of-bounds values
are typed ``invalid`` rejections, never clamped.

:func:`encode_batch` turns validated :class:`Scenario` rows into the
``(batch,)``-leaf knob tensors ``Simulation.scenario_step`` consumes
(float32 knobs, int32 ``horizon_s`` / ``site_index`` / ``cohort``); the
request's ``dc_capacity_scale`` becomes the leaf ``pv_scale``, a null
curtailment cap float32's largest value (``min(pv, cap)`` is then the
identity), and rows past the scenarios are ``horizon_s = 0`` padding,
which folds nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

OP_REQUEST = "scenario"
OP_REPLY = "scenario-reply"

MODES = ("reduce", "quantiles", "fleet")

#: typed rejection codes a reply's ``error.code`` may carry
#: (``unavailable``: the dispatch circuit breaker is open)
ERROR_CODES = ("invalid", "duplicate", "busy", "draining", "timeout",
               "internal", "unavailable")

#: request-side knob bounds: name -> (lo, hi, default)
KNOB_BOUNDS = {
    "demand_scale": (0.0, 8.0, 1.0),
    "demand_shift_w": (-1e7, 1e7, 0.0),
    "dc_capacity_scale": (0.0, 8.0, 1.0),
    "weather_bias": (0.25, 4.0, 1.0),
}

#: the float32 knob leaves of an encoded batch, and their padding fills
#: (``curtail_w``'s fill is float32's largest value: no cap)
NO_CAP = float(np.finfo(np.float32).max)
NEUTRAL = {"demand_scale": 1.0, "demand_shift_w": 0.0, "pv_scale": 1.0,
           "weather_bias": 1.0, "curtail_w": NO_CAP}
#: the int32 leaves and their padding fills
NEUTRAL_INT = {"horizon_s": 0, "site_index": -1, "cohort": -1}

_MAX_ID_LEN = 64
_MAX_EXCHANGE_LEN = 128


class RequestError(ValueError):
    """A typed request rejection: ``code`` is one of :data:`ERROR_CODES`
    and lands verbatim in the error reply; ``retry_after_ms`` is the
    server's backoff hint of a busy / unavailable rejection."""

    def __init__(self, code: str, message: str,
                 retry_after_ms: Optional[int] = None):
        assert code in ERROR_CODES, code
        super().__init__(message)
        self.code = code
        self.retry_after_ms = (None if retry_after_ms is None
                               else max(0, int(retry_after_ms)))

    @property
    def retry_after_s(self) -> Optional[float]:
        if self.retry_after_ms is None:
            return None
        return self.retry_after_ms / 1000.0


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One validated scenario; ``horizon_s=0`` marks a padding row."""

    demand_scale: float = 1.0
    demand_shift_w: float = 0.0
    dc_capacity_scale: float = 1.0
    weather_bias: float = 1.0
    curtail_w: Optional[float] = None
    horizon_s: int = 0
    #: chain-axis index to restrict the fold to (-1 = whole fleet)
    site_index: int = -1
    #: cohort tag to restrict the fold to (-1 = every cohort)
    cohort: int = -1


@dataclasses.dataclass(frozen=True)
class Request:
    """One validated scenario request (``trace_id`` / ``span_id`` are
    echoed when a client sends them; ``tenant`` is an admission tag)."""

    id: str
    reply_to: str
    mode: str
    scenario: Scenario
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    tenant: Optional[str] = None


def _check_float(name: str, v, lo: float, hi: float) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise RequestError("invalid",
                           f"scenario.{name}: expected a number, "
                           f"got {type(v).__name__}")
    v = float(v)
    if not math.isfinite(v):
        raise RequestError("invalid", f"scenario.{name}: must be finite")
    if not (lo <= v <= hi):
        raise RequestError(
            "invalid", f"scenario.{name}={v:g} outside [{lo:g}, {hi:g}]")
    return v


def parse_scenario(doc, *, max_horizon_s: int,
                   n_sites: Optional[int] = None,
                   n_cohorts: int = 0) -> Scenario:
    """Validate one request's ``scenario`` value (None or absent: every
    knob neutral, the horizon the server's maximum).  ``n_sites`` /
    ``n_cohorts`` bound the site selectors; a selector the served config
    cannot answer is a typed ``invalid`` rejection."""
    if doc is None:
        doc = {}
    if not isinstance(doc, dict):
        raise RequestError("invalid",
                           f"scenario: expected an object, "
                           f"got {type(doc).__name__}")
    known = set(KNOB_BOUNDS) | {"curtail_w", "horizon_s",
                                "site_index", "cohort"}
    unknown = sorted(set(doc) - known)
    if unknown:
        raise RequestError(
            "invalid", f"scenario: unknown knob(s) {', '.join(unknown)} "
            f"(known: {', '.join(sorted(known))})")
    kw = {}
    for name, (lo, hi, default) in KNOB_BOUNDS.items():
        kw[name] = (_check_float(name, doc[name], lo, hi)
                    if name in doc else default)
    cap = doc.get("curtail_w")
    if cap is not None:
        cap = _check_float("curtail_w", cap, 0.0, float("inf"))
    kw["curtail_w"] = cap
    h = doc.get("horizon_s", max_horizon_s)
    if isinstance(h, bool) or not isinstance(h, int):
        raise RequestError("invalid",
                           "scenario.horizon_s: expected an integer")
    if not (1 <= h <= max_horizon_s):
        raise RequestError(
            "invalid",
            f"scenario.horizon_s={h} outside [1, {max_horizon_s}]")
    kw["horizon_s"] = h

    def _selector(name, limit, what):
        v = doc.get(name, -1)
        if isinstance(v, bool) or not isinstance(v, int):
            raise RequestError("invalid",
                               f"scenario.{name}: expected an integer")
        if v == -1:
            return -1
        if limit is None or limit <= 0:
            raise RequestError(
                "invalid",
                f"scenario.{name}: the served config has no {what}")
        if not 0 <= v < limit:
            raise RequestError(
                "invalid",
                f"scenario.{name}={v} outside [0, {limit})")
        return v

    kw["site_index"] = _selector("site_index", n_sites, "site axis")
    kw["cohort"] = _selector("cohort", n_cohorts or None, "cohort tags")
    if kw["site_index"] >= 0 and kw["cohort"] >= 0:
        raise RequestError(
            "invalid",
            "scenario: site_index and cohort are mutually exclusive")
    return Scenario(**kw)


def parse_request(meta, *, max_horizon_s: int,
                  n_sites: Optional[int] = None,
                  n_cohorts: int = 0) -> Request:
    """Validate one request meta dict (the caller has checked ``op``);
    raises :class:`RequestError` ``invalid`` on any malformation."""
    if not isinstance(meta, dict):
        raise RequestError("invalid", "request meta must be an object")
    rid = meta.get("id")
    if not isinstance(rid, str) or not 1 <= len(rid) <= _MAX_ID_LEN:
        raise RequestError(
            "invalid", f"id: expected a 1..{_MAX_ID_LEN} char string")
    reply_to = meta.get("reply_to")
    if not isinstance(reply_to, str) or \
            not 1 <= len(reply_to) <= _MAX_EXCHANGE_LEN:
        raise RequestError(
            "invalid",
            f"reply_to: expected a 1..{_MAX_EXCHANGE_LEN} char "
            "exchange name")
    mode = meta.get("mode", "reduce")
    if mode not in MODES:
        raise RequestError(
            "invalid", f"mode {mode!r} not one of {', '.join(MODES)}")
    unknown = sorted(set(meta) - {"op", "id", "reply_to", "mode",
                                  "scenario", "trace_id", "span_id",
                                  "tenant", "worker"})
    if unknown:
        raise RequestError(
            "invalid", f"unknown request field(s) {', '.join(unknown)}")
    tenant = meta.get("tenant")
    if tenant is not None and (not isinstance(tenant, str)
                               or not 1 <= len(tenant) <= _MAX_ID_LEN):
        raise RequestError(
            "invalid",
            f"tenant: expected a 1..{_MAX_ID_LEN} char string")
    scenario = parse_scenario(meta.get("scenario"),
                              max_horizon_s=max_horizon_s,
                              n_sites=n_sites, n_cohorts=n_cohorts)
    tid, sid = meta.get("trace_id"), meta.get("span_id")
    return Request(
        id=rid, reply_to=reply_to, mode=mode, scenario=scenario,
        trace_id=tid if isinstance(tid, str) and tid else None,
        span_id=sid if isinstance(sid, str) and sid else None,
        tenant=tenant)


def request_meta(rid: str, reply_to: str, mode: str = "reduce",
                 scenario: Optional[dict] = None) -> dict:
    """The client-side request meta (what :func:`parse_request` reads)."""
    meta = {"op": OP_REQUEST, "id": rid, "reply_to": reply_to,
            "mode": mode}
    if scenario is not None:
        meta["scenario"] = scenario
    return meta


def ok_meta(rid: str, mode: str, result: dict,
            timings: Optional[dict] = None,
            trace_id: Optional[str] = None) -> dict:
    meta = {"op": OP_REPLY, "id": rid, "ok": True, "mode": mode,
            "result": result}
    if timings:
        meta["t"] = timings
    if trace_id:
        meta["trace_id"] = trace_id
    return meta


def error_meta(rid: Optional[str], code: str, message: str,
               trace_id: Optional[str] = None,
               retry_after_ms: Optional[int] = None) -> dict:
    assert code in ERROR_CODES, code
    err = {"code": code, "message": message}
    if retry_after_ms is not None:
        err["retry_after_ms"] = max(0, int(retry_after_ms))
    meta = {"op": OP_REPLY, "id": rid, "ok": False, "error": err}
    if trace_id:
        meta["trace_id"] = trace_id
    return meta


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest batch bucket that fits ``n`` requests."""
    fits = [b for b in buckets if b >= n]
    if not fits:
        raise ValueError(
            f"batch of {n} exceeds largest bucket {max(buckets)}")
    return min(fits)


def scenario_columns(scenarios: Sequence[Scenario], batch: int) -> dict:
    """Validated scenarios -> the knob columns as numpy (float32 knobs,
    int32 ``horizon_s`` / ``site_index`` / ``cohort``), padded to
    ``batch`` rows with :data:`NEUTRAL` / :data:`NEUTRAL_INT`."""
    if len(scenarios) > batch:
        raise ValueError(f"{len(scenarios)} scenarios > batch {batch}")
    pad = batch - len(scenarios)
    vals = {
        "demand_scale": [s.demand_scale for s in scenarios],
        "demand_shift_w": [s.demand_shift_w for s in scenarios],
        "pv_scale": [s.dc_capacity_scale for s in scenarios],
        "weather_bias": [s.weather_bias for s in scenarios],
        "curtail_w": [NO_CAP if s.curtail_w is None else s.curtail_w
                      for s in scenarios],
        "horizon_s": [s.horizon_s for s in scenarios],
        "site_index": [s.site_index for s in scenarios],
        "cohort": [s.cohort for s in scenarios],
    }
    fills = {**NEUTRAL, **NEUTRAL_INT}
    return {k: np.asarray(v + [fills[k]] * pad,
                          np.float32 if k in NEUTRAL else np.int32)
            for k, v in vals.items()}


def to_device(cols: dict, *, device) -> dict:
    """Knob columns (numpy) -> tensors on ``device`` (pinned,
    non-blocking copies on the card)."""
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if torch.device(device).type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return {k: put(v) for k, v in cols.items()}


def encode_batch(scenarios: Sequence[Scenario], batch: int, *,
                 device) -> dict:
    """Validated scenarios -> the ``(batch,)``-leaf knob tensors of
    ``Simulation.scenario_step`` on ``device`` (rows past
    ``len(scenarios)`` are horizon-0 padding)."""
    return to_device(scenario_columns(scenarios, batch), device=device)
