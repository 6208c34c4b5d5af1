"""Carry a run's state between the JAX package and the port.

The JAX package's reduce-mode state pytree, as numpy (keys as
``jax.random.key_data``: uint32 ``(..., 2)`` threefry or ``(..., 4)`` rbg
data, int64 tensors masked to 32 bits in the port), becomes the port's
state on
a device, and back; the same for the accumulator.  A site-grid run's
state also carries the six per-chain site scalars (``state["site"]``), a
fleet run its heterogeneous columns (``state["fleet"]``: float32 transform
leaves, int32 ``regime`` and ``cohort``).  A
JAX run stopped after N blocks continues in the port from block N and
gives the JAX result (tests/test_torch_engine.py).  Scenario serving adds
the ``(B, n)`` scenario accumulator (``acc_*`` take any leading shape),
the ``(B,)`` knob tree ``scen`` and a block's ``fleet_delta``
(tests/test_torch_serve.py).
"""

from __future__ import annotations

import numpy as np
import torch

from tmhpvsim_torch.config import SITE_FIELDS

KEY_LEAVES = ("k_arr", "k_min", "k_scan", "k_meter")
FLOAT_LEAVES = ("cc_carry", "cc0", "cloudy_pair")
CARRY_LEAVES = ("cloud_end", "total_end", "sec")
#: the fleet leaves a state may hold, with their dtypes
FLEET_LEAVES = {"demand_scale": np.float32, "demand_shift_w": np.float32,
                "pv_scale": np.float32, "ac_limit_w": np.float32,
                "regime": np.int32, "cohort": np.int32}


def state_from_numpy(tree: dict, device) -> dict:
    """JAX-layout state (numpy leaves) -> the port's state on ``device``."""
    expected = set(KEY_LEAVES) | set(FLOAT_LEAVES) | {"carry"}
    if set(tree) - {"site", "fleet"} != expected:
        raise ValueError(
            f"state leaves {sorted(tree)} are not the chain state "
            f"{sorted(expected)} (plus 'site' for a site grid, 'fleet' "
            "for a fleet)")
    out = {}
    for k in KEY_LEAVES:
        a = np.asarray(tree[k])
        if a.dtype != np.uint32 or a.shape[-1] not in (2, 4):
            raise ValueError(f"{k}: expected uint32 (..., 2) threefry or "
                             f"(..., 4) rbg key data, got {a.dtype} "
                             f"{a.shape}")
        out[k] = _tensor(a, np.int64, device)
    for k in FLOAT_LEAVES:
        out[k] = _tensor(tree[k], np.float32, device)
    out["carry"] = {k: _tensor(tree["carry"][k], np.float32, device)
                    for k in CARRY_LEAVES}
    if "site" in tree:
        if set(tree["site"]) != set(SITE_FIELDS):
            raise ValueError(f"site leaves {sorted(tree['site'])} are not "
                             f"{sorted(SITE_FIELDS)}")
        out["site"] = {k: _tensor(tree["site"][k], np.float32, device)
                       for k in SITE_FIELDS}
    if "fleet" in tree:
        extra = set(tree["fleet"]) - set(FLEET_LEAVES)
        if extra:
            raise ValueError(f"unknown fleet leaves {sorted(extra)}")
        out["fleet"] = {k: _tensor(v, FLEET_LEAVES[k], device)
                        for k, v in tree["fleet"].items()}
    return out


def _tensor(a, dtype, device) -> torch.Tensor:
    """A contiguous copy on ``device`` (the source may be read-only)."""
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def state_to_numpy(state: dict) -> dict:
    """The port's state -> JAX layout (uint32 key data, float32 leaves)."""
    out = {k: state[k].cpu().numpy().astype(np.uint32) for k in KEY_LEAVES}
    for k in FLOAT_LEAVES:
        out[k] = state[k].cpu().numpy()
    out["carry"] = {k: state["carry"][k].cpu().numpy() for k in CARRY_LEAVES}
    if "site" in state:
        out["site"] = {k: state["site"][k].cpu().numpy()
                       for k in SITE_FIELDS}
    if "fleet" in state:
        out["fleet"] = {k: v.cpu().numpy() for k, v in
                        state["fleet"].items()}
    return out


def acc_from_numpy(acc: dict, device) -> dict:
    """JAX reduce accumulator (numpy) -> the port's accumulator."""
    from tmhpvsim_torch.engine.simulation import REDUCE_STATS

    if set(acc) != set(REDUCE_STATS):
        raise ValueError(f"accumulator leaves {sorted(acc)} are not "
                         f"{sorted(REDUCE_STATS)}")
    return {k: _tensor(acc[k], np.int32 if d == "i" else np.float32, device)
            for k, (_, d) in REDUCE_STATS.items()}


def acc_to_numpy(acc: dict) -> dict:
    """The port's accumulator -> numpy (int32 / float32 leaves)."""
    return {k: v.cpu().numpy() for k, v in acc.items()}


def scen_from_numpy(scen: dict, device) -> dict:
    """The JAX package's encoded scenario batch (``serve.schema
    .encode_batch``, numpy) -> the port's knob tensors on ``device``."""
    from tmhpvsim_torch.kernels.block_step import SCEN_F, SCEN_I

    if set(scen) != set(SCEN_F + SCEN_I):
        raise ValueError(f"scenario leaves {sorted(scen)} are not "
                         f"{sorted(SCEN_F + SCEN_I)}")
    return {k: _tensor(v, np.float32 if k in SCEN_F else np.int32, device)
            for k, v in scen.items()}


def fleet_delta_to_numpy(delta: dict) -> dict:
    """A FleetAcc delta (any leading shape) -> numpy: int32 counts,
    float32 extrema."""
    return {k: v.cpu().numpy() for k, v in delta.items()}


def fleet_delta_from_numpy(delta: dict, device) -> dict:
    """The JAX package's FleetAcc delta (numpy) -> tensors on ``device``
    (integer leaves int32, float leaves float32)."""
    return {k: _tensor(v, np.float32 if np.asarray(v).dtype.kind == "f"
                       else np.int32, device) for k, v in delta.items()}
