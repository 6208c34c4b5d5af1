"""PV electrical chain on torch tensors: csi -> GHI -> DISC DNI -> Hay-Davies
POA -> SAPM cell temperature, effective irradiance and DC -> Sandia AC
(own copy of tmhpvsim_tpu/models/pv.py and of the device half of
tmhpvsim_tpu/models/solar.py's irradiance functions).

Operation order and constants follow the JAX package as float32 jax runs
it: python-float sub-expressions fold to one float32 constant, integer
powers expand by repeated squaring, and every division is a single
rounding.  Geometry fields are float32 tensors that broadcast against
``csi`` (one block row per second); ``surface_tilt`` and ``albedo`` are
python floats, or per-chain float32 tensors on the site-grid path.  The
CUDA kernel K3 (csrc/block_step.cu) evaluates the same
expressions, with the per-second ones (``second_terms``) hoisted.
``kernels=`` selects the transcendental set (models/tables.py); the
default is the exact torch ops.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tmhpvsim_torch.models.tables import EXACT
from tmhpvsim_torch.rng import cdiv, rdiv

DEG = np.pi / 180.0
TWO_PI = 2.0 * np.pi
BOLTZMANN = 1.380649e-23  # J/K
ELEM_CHARGE = 1.602176634e-19  # C
T0_C = 25.0  # SAPM reference cell temperature
DISC_SOLAR_CONSTANT = 1370.0  # W/m^2 (Maxwell 1987 fit constant)


def _ipow(x, k: int):
    """``x**k`` as jax's integer_pow multiplies it (binary exponentiation)."""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k:
            x = x * x
    return acc


def extra_radiation_spencer(doy, solar_constant, kernels=None):
    """Spencer 1971 extraterrestrial normal irradiance for day-of-year;
    with the table set one gather from the day-of-year LUT."""
    k = kernels or EXACT
    if k.spencer_factor is not None:
        return solar_constant * k.spencer_factor(doy)
    b = cdiv(TWO_PI * (doy - 1.0), 365.0)
    factor = (
        1.00011
        + 0.034221 * k.cos(b)
        + 0.00128 * k.sin(b)
        + 0.000719 * k.cos(2.0 * b)
        + 7.7e-5 * k.sin(2.0 * b)
    )
    return solar_constant * factor


def relative_airmass_kasten1966(zenith, kernels=None):
    """Kasten 1966 relative airmass (the DISC model's fit airmass)."""
    k = kernels or EXACT
    z_deg = torch.clamp(cdiv(zenith, DEG), 0.0, 93.0)
    return rdiv(1.0, k.cos(z_deg * DEG)
                + 0.15 * k.powc(93.885 - z_deg, -1.253))


def cell_temp_factor(module, kernels=None) -> float:
    """``exp(T_a + T_b * wind)`` of the SAPM cell temperature at wind 0
    m/s, as a float32 value (the table set's exp of the constant)."""
    k = kernels or EXACT
    arg = module["T_a"] + module["T_b"] * 0.0
    if k is EXACT:
        return math.exp(arg)
    return float(k.exp(torch.tensor(arg, dtype=torch.float32)))


def second_terms(g, module, kernels=None):
    """The csi-independent terms of one or many seconds, from the shared
    geometry rows: what every chain reuses within a second."""
    k = kernels or EXACT
    cos_zen = k.cos(g["zenith"])
    i0 = extra_radiation_spencer(g["doy"], DISC_SOLAR_CONSTANT, k)
    am = relative_airmass_kasten1966(g["zenith"], k)
    knc = (0.866 - 0.122 * am + 0.0121 * am * am
           - 0.000653 * _ipow(am, 3) + 1.4e-5 * _ipow(am, 4))
    ama = g["airmass_abs"]
    f1 = (module["A0"] + module["A1"] * ama + module["A2"] * _ipow(ama, 2)
          + module["A3"] * _ipow(ama, 3) + module["A4"] * _ipow(ama, 4))
    aoi_deg = cdiv(k.arccos(torch.clamp(g["cos_aoi"], -1.0, 1.0)), DEG)
    f2 = (module["B0"] + module["B1"] * aoi_deg
          + module["B2"] * _ipow(aoi_deg, 2)
          + module["B3"] * _ipow(aoi_deg, 3)
          + module["B4"] * _ipow(aoi_deg, 4)
          + module["B5"] * _ipow(aoi_deg, 5))
    tilt = g["surface_tilt"]
    if isinstance(tilt, torch.Tensor):  # per-chain sites (float32 tilt)
        cos_tilt = k.cos(tilt * DEG)
    else:
        cos_tilt = k.cos(torch.tensor(tilt * DEG, dtype=torch.float32))
    return {
        "csi_cap": g["csi_cap"],
        "ghi_clear": g["ghi_clear"],
        "cos_zenith": g["cos_zenith"],
        "dni_extra": g["dni_extra"],
        "cos_aoi": g["cos_aoi"],
        "i0": i0,
        "i0h": i0 * torch.clamp_min(cos_zen, 0.065),
        "am": am,
        "knc": knc,
        "zen_ok": g["zenith"] < 87.0 * DEG,
        "rb": (torch.clamp_min(g["cos_aoi"], 0.0)
               / torch.clamp_min(k.cos(g["apparent_zenith"]), 0.01745)),
        "f1": f1,
        "f2": torch.clamp_min(f2, 0.0),
        "cos_tilt": cos_tilt.to(g["zenith"].device),
        "albedo": g["albedo"],
    }


def disc_dni(ghi, st, kernels=None):
    """Maxwell 1987 DISC direct normal irradiance from GHI [W/m^2]."""
    k = kernels or EXACT
    kt = torch.clamp(ghi / st["i0h"], 0.0, 2.0)
    kt2 = kt * kt
    kt3 = kt2 * kt
    is_hi = kt > 0.6
    a = torch.where(
        is_hi,
        -5.743 + 21.77 * kt - 27.49 * kt2 + 11.56 * kt3,
        0.512 - 1.56 * kt + 2.286 * kt2 - 2.222 * kt3,
    )
    b = torch.where(is_hi, 41.4 - 118.5 * kt + 66.05 * kt2 + 31.9 * kt3,
                    0.37 + 0.962 * kt)
    c = torch.where(is_hi, -47.01 + 184.2 * kt - 222.0 * kt2 + 73.81 * kt3,
                    -0.28 + 0.932 * kt - 2.048 * kt2)
    delta_kn = a + b * k.exp(torch.clamp_max(c * st["am"], 40.0))
    dni = (st["knc"] - delta_kn) * st["i0"]
    valid = st["zen_ok"] & (ghi > 0.0)
    return torch.where(valid, torch.clamp_min(dni, 0.0),
                       torch.zeros_like(dni))


def power_from_terms(csi, st, module, inverter, kernels=None):
    """Clear-sky index -> AC watts given a second's hoisted terms."""
    k = kernels or EXACT
    csi = torch.minimum(csi, st["csi_cap"])
    ghi = csi * st["ghi_clear"]
    dni = disc_dni(ghi, st, k)
    dhi = torch.clamp_min(ghi - dni * st["cos_zenith"], 0.0)

    # Hay & Davies 1980 POA + isotropic ground reflection
    cos_tilt = st["cos_tilt"]
    ai = dni / st["dni_extra"]
    sky_diffuse = dhi * (ai * st["rb"] + (1.0 - ai) * 0.5 * (1.0 + cos_tilt))
    ground = ghi * st["albedo"] * 0.5 * (1.0 - cos_tilt)
    poa_direct = torch.clamp_min(dni * st["cos_aoi"], 0.0)
    poa_diffuse = torch.clamp_min(sky_diffuse, 0.0) + ground
    poa_global = poa_direct + poa_diffuse

    # SAPM cell temperature at wind 0 m/s, 20 C ambient
    t_mod = poa_global * cell_temp_factor(module, k) + 20.0
    t_cell = t_mod + cdiv(poa_global, 1000.0) * module["T_deltaT"]

    # SAPM effective irradiance [suns]
    ee = cdiv(st["f1"] * (poa_direct * st["f2"] + module["FD"] * poa_diffuse),
              1000.0)
    ee = torch.clamp_min(ee, 0.0)

    # SAPM DC max-power point
    dt = t_cell - T0_C
    ns = module["Cells_in_Series"]
    delta = cdiv(module["N"] * BOLTZMANN * (t_cell + 273.15), ELEM_CHARGE)
    pos = ee > 0.0
    log_ee = k.log(torch.where(pos, ee, torch.ones_like(ee)))
    i_mp = (module["Impo"] * (module["C0"] * ee + module["C1"] * _ipow(ee, 2))
            * (1.0 + module["Aimp"] * dt))
    bvmp = module["Bvmpo"] + module["Mbvmp"] * (1.0 - ee)
    v_mp = (module["Vmpo"]
            + module["C2"] * ns * delta * log_ee
            + module["C3"] * ns * _ipow(delta * log_ee, 2)
            + bvmp * dt)
    zero = torch.zeros_like(i_mp)
    i_mp = torch.where(pos, torch.clamp_min(i_mp, 0.0), zero)
    v_mp = torch.where(pos, torch.clamp_min(v_mp, 0.0), zero)
    p_mp = i_mp * v_mp

    # Sandia grid inverter
    inv = inverter
    paco = inv["Paco"]
    dv = v_mp - inv["Vdco"]
    a = inv["Pdco"] * (1.0 + inv["C1"] * dv)
    b = inv["Pso"] * (1.0 + inv["C2"] * dv)
    c = inv["C0"] * (1.0 + inv["C3"] * dv)
    a_b = torch.where(torch.abs(a - b) > 1e-12, a - b,
                      torch.full_like(a, 1e-12))
    pd = p_mp - b
    ac = (rdiv(paco, a_b) - c * a_b) * pd + c * pd * pd
    ac = torch.clamp_max(ac, paco)
    ac = torch.where(p_mp < inv["Pso"], torch.full_like(ac, -abs(inv["Pnt"])),
                     ac)
    return torch.clamp_min(ac, 0.0)


def power_from_csi(csi, geom, module, inverter, kernels=None):
    """Clear-sky index -> AC watts given a block's shared geometry."""
    return power_from_terms(csi, second_terms(geom, module, kernels), module,
                            inverter, kernels)
