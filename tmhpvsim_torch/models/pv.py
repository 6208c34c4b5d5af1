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

from tmhpvsim_torch.models import bf16 as mx
from tmhpvsim_torch.models.tables import EXACT, KernelSet, get_kernels
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
    return _sapm_sandia(poa_direct, poa_diffuse, st["f1"], st["f2"], module,
                        inverter, k)


def _sapm_sandia(poa_direct, poa_diffuse, f1, f2, module, inverter, k):
    """POA irradiance -> AC watts: the SAPM cell temperature, effective
    irradiance and DC point, then the Sandia inverter (float32)."""
    poa_global = poa_direct + poa_diffuse

    # SAPM cell temperature at wind 0 m/s, 20 C ambient
    t_mod = poa_global * cell_temp_factor(module, k) + 20.0
    t_cell = t_mod + cdiv(poa_global, 1000.0) * module["T_deltaT"]

    # SAPM effective irradiance [suns]
    ee = cdiv(f1 * (poa_direct * f2 + module["FD"] * poa_diffuse), 1000.0)
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


# ---------------------------------------------------------------------------
# compute_dtype='bf16' (the plain half of K12)
# ---------------------------------------------------------------------------


def second_terms_bf16(g, module, kernels=None):
    """:func:`second_terms` of the bf16 path: the JAX physics chain on bf16
    geometry (models/bf16.py decides, op by op, what rounds to bf16).

    ``g``: the geometry fields as bf16 :class:`~models.bf16.M` values
    (``doy`` a float32 tensor; ``surface_tilt`` and ``albedo`` python
    floats for a shared site, bf16 values per chain).  Returns the terms
    :func:`power_from_terms_bf16` reads: float32 tensors where the JAX
    graph is float32, M values where it is bf16."""
    ks = _kernel_set(kernels)
    k = mx.kernel_set(ks)
    zen = g["zenith"]
    i0 = extra_radiation_spencer(g["doy"], DISC_SOLAR_CONSTANT, ks)
    # disc_dni's airmass and clear-sky terms
    i0h = mx.f32(i0) * mx.maximum(k.cos(zen), 0.065)
    z_deg = mx.clip(zen / DEG, 0.0, 93.0)
    am = 1.0 / (k.cos(z_deg * DEG) + 0.15 * k.powc(93.885 - z_deg, -1.253))
    knc = (0.866 - 0.122 * am + 0.0121 * am * am
           - 0.000653 * mx.ipow(am, 3) + 1.4e-5 * mx.ipow(am, 4))
    # haydavies_poa's beam ratio and tilt
    tilt = g["surface_tilt"]
    cos_tilt = k.cos(tilt * DEG)
    rb = mx.maximum(g["cos_aoi"], 0.0) / mx.maximum(
        k.cos(g["apparent_zenith"]), 0.01745)
    # sapm_effective_irradiance's spectral and angle-of-incidence terms
    ama = g["airmass_abs"]
    f1 = (module["A0"] + module["A1"] * ama + module["A2"] * mx.ipow(ama, 2)
          + module["A3"] * mx.ipow(ama, 3) + module["A4"] * mx.ipow(ama, 4))
    aoi = k.arccos(mx.clip(g["cos_aoi"], -1.0, 1.0)) / DEG
    f2 = mx.maximum(
        module["B0"] + module["B1"] * aoi + module["B2"] * mx.ipow(aoi, 2)
        + module["B3"] * mx.ipow(aoi, 3) + module["B4"] * mx.ipow(aoi, 4)
        + module["B5"] * mx.ipow(aoi, 5), 0.0)
    return {
        "csi_cap": g["csi_cap"], "ghi_clear": g["ghi_clear"],
        "cos_zenith": mx.widen(g["cos_zenith"]),
        "dni_extra": mx.widen(g["dni_extra"]),
        "cos_aoi": mx.widen(g["cos_aoi"]),
        "i0": i0, "i0h": i0h.v, "am": mx.widen(am), "knc": mx.widen(knc),
        "zen_ok": zen < 87.0 * DEG, "rb": mx.widen(rb),
        "f1": mx.widen(f1), "f2": mx.widen(f2), "cos_tilt": cos_tilt,
        "albedo": g["albedo"],
    }


def power_from_terms_bf16(csi, st, module, inverter, kernels=None):
    """:func:`power_from_terms` of the bf16 path: ``csi`` (float32) rounded
    to bf16, the clear-sky GHI and the ground reflection in bf16, the DISC,
    POA sky, SAPM and inverter steps in float32 (the JAX graph's types)."""
    k = _kernel_set(kernels)
    c = mx.minimum(mx.bf16(csi), st["csi_cap"])
    ghi = c * st["ghi_clear"]
    g32 = mx.widen(ghi)
    dni = disc_dni(g32, st, k)
    dhi = torch.clamp_min(g32 - dni * st["cos_zenith"], 0.0)
    cos_tilt = st["cos_tilt"]
    ai = dni / st["dni_extra"]
    sky_diffuse = dhi * (ai * st["rb"] + (1.0 - ai) * 0.5
                         * mx.widen(1.0 + cos_tilt).to(dhi.device))
    ground = ghi * st["albedo"] * 0.5 * (1.0 - cos_tilt)
    poa_direct = torch.clamp_min(dni * st["cos_aoi"], 0.0)
    poa_diffuse = torch.clamp_min(sky_diffuse, 0.0) + mx.widen(ground)
    return _sapm_sandia(poa_direct, poa_diffuse, st["f1"], st["f2"], module,
                        inverter, k)


def power_from_csi_bf16(csi, geom, module, inverter, kernels=None):
    """Clear-sky index -> AC watts on the bf16 path (``geom`` as
    :func:`second_terms_bf16` takes it); float32 out."""
    return power_from_terms_bf16(
        csi, second_terms_bf16(geom, module, kernels), module, inverter,
        kernels)


def _kernel_set(kernels) -> KernelSet:
    """A kernel set from its name or itself (None: the exact set)."""
    return get_kernels(kernels) if isinstance(kernels, str) else \
        (kernels or EXACT)


# ---------------------------------------------------------------------------
# float64 numpy chain (the golden model's physics, engine/golden.py)
# ---------------------------------------------------------------------------


def power_from_csi_np(csi, geom, module, inverter):
    """The JAX package's ``pv.power_from_csi(..., xp=numpy)`` in float64,
    operation for operation (its DISC, Hay-Davies, SAPM and Sandia
    steps), on ``solar.block_geometry``'s fields."""
    np_ = np
    csi = np_.minimum(csi, geom["csi_cap"])
    ghi = csi * geom["ghi_clear"]
    zenith, doy = geom["zenith"], geom["doy"]
    # solar.disc_dni
    b = TWO_PI * (doy - 1.0) / 365.0
    i0 = DISC_SOLAR_CONSTANT * (
        1.00011 + 0.034221 * np_.cos(b) + 0.00128 * np_.sin(b)
        + 0.000719 * np_.cos(2.0 * b) + 7.7e-5 * np_.sin(2.0 * b))
    i0h = i0 * np_.maximum(np_.cos(zenith), 0.065)
    kt = np_.clip(ghi / i0h, 0.0, 2.0)
    z_deg = np_.clip(zenith / DEG, 0.0, 93.0)
    am = 1.0 / (np_.cos(z_deg * DEG) + 0.15 * (93.885 - z_deg) ** -1.253)
    kt2 = kt * kt
    kt3 = kt2 * kt
    is_hi = kt > 0.6
    a = np_.where(is_hi, -5.743 + 21.77 * kt - 27.49 * kt2 + 11.56 * kt3,
                  0.512 - 1.56 * kt + 2.286 * kt2 - 2.222 * kt3)
    bb = np_.where(is_hi, 41.4 - 118.5 * kt + 66.05 * kt2 + 31.9 * kt3,
                   0.37 + 0.962 * kt)
    c = np_.where(is_hi, -47.01 + 184.2 * kt - 222.0 * kt2 + 73.81 * kt3,
                  -0.28 + 0.932 * kt - 2.048 * kt2)
    knc = (0.866 - 0.122 * am + 0.0121 * am * am - 0.000653 * am ** 3
           + 1.4e-5 * am ** 4)
    delta_kn = a + bb * np_.exp(np_.minimum(c * am, 40.0))
    dni = (knc - delta_kn) * i0
    valid = (zenith < 87.0 * DEG) & (ghi > 0.0)
    dni = np_.where(valid, np_.maximum(dni, 0.0), 0.0)
    dhi = np_.maximum(ghi - dni * geom["cos_zenith"], 0.0)
    # solar.haydavies_poa
    cos_tilt = np_.cos(geom["surface_tilt"] * DEG)
    cos_aoi = geom["cos_aoi"]
    rb = np_.maximum(cos_aoi, 0.0) / np_.maximum(
        np_.cos(geom["apparent_zenith"]), 0.01745)
    ai = dni / geom["dni_extra"]
    sky = dhi * (ai * rb + (1.0 - ai) * 0.5 * (1.0 + cos_tilt))
    ground = ghi * geom["albedo"] * 0.5 * (1.0 - cos_tilt)
    poa_direct = np_.maximum(dni * cos_aoi, 0.0)
    poa_diffuse = np_.maximum(sky, 0.0) + ground
    poa_global = poa_direct + poa_diffuse
    m = module
    # sapm_cell_temp, sapm_effective_irradiance, sapm_dc
    t_cell = (poa_global * np_.exp(m["T_a"] + m["T_b"] * 0.0) + 20.0
              + poa_global / 1000.0 * m["T_deltaT"])
    ama = geom["airmass_abs"]
    f1 = (m["A0"] + m["A1"] * ama + m["A2"] * ama ** 2 + m["A3"] * ama ** 3
          + m["A4"] * ama ** 4)
    aoi_deg = np_.arccos(np_.clip(cos_aoi, -1.0, 1.0)) / DEG
    f2 = (m["B0"] + m["B1"] * aoi_deg + m["B2"] * aoi_deg ** 2
          + m["B3"] * aoi_deg ** 3 + m["B4"] * aoi_deg ** 4
          + m["B5"] * aoi_deg ** 5)
    f2 = np_.maximum(f2, 0.0)
    ee = np_.maximum(f1 * (poa_direct * f2 + m["FD"] * poa_diffuse) / 1000.0,
                     0.0)
    dt = t_cell - T0_C
    ns = m["Cells_in_Series"]
    delta = m["N"] * BOLTZMANN * (t_cell + 273.15) / ELEM_CHARGE
    pos = ee > 0.0
    log_ee = np_.log(np_.where(pos, ee, 1.0))
    i_mp = (m["Impo"] * (m["C0"] * ee + m["C1"] * ee ** 2)
            * (1.0 + m["Aimp"] * dt))
    bvmp = m["Bvmpo"] + m["Mbvmp"] * (1.0 - ee)
    v_mp = (m["Vmpo"] + m["C2"] * ns * delta * log_ee
            + m["C3"] * ns * (delta * log_ee) ** 2 + bvmp * dt)
    i_mp = np_.where(pos, np_.maximum(i_mp, 0.0), 0.0)
    v_mp = np_.where(pos, np_.maximum(v_mp, 0.0), 0.0)
    p_mp = i_mp * v_mp
    # sandia_inverter_ac
    inv = inverter
    paco = inv["Paco"]
    dv = v_mp - inv["Vdco"]
    ia = inv["Pdco"] * (1.0 + inv["C1"] * dv)
    ib = inv["Pso"] * (1.0 + inv["C2"] * dv)
    ic = inv["C0"] * (1.0 + inv["C3"] * dv)
    a_b = np_.where(np_.abs(ia - ib) > 1e-12, ia - ib, 1e-12)
    pd = p_mp - ib
    ac = (paco / a_b - ic * a_b) * pd + ic * pd * pd
    ac = np_.minimum(ac, paco)
    ac = np_.where(p_mp < inv["Pso"], -np_.abs(inv["Pnt"]), ac)
    return np_.maximum(ac, 0.0)
