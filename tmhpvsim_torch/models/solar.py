"""Solar geometry (own copy of tmhpvsim_tpu/models/solar.py).

Two forms of the same models:

* float64 numpy on the host.  The shared-site path evaluates the whole
  chain-independent geometry of a block once, in float64, and ships the
  fields to the card as float32 rows (engine/simulation.py
  ``host_inputs``).  These are the functions ``block_geometry(xp=np)``
  reaches in the JAX package; the same inputs give the same bits
  (tests/test_torch_models.py).
* float32 torch on the device (``sun_position_split``, ``device_geometry``
  and the ``*_f32`` helpers).  Site grids evaluate the geometry per chain
  and second from the float32-safe split time; these are the plain
  versions of the site-geometry mode of the block-step kernel
  (csrc/block_step.cu) and follow the JAX package's float32 operation
  order (python constants rounded to float32, every division rounded
  once).  ``kernels=`` selects the transcendental set
  (models/tables.py, ``SimConfig.kernel_impl``); the default is the exact
  torch ops.

Strided geometry (``SimConfig.geom_stride``): ``strided_block_geometry``
evaluates the host geometry on a stride grid and lerps it back to 1 Hz in
float64 (the shared-site lever); ``interp_sampled`` is that lerp, on
numpy for the host and on float32 torch for the site grid, whose sample
grid the device evaluates (``device_geometry`` on the sample rows; kernel
K6s, csrc/block_step.cuh STRIDED mode).

PSA sun position (Blanco-Muriel et al. 2001, 2020 coefficients), NREL SPA
refraction, Kasten-Young airmass, Spencer extraterrestrial irradiance,
Ineichen clear sky with a monthly Linke-turbidity lerp, and the cosine of
the angle of incidence.  All angles in radians unless suffixed ``_deg``.
"""

from __future__ import annotations

import numpy as np
import torch

from tmhpvsim_torch.models.tables import EXACT
from tmhpvsim_torch.rng import cdiv, fma, rdiv

TWO_PI = 2.0 * np.pi
DEG = np.pi / 180.0

#: Epoch seconds of the PSA reference instant 2000-01-01 12:00 UT.
_PSA_EPOCH0 = 946728000.0

#: Mean Earth radius / astronomical unit (PSA parallax correction).
_PARALLAX = 6371.01 / 149597.89 * 1e-3  # dimensionless, ~4.26e-5

SOLAR_CONSTANT = 1366.1     # W/m^2 (clear-sky & transposition extra radiation)
DISC_SOLAR_CONSTANT = 1370.0  # W/m^2 (Maxwell 1987 fit constant)

STD_PRESSURE = 101325.0     # Pa


def _powc(x, p):
    return x ** p


def alt2pres(altitude_m):
    """ISA pressure at altitude [Pa] (standard lapse-rate barometric formula)."""
    return STD_PRESSURE * (1.0 - 2.25577e-5 * altitude_m) ** 5.25588


def sun_position(epoch_s, latitude_deg, longitude_deg):
    """PSA+ sun position at UTC epoch seconds.

    ``epoch_s`` MUST be float64 (or int64): absolute epoch seconds (~1.7e9)
    quantize to ±64-128 s in float32 — about a degree of hour angle — so a
    float32 input is a silent correctness bug, rejected here.  The intended
    pattern is the engine's: evaluate geometry on the host in float64
    (it is chain-independent and O(block)) and ship float32 *results* to
    the device (engine/simulation.py host_inputs).

    Parameters are broadcastable arrays.  Returns a dict:
      ``zenith``      true topocentric zenith angle [rad] (no refraction;
                      apply :func:`apparent_elevation` separately)
      ``azimuth``     [rad], 0 = North, increasing eastward (pvlib
                      convention)
      ``cos_zenith``  cos of the true zenith

    Coefficients: Blanco et al. 2020 update of the PSA ephemeris.

    """
    dt_ = np.dtype(getattr(epoch_s, "dtype", np.float64))
    if dt_.kind == "f" and dt_.itemsize < 8:
        raise TypeError(
            "sun_position requires float64/int64 epoch seconds; float32 "
            "quantizes absolute epochs to >±64 s (see docstring)"
        )
    lat = latitude_deg * DEG
    lon = longitude_deg * DEG

    # Elapsed days since 2000-01-01 12:00 UT (te), and UT decimal hour.
    te = (epoch_s - _PSA_EPOCH0) / 86400.0
    hour_ut = (epoch_s / 3600.0) % 24.0

    # Ecliptic coordinates.
    omega = 2.267127827e0 - 9.300339267e-4 * te
    mean_lon = 4.895036035e0 + 1.720279602e-2 * te
    mean_anom = 6.239468336e0 + 1.720200135e-2 * te
    ecl_lon = (
        mean_lon
        + 3.338320972e-2 * np.sin(mean_anom)
        + 3.497596876e-4 * np.sin(2.0 * mean_anom)
        - 1.544353226e-4
        - 8.689729360e-6 * np.sin(omega)
    )
    obliquity = (
        4.090904909e-1 - 6.213605399e-9 * te + 4.418094944e-5 * np.cos(omega)
    )

    # Celestial coordinates.
    sin_l = np.sin(ecl_lon)
    ra = np.arctan2(np.cos(obliquity) * sin_l, np.cos(ecl_lon)) % TWO_PI
    dec = np.arcsin(np.sin(obliquity) * sin_l)

    # Local hour angle from Greenwich mean sidereal time.
    gmst_h = 6.697096103e0 + 6.570984737e-2 * te + hour_ut
    lmst = gmst_h * 15.0 * DEG + lon
    ha = lmst - ra

    cos_lat, sin_lat = np.cos(lat), np.sin(lat)
    cos_dec, sin_dec = np.cos(dec), np.sin(dec)
    cos_ha = np.cos(ha)

    cos_zen = cos_lat * cos_ha * cos_dec + sin_dec * sin_lat
    cos_zen = np.clip(cos_zen, -1.0, 1.0)
    zenith = np.arccos(cos_zen)
    azimuth = np.arctan2(
        -np.sin(ha), np.tan(dec) * cos_lat - sin_lat * cos_ha
    ) % TWO_PI

    # Parallax correction (sun observed from the surface, not the geocenter).
    zenith = zenith + _PARALLAX * np.sin(zenith)

    return {
        "zenith": zenith,
        "azimuth": azimuth,
        "cos_zenith": np.cos(zenith),
    }


def apparent_elevation(zenith, pressure=STD_PRESSURE, temperature_c=12.0):
    """Refraction-corrected elevation [rad] from true zenith.

    The NREL SPA atmospheric-refraction correction (Reda & Andreas 2004
    eq. 42), as pvlib applies with its default temperature 12 C and
    altitude-derived pressure: for elevation e [deg],

        de = (P/1010 mbar) * (283/(273+T)) * 1.02 / (60 * tan(e + 10.3/(e+5.11)))

    applied only while the top limb of the sun is above the horizon
    (e >= -0.26667 - 0.5667 deg); expressed branchlessly with ``where``.
    """
    e_deg = (np.pi / 2.0 - zenith) / DEG
    p_mbar = pressure / 100.0
    de = (
        (p_mbar / 1010.0)
        * (283.0 / (273.0 + temperature_c))
        * 1.02
        / (60.0 * np.tan((e_deg + 10.3 / (e_deg + 5.11)) * DEG))
    )
    de = np.where(e_deg >= -(0.26667 + 0.5667), de, 0.0)
    return (e_deg + de) * DEG


def relative_airmass_kasten_young(apparent_zenith):
    """Kasten & Young 1989 relative airmass from apparent zenith [rad].

    pvlib returns NaN past 90 deg; here the zenith is clamped just below the
    pole of the formula instead — downstream use is always multiplied by a
    night mask, and NaNs are poison on TPU.
    """
    z_deg = np.clip(apparent_zenith / DEG, 0.0, 90.0)
    return 1.0 / (
        np.cos(z_deg * DEG) + 0.50572 * _powc(96.07995 - z_deg, -1.6364)
    )


def extra_radiation_spencer(doy, solar_constant=SOLAR_CONSTANT):
    """Spencer 1971 extraterrestrial normal irradiance for day-of-year.
    """
    b = TWO_PI * (doy - 1.0) / 365.0
    factor = (
        1.00011
        + 0.034221 * np.cos(b)
        + 0.00128 * np.sin(b)
        + 0.000719 * np.cos(2.0 * b)
        + 7.7e-5 * np.sin(2.0 * b)
    )
    return solar_constant * factor


def linke_turbidity(doy, monthly):
    """Day-of-year Linke turbidity from a 12-value monthly climatology.

    Monthly values are taken as mid-month anchors and linearly interpolated
    (the same scheme pvlib's ``lookup_linke_turbidity(interp_turbidity=True)``
    applies to its gridded climatology).  Wrap-around at the year boundary.
    """
    monthly = np.asarray(monthly)
    # Mid-month day-of-year anchors for a 365-day year.
    mids = np.asarray(
        [15.5, 45.0, 74.5, 105.0, 135.5, 166.0, 196.5, 227.5, 258.0, 288.5,
         319.0, 349.5]
    )
    ext_mids = np.concatenate([mids[-1:] - 365.0, mids, mids[:1] + 365.0])
    ext_vals = np.concatenate([monthly[-1:], monthly, monthly[:1]])
    d = np.asarray(doy, dtype=ext_mids.dtype)
    i = np.clip(np.searchsorted(ext_mids, d, side="right") - 1, 0, 12)
    f = (d - ext_mids[i]) / (ext_mids[i + 1] - ext_mids[i])
    return ext_vals[i] * (1.0 - f) + ext_vals[i + 1] * f


def ineichen_ghi(apparent_zenith, airmass_absolute, tl, altitude_m,
                 dni_extra):
    """Ineichen & Perez 2002 clear-sky GHI [W/m^2].

    Same formulation the reference evaluates via Location.get_clearsky
    (pvmodel.py:60): altitude-corrected coefficients and Linke-turbidity
    attenuation (no Perez enhancement factor — see NOTE below).
    """
    fh1 = np.exp(-altitude_m / 8000.0)
    fh2 = np.exp(-altitude_m / 1250.0)
    cg1 = 5.09e-5 * altitude_m + 0.868
    cg2 = 3.92e-5 * altitude_m + 0.0387
    cos_zen = np.maximum(np.cos(apparent_zenith), 0.0)
    # NOTE: the classical Perez enhancement factor exp(0.01*am^1.8) is
    # deliberately absent — pvlib disables it by default since 0.6.0, so the
    # reference's Location.get_clearsky path never applies it.
    ghi = (
        cg1
        * dni_extra
        * cos_zen
        * np.exp(-cg2 * airmass_absolute * (fh1 + fh2 * (tl - 1.0)))
    )
    return np.maximum(ghi, 0.0)


def csi_zenith_cap(zenith):
    """Physical upper bound on the clear-sky index as a function of zenith.

    The reference clips csi to ``27.21*exp(-114*cos z) + 1.665*exp(-4.494*
    cos z) + 1.08`` (pvmodel.py:52-58, an enhancement-limit fit from the
    Bright et al. model): near-overhead sun admits csi only slightly above 1,
    while low sun admits large cloud-enhancement spikes.
    """
    cos_z = np.cos(zenith)
    cap = (27.21 * np.exp(-114.0 * cos_z)
           + 1.665 * np.exp(-4.494 * cos_z) + 1.08)
    # Below the horizon the fit explodes (exp(90) ~ 1e39 at night), which
    # overflows the float32 cast on device.  The cap's only consumer is
    # ``minimum(csi, cap)`` and csi stays O(1), so any ceiling >> the
    # physical enhancement limit is equivalent — clamp to keep it finite.
    return np.minimum(cap, 1e6)


def angle_of_incidence_cos(surface_tilt_deg, surface_azimuth_deg, zenith,
                           azimuth):
    """cos(AOI) between the sun vector and the panel normal (unclipped)."""
    tilt = surface_tilt_deg * DEG
    saz = surface_azimuth_deg * DEG
    return (
        np.cos(tilt) * np.cos(zenith)
        + np.sin(tilt) * np.sin(zenith) * np.cos(azimuth - saz)
    )


def block_geometry(epoch_s, doy, site):
    """All chain-independent solar/irradiance features for a time block.

    One evaluation per block serves every chain (the csi stream is the only
    chain-dependent input to the power chain) — the key layout decision that
    keeps the per-chain work on the VPU elementwise (SURVEY.md §7 step 6-7).

    Returns dict of arrays shaped like ``epoch_s`` (plus the scalar site
    constants the power chain needs):
      zenith, cos_zenith, apparent_zenith, azimuth, csi_cap,
      ghi_clear, dni_extra, airmass_abs, cos_aoi, doy,
      surface_tilt, albedo
    """
    pos = sun_position(epoch_s, site.latitude, site.longitude)
    pressure = alt2pres(site.altitude)
    app_elev = apparent_elevation(pos["zenith"], pressure)
    app_zen = np.pi / 2.0 - app_elev

    am_rel = relative_airmass_kasten_young(app_zen)
    am_abs = am_rel * pressure / STD_PRESSURE

    dni_extra = extra_radiation_spencer(doy)
    tl = linke_turbidity(doy, site.linke_turbidity_monthly)
    ghi_clear = ineichen_ghi(app_zen, am_abs, tl, site.altitude, dni_extra)

    cos_aoi = angle_of_incidence_cos(
        site.surface_tilt, site.surface_azimuth, app_zen, pos["azimuth"]
    )
    return {
        "zenith": pos["zenith"],
        "cos_zenith": pos["cos_zenith"],
        "apparent_zenith": app_zen,
        "azimuth": pos["azimuth"],
        "csi_cap": csi_zenith_cap(pos["zenith"]),
        "ghi_clear": ghi_clear,
        "dni_extra": dni_extra,
        "airmass_abs": am_abs,
        "cos_aoi": cos_aoi,
        "doy": np.asarray(doy),
        "surface_tilt": site.surface_tilt,
        "albedo": site.albedo,
    }


# ---------------------------------------------------------------------------
# float32 device geometry (torch): the per-chain site-grid path
# ---------------------------------------------------------------------------

#: mid-month day-of-year anchors of the Linke climatology (365-day year)
LINKE_MIDS = (15.5, 45.0, 74.5, 105.0, 135.5, 166.0, 196.5, 227.5, 258.0,
              288.5, 319.0, 349.5)


def _fmod_floor(x, m: float):
    """``x % m`` as ``jnp.remainder`` computes it: the exact ``fmod``,
    moved into ``[0, m)`` (``m > 0``)."""
    r = torch.fmod(x, m)
    return torch.where(r < 0, r + m, r)


def sun_time_terms(day2000, sec_of_day, kernels=None):
    """The site-independent half of :func:`sun_position_split`: the PSA+
    ephemeris of the split time up to the sun's right ascension ``ra``,
    the cos / sin / tan of its declination (``cos_dec``, ``sin_dec``,
    ``tan_dec``) and the sidereal angle ``gmst_ang`` (``gmst_h * 15 *
    DEG``, without the site's longitude).  It reads the time only, so the
    site mode evaluates it once per second (``(T, 1)`` tensors), as the
    block-step kernel's ``sun_time`` does for every chain of a CTA."""
    k = kernels or EXACT
    frac = cdiv(sec_of_day, 86400.0) - 0.5  # days relative to 12:00 UT
    hour_ut = cdiv(sec_of_day, 3600.0)

    def lin(const, coeff):
        return (const + coeff * day2000) + coeff * frac

    omega = lin(2.267127827e0, -9.300339267e-4)
    mean_lon = lin(4.895036035e0, 1.720279602e-2)
    mean_anom = lin(6.239468336e0, 1.720200135e-2)
    ecl_lon = (
        mean_lon
        + 3.338320972e-2 * k.sin(mean_anom)
        + 3.497596876e-4 * k.sin(2.0 * mean_anom)
        - 1.544353226e-4
        - 8.689729360e-6 * k.sin(omega)
    )
    obliquity = lin(4.090904909e-1, -6.213605399e-9) \
        + 4.418094944e-5 * k.cos(omega)
    sin_l = k.sin(ecl_lon)
    ra = _fmod_floor(k.arctan2(k.cos(obliquity) * sin_l, k.cos(ecl_lon)),
                     TWO_PI)
    dec = k.arcsin(k.sin(obliquity) * sin_l)
    gmst_h = _fmod_floor(6.697096103e0 + 6.570984737e-2 * day2000, 24.0) \
        + 6.570984737e-2 * frac + hour_ut
    return {"ra": ra, "cos_dec": k.cos(dec), "sin_dec": k.sin(dec),
            "tan_dec": k.tan(dec), "gmst_ang": gmst_h * 15.0 * DEG}


def sun_site_position(sun, latitude_deg, longitude_deg, kernels=None):
    """The per-site half of :func:`sun_position_split`: the hour angle,
    zenith (with parallax) and azimuth of a site from the second's
    :func:`sun_time_terms` ``sun``.  Same return dict as
    :func:`sun_position`."""
    k = kernels or EXACT
    lat = latitude_deg * DEG
    lon = longitude_deg * DEG
    lmst = sun["gmst_ang"] + lon
    ha = lmst - sun["ra"]
    cos_lat, sin_lat = k.cos(lat), k.sin(lat)
    cos_ha = k.cos(ha)
    cos_zen = torch.clamp(cos_lat * cos_ha * sun["cos_dec"]
                          + sun["sin_dec"] * sin_lat, -1.0, 1.0)
    zenith = k.arccos(cos_zen)
    azimuth = _fmod_floor(k.arctan2(
        -k.sin(ha), sun["tan_dec"] * cos_lat - sin_lat * cos_ha), TWO_PI)
    zenith = zenith + _PARALLAX * k.sin(zenith)
    return {"zenith": zenith, "azimuth": azimuth,
            "cos_zenith": k.cos(zenith)}


def sun_position_split(day2000, sec_of_day, latitude_deg, longitude_deg,
                       kernels=None):
    """PSA+ sun position from the float32-safe split time: ``day2000``
    whole UT days since 2000-01-01, ``sec_of_day`` seconds within that UT
    day.  Each ephemeris term multiplies its coefficient by the day and
    the fraction separately, so the ~1.7e9 epoch never forms in float32.
    Arguments are broadcastable float32 tensors.  The composition of the
    second's :func:`sun_time_terms` and the site's
    :func:`sun_site_position`; same return dict as :func:`sun_position`."""
    return sun_site_position(sun_time_terms(day2000, sec_of_day, kernels),
                             latitude_deg, longitude_deg, kernels)


def alt2pres_f32(altitude_m):
    """:func:`alt2pres` on float32 tensors (a libm ``pow`` in either
    kernel set, as in the JAX package)."""
    return STD_PRESSURE * (1.0 - 2.25577e-5 * altitude_m) ** 5.25588


def apparent_elevation_f32(zenith, pressure, temperature_c=12.0,
                           kernels=None):
    """:func:`apparent_elevation` on float32 tensors."""
    k = kernels or EXACT
    e_deg = cdiv(np.pi / 2.0 - zenith, DEG)
    p_mbar = cdiv(pressure, 100.0)
    de = (cdiv(p_mbar, 1010.0) * (283.0 / (273.0 + temperature_c)) * 1.02
          / (60.0 * k.tan((e_deg + rdiv(10.3, e_deg + 5.11)) * DEG)))
    de = torch.where(e_deg >= -(0.26667 + 0.5667), de, torch.zeros_like(de))
    return (e_deg + de) * DEG


def airmass_kasten_young_f32(apparent_zenith, kernels=None):
    """:func:`relative_airmass_kasten_young` on float32 tensors."""
    k = kernels or EXACT
    z_deg = torch.clamp(cdiv(apparent_zenith, DEG), 0.0, 90.0)
    return rdiv(1.0, k.cos(z_deg * DEG)
                + 0.50572 * k.powc(96.07995 - z_deg, -1.6364))


def linke_turbidity_f32(doy, monthly):
    """:func:`linke_turbidity` on float32 tensors (``monthly``: ``(12,)``)."""
    mids = torch.tensor(LINKE_MIDS, dtype=torch.float32, device=doy.device)
    ext_mids = torch.cat([mids[-1:] - 365.0, mids, mids[:1] + 365.0])
    ext_vals = torch.cat([monthly[-1:], monthly, monthly[:1]])
    i = torch.clamp(torch.searchsorted(ext_mids, doy.contiguous(),
                                       right=True) - 1, 0, 12)
    f = (doy - ext_mids[i]) / (ext_mids[i + 1] - ext_mids[i])
    return ext_vals[i] * (1.0 - f) + ext_vals[i + 1] * f


def ineichen_ghi_f32(apparent_zenith, airmass_absolute, tl, altitude_m,
                     dni_extra, kernels=None):
    """:func:`ineichen_ghi` on float32 tensors."""
    k = kernels or EXACT
    fh1 = k.exp(cdiv(-altitude_m, 8000.0))
    fh2 = k.exp(cdiv(-altitude_m, 1250.0))
    cg1 = 5.09e-5 * altitude_m + 0.868
    cg2 = 3.92e-5 * altitude_m + 0.0387
    cos_zen = torch.clamp_min(k.cos(apparent_zenith), 0.0)
    ghi = (cg1 * dni_extra * cos_zen
           * k.exp(-cg2 * airmass_absolute * (fh1 + fh2 * (tl - 1.0))))
    return torch.clamp_min(ghi, 0.0)


def csi_zenith_cap_f32(zenith, kernels=None):
    """:func:`csi_zenith_cap` on float32 tensors."""
    k = kernels or EXACT
    cos_z = k.cos(zenith)
    cap = (27.21 * k.exp(-114.0 * cos_z)
           + 1.665 * k.exp(-4.494 * cos_z) + 1.08)
    return torch.clamp_max(cap, 1e6)


def angle_of_incidence_cos_f32(surface_tilt_deg, surface_azimuth_deg,
                               zenith, azimuth, kernels=None):
    """:func:`angle_of_incidence_cos` on float32 tensors."""
    k = kernels or EXACT
    tilt = surface_tilt_deg * DEG
    saz = surface_azimuth_deg * DEG
    return (k.cos(tilt) * k.cos(zenith)
            + k.sin(tilt) * k.sin(zenith) * k.cos(azimuth - saz))


def device_geometry(day2000, sec_of_day, doy, latitude_deg, longitude_deg,
                    altitude_m, surface_tilt_deg, surface_azimuth_deg,
                    albedo, turbidity_monthly, kernels=None):
    """Every geometry feature from split time and per-site scalars, in
    float32 (the site-grid path).  Time rows and site tensors broadcast
    against each other (``(T, 1)`` against ``(n,)`` gives ``(T, n)``
    fields).  Same dict as :func:`block_geometry`; ``surface_tilt`` and
    ``albedo`` are the site tensors."""
    from tmhpvsim_torch.models.pv import extra_radiation_spencer

    pos = sun_site_position(sun_time_terms(day2000, sec_of_day, kernels),
                            latitude_deg, longitude_deg, kernels)
    pressure = alt2pres_f32(altitude_m)
    app_zen = np.pi / 2.0 - apparent_elevation_f32(pos["zenith"], pressure,
                                                   kernels=kernels)
    am_abs = cdiv(airmass_kasten_young_f32(app_zen, kernels) * pressure,
                  STD_PRESSURE)
    dni_extra = extra_radiation_spencer(doy, SOLAR_CONSTANT, kernels)
    tl = linke_turbidity_f32(doy, turbidity_monthly)
    ghi_clear = ineichen_ghi_f32(app_zen, am_abs, tl, altitude_m, dni_extra,
                                 kernels)
    cos_aoi = angle_of_incidence_cos_f32(surface_tilt_deg,
                                         surface_azimuth_deg, app_zen,
                                         pos["azimuth"], kernels)
    return {
        "zenith": pos["zenith"],
        "cos_zenith": pos["cos_zenith"],
        "apparent_zenith": app_zen,
        "azimuth": pos["azimuth"],
        "csi_cap": csi_zenith_cap_f32(pos["zenith"], kernels),
        "ghi_clear": ghi_clear,
        "dni_extra": dni_extra,
        "airmass_abs": am_abs,
        "cos_aoi": cos_aoi,
        "doy": doy,
        "surface_tilt": surface_tilt_deg,
        "albedo": albedo,
    }


# ---------------------------------------------------------------------------
# strided geometry (SimConfig.geom_stride): evaluate every s seconds, lerp
# ---------------------------------------------------------------------------

#: geometry fields linearly interpolated between stride samples: the
#: trig-free outputs of the chain, smooth at the apparent solar rate.
#: ``azimuth`` wraps at 2 pi and nothing downstream of ``cos_aoi`` reads
#: it, so it is held at the left sample; ``doy`` keeps its exact
#: per-second value.
STRIDE_LERP_FIELDS = (
    "zenith", "cos_zenith", "apparent_zenith", "csi_cap",
    "ghi_clear", "dni_extra", "airmass_abs", "cos_aoi",
)

#: published float64-oracle error bounds of ``geom_stride=60`` in each
#: field's units: max |strided - per-second float64 oracle| over every
#: daytime second (``cos_zenith >= 0.01``) across solstice / equinox days
#: at equatorial, mid-latitude and polar sites (the JAX package's
#: tests/test_geom_stride.py measures them)
STRIDE_MAX_ABS_ERR = {
    "zenith": 5e-4,
    "cos_zenith": 1e-5,
    "apparent_zenith": 5e-4,
    "csi_cap": 0.3,
    "ghi_clear": 0.5,
    "dni_extra": 0.05,
    "airmass_abs": 0.2,
    "cos_aoi": 1e-4,
}

#: the strides SimConfig.geom_stride resolves to (30 and 60 divide 60, so
#: a stride window never straddles a minute or a block boundary)
STRIDES = (1, 30, 60)


def interp_sampled(sampled, i, f):
    """Lerp the :data:`STRIDE_LERP_FIELDS` of a stride-sampled geometry
    dict at sample index ``i`` plus fraction ``f`` in [0, 1).

    ``sampled`` holds arrays with a leading sample axis; ``i`` / ``f``
    index and weight it per second.  numpy arrays (the host's float64
    geometry) lerp as ``lo * (1 - f) + hi * f``; float32 torch tensors
    (the site grid's samples, ``(S, n)`` against ``(T,)`` weights) with
    the JAX scan's contraction, ``fma(lo, 1 - f, hi * f)``.  Returns only
    the interpolated fields."""
    out = {}
    for k in STRIDE_LERP_FIELDS:
        v = sampled[k]
        lo, hi = v[i], v[i + 1]
        if isinstance(v, torch.Tensor):
            fa = f.reshape(f.shape + (1,) * (lo.dim() - f.dim()))
            out[k] = fma(lo, 1.0 - fa, hi * fa)
        else:
            fa = np.asarray(f)
            fa = fa.reshape(fa.shape + (1,) * (lo.ndim - fa.ndim))
            out[k] = lo * (1.0 - fa) + hi * fa
    return out


def interp_sampled_bf16(sampled, i, f):
    """:func:`interp_sampled` on the bf16 path (models/bf16.py values):
    the float32 samples narrowed to bf16 (the engine stores them so), the
    fraction ``f`` rounded to bf16, and the lerp ``lo * (1 - f) + hi * f``
    in bf16, each step rounded."""
    from tmhpvsim_torch.models import bf16 as mx

    fb = mx.bf16_input(f.reshape(f.shape + (1,)))
    out = {}
    for k in STRIDE_LERP_FIELDS:
        v = sampled[k]
        out[k] = mx.bf16_input(v[i]) * (1.0 - fb) + \
            mx.bf16_input(v[i + 1]) * fb
    return out


def stride_samples(epoch, doy, stride: int):
    """The sample grid of a block for ``stride``: ``T // stride + 1``
    epochs and days of year, every ``stride`` seconds from the block's
    first, the last being the exact next second after the block with its
    doy clamped to the block's last second (numpy; ``epoch`` int64 or
    float64)."""
    ep_s = np.concatenate([epoch[::stride], epoch[-1:] + 1])
    doy_s = np.concatenate([doy[::stride], doy[-1:]])
    return ep_s, doy_s


def stride_weights(T: int, stride: int):
    """Per second of a ``T``-second block: the sample index (int32) and
    the lerp fraction ``(s % stride) / stride`` (float64)."""
    pos = np.arange(T)
    return (pos // stride).astype(np.int32), (pos % stride) / float(stride)


def check_stride(T: int, stride: int) -> None:
    """Raise as the JAX package does for a stride outside ``STRIDES`` or
    one that does not divide the block."""
    if stride not in STRIDES:
        raise ValueError(f"geom_stride must be one of {STRIDES}, "
                         f"got {stride}")
    if T % stride:
        raise ValueError(f"block length {T} not a multiple of "
                         f"geom_stride {stride}")


def strided_block_geometry(epoch_s, doy, site, stride):
    """:func:`block_geometry` evaluated on a stride grid and lerped back
    to 1 Hz in float64 (the shared-site ``geom_stride`` lever: the rows
    shipped to the card keep their shapes, the kernel is unchanged).  The
    sample grid is :func:`stride_samples`; ``stride=1`` is
    :func:`block_geometry` itself."""
    epoch_s = np.asarray(epoch_s)
    doy = np.asarray(doy)
    T = epoch_s.shape[0]
    if stride <= 1:
        return block_geometry(epoch_s, doy, site)
    check_stride(T, stride)
    ep_s, doy_s = stride_samples(epoch_s, doy, stride)
    geom_s = block_geometry(ep_s, doy_s, site)
    i, f = stride_weights(T, stride)
    out = dict(geom_s)
    out.update(interp_sampled(geom_s, i, f))
    out["doy"] = doy                       # exact per-second day index
    out["azimuth"] = geom_s["azimuth"][i]  # held: wraps at 2 pi, unused
    return out
