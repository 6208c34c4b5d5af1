"""The sun position split into a per-second and a per-site half
(tmhpvsim_torch/models/solar.py ``sun_time_terms`` and
``sun_site_position``), as the block-step kernel's site modes compute it
(csrc/block_step.cuh ``sun_time`` once per second and CTA, ``geometry``
per chain).

Tolerances:
* against the one-piece sun position it replaces (a frozen copy of the
  port's own function below): bit for bit -- the same float32 operations
  in the same order, the time half evaluated on the ``(T, 1)`` time rows
  -- in both kernel sets, through ``sun_position_split``,
  ``device_geometry``, the plain version of the kernel's geometry entry
  (``geometry_fields_plain``) and the strided mode's samples;
* against the JAX package's ``device_geometry``: the bounds
  tests/test_torch_models.py ``test_device_geometry`` holds the port to
  (4e-4 rad of zenith, 4e-4 of cos(AOI), 1 W/m2 of clear-sky GHI, 1e-3
  relative of the airmass and the csi cap where the sun is up).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmhpvsim_torch.kernels import block_step as k3
from tmhpvsim_torch.models import solar as tsol
from tmhpvsim_torch.models.pv import extra_radiation_spencer
from tmhpvsim_torch.models.tables import get_kernels
from tmhpvsim_torch.rng import cdiv
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.models import solar as jsol
from tmhpvsim_tpu.models import tables as jtab
from tmhpvsim_tpu.models import timegrid as jtg
from test_torch_threads import one_torch_thread  # noqa: F401

#: a solstice, an equinox, the main path's day, the other solstice
DAYS = ["2019-06-21 00:00:00", "2019-03-20 00:00:00",
        "2019-09-05 00:00:00", "2019-12-21 00:00:00"]
#: equatorial, mid-latitude (two orientations), polar (midnight sun and
#: polar night across the solstices)
SITES = [
    (1.3, 103.8, 15.0, 5.0, 180.0, 0.15),
    (48.12, 11.60, 34.0, 35.0, 180.0, 0.25),
    (-33.9, 18.4, 500.0, 30.0, 0.0, 0.2),
    (78.2, 15.6, 10.0, 60.0, 170.0, 0.5),
]
KSETS = ["exact", "table"]


def _sun_position_split_one_piece(day2000, sec_of_day, latitude_deg,
                                  longitude_deg, kernels=None):
    """The port's ``sun_position_split`` before the split, frozen: the
    whole PSA+ ephemeris evaluated on the broadcast of time and site."""
    k = kernels or tsol.EXACT
    lat = latitude_deg * tsol.DEG
    lon = longitude_deg * tsol.DEG
    frac = cdiv(sec_of_day, 86400.0) - 0.5
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
    ra = tsol._fmod_floor(k.arctan2(k.cos(obliquity) * sin_l,
                                    k.cos(ecl_lon)), tsol.TWO_PI)
    dec = k.arcsin(k.sin(obliquity) * sin_l)
    gmst_h = tsol._fmod_floor(6.697096103e0 + 6.570984737e-2 * day2000,
                              24.0) + 6.570984737e-2 * frac + hour_ut
    lmst = gmst_h * 15.0 * tsol.DEG + lon
    ha = lmst - ra
    cos_lat, sin_lat = k.cos(lat), k.sin(lat)
    cos_dec, sin_dec = k.cos(dec), k.sin(dec)
    cos_ha = k.cos(ha)
    cos_zen = torch.clamp(cos_lat * cos_ha * cos_dec + sin_dec * sin_lat,
                          -1.0, 1.0)
    zenith = k.arccos(cos_zen)
    azimuth = tsol._fmod_floor(k.arctan2(
        -k.sin(ha), k.tan(dec) * cos_lat - sin_lat * cos_ha), tsol.TWO_PI)
    zenith = zenith + tsol._PARALLAX * k.sin(zenith)
    return {"zenith": zenith, "azimuth": azimuth,
            "cos_zenith": k.cos(zenith)}


def _device_geometry_one_piece(day2000, sec_of_day, doy, latitude_deg,
                               longitude_deg, altitude_m, surface_tilt_deg,
                               surface_azimuth_deg, albedo,
                               turbidity_monthly, kernels=None):
    """The port's ``device_geometry`` before the split, frozen (on the
    one-piece sun position above)."""
    pos = _sun_position_split_one_piece(day2000, sec_of_day, latitude_deg,
                                        longitude_deg, kernels)
    pressure = tsol.alt2pres_f32(altitude_m)
    app_zen = np.pi / 2.0 - tsol.apparent_elevation_f32(
        pos["zenith"], pressure, kernels=kernels)
    am_abs = cdiv(tsol.airmass_kasten_young_f32(app_zen, kernels) * pressure,
                  tsol.STD_PRESSURE)
    dni_extra = extra_radiation_spencer(doy, tsol.SOLAR_CONSTANT, kernels)
    tl = tsol.linke_turbidity_f32(doy, turbidity_monthly)
    return {
        "zenith": pos["zenith"],
        "cos_zenith": pos["cos_zenith"],
        "apparent_zenith": app_zen,
        "azimuth": pos["azimuth"],
        "csi_cap": tsol.csi_zenith_cap_f32(pos["zenith"], kernels),
        "ghi_clear": tsol.ineichen_ghi_f32(app_zen, am_abs, tl, altitude_m,
                                           dni_extra, kernels),
        "dni_extra": dni_extra,
        "airmass_abs": am_abs,
        "cos_aoi": tsol.angle_of_incidence_cos_f32(
            surface_tilt_deg, surface_azimuth_deg, app_zen, pos["azimuth"],
            kernels),
        "doy": doy,
        "surface_tilt": surface_tilt_deg,
        "albedo": albedo,
    }


def _time_rows(day, step=60):
    """A day's split time every ``step`` seconds: ``(T, 1)`` float32
    day2000, sec_of_day and doy, as the site rows carry them."""
    spec = jtg.TimeGridSpec.from_local_start(day, 86400, "Europe/Berlin")
    b = spec.block(0, 86400)
    ep = b.epoch[::step]
    return tuple(torch.from_numpy(v.astype(np.float32))[:, None] for v in (
        ep // 86400 - 10957, ep % 86400, b.doy[::step]))


def _site_cols():
    cols = np.asarray(SITES, np.float32).T
    return [torch.from_numpy(c.copy()) for c in cols]


def _turb():
    return torch.tensor(jcfg.Site().linke_turbidity_monthly,
                        dtype=torch.float32)


def _bits(a):
    return a.contiguous().view(torch.int32)


def _same_bits(got, want, what):
    shape = torch.broadcast_shapes(got.shape, want.shape)
    g = _bits(torch.broadcast_to(got, shape).contiguous())
    w = _bits(torch.broadcast_to(want, shape).contiguous())
    assert torch.equal(g, w), (what, int((g != w).sum()))


@pytest.mark.parametrize("ks", KSETS)
@pytest.mark.parametrize("day", DAYS)
def test_split_is_the_one_piece_sun_position(day, ks):
    """The time half on the ``(T, 1)`` rows composed with the site half
    gives the one-piece function's bits: ``sun_position_split``,
    ``device_geometry``, the kernel geometry entry's plain version and the
    strided mode's samples (stride 60)."""
    d2k, sec, doy = _time_rows(day)
    cols = _site_cols()
    kern = get_kernels(ks)
    sun = tsol.sun_time_terms(d2k, sec, kern)
    assert all(v.shape == d2k.shape for v in sun.values())
    want = _sun_position_split_one_piece(d2k, sec, cols[0], cols[1], kern)
    for got in (tsol.sun_position_split(d2k, sec, cols[0], cols[1], kern),
                tsol.sun_site_position(sun, cols[0], cols[1], kern)):
        for k in want:
            _same_bits(got[k], want[k], k)
    want = _device_geometry_one_piece(d2k, sec, doy, *cols, _turb(), kern)
    got = tsol.device_geometry(d2k, sec, doy, *cols, _turb(), kern)
    assert list(got) == list(want)
    for k in k3.GEOM_FIELDS:
        _same_bits(got[k], want[k], k)
    # the plain version of the kernel's geometry entry, from site rows
    T = d2k.shape[0]
    rows_f = torch.cat([torch.zeros((3, T)), d2k.T, sec.T, doy.T])
    site = k3.SiteGeometry(dict(zip(("latitude", "longitude", "altitude",
                                     "surface_tilt", "surface_azimuth",
                                     "albedo"), cols)), _turb())
    fields = k3.geometry_fields_plain(rows_f, site, ks)
    for i, k in enumerate(k3.GEOM_FIELDS):
        _same_bits(fields[i], want[k], k)
    # the strided mode's samples: the sample rows through the same split
    srows = torch.zeros((7, 60))
    srows[4, :2], srows[5, :2], srows[6, :2] = d2k[:2, 0], sec[:2, 0], \
        doy[:2, 0]
    samp, _, _ = k3._stride_samples(srows, k3.SiteGeometry(
        site.site, site.turbidity, stride=60), ks)
    want = _device_geometry_one_piece(d2k[:2], sec[:2], doy[:2], *cols,
                                      _turb(), kern)
    for k in k3.GEOM_FIELDS:
        _same_bits(samp[k], want[k], k)


@pytest.mark.parametrize("ks", KSETS)
@pytest.mark.parametrize("day", DAYS)
def test_split_geometry_matches_jax(day, ks):
    """The split port geometry against the JAX package's
    ``device_geometry`` (models/solar.py:434), at test_device_geometry's
    bounds."""
    d2k, sec, doy = _time_rows(day)
    cols = _site_cols()
    turb = _turb()
    want = jsol.device_geometry(
        *(jnp.asarray(v.numpy()) for v in (d2k, sec, doy)),
        *(jnp.asarray(c.numpy()) for c in cols), jnp.asarray(turb.numpy()),
        xp=jnp, kernels=jtab.get_kernels(ks, jnp))
    got = tsol.device_geometry(d2k, sec, doy, *cols, turb, get_kernels(ks))
    assert list(got) == list(want)
    n = len(SITES)
    up = np.broadcast_to(np.asarray(want["zenith"]), (len(d2k), n)) < \
        np.radians(88.0)
    assert up.any() and (~up).any()
    bounds = {"zenith": 4e-4, "cos_zenith": 4e-4, "apparent_zenith": 4e-4,
              "cos_aoi": 4e-4, "ghi_clear": 1.0, "csi_cap": 1e-3,
              "dni_extra": 1e-3, "airmass_abs": 1e-3}
    for k, bound in bounds.items():
        w = np.broadcast_to(np.asarray(want[k], np.float64), (len(d2k), n))
        g = np.broadcast_to(got[k].numpy().astype(np.float64), w.shape)
        err = np.abs(w - g) / (np.abs(w) if k in ("airmass_abs", "csi_cap")
                               else 1.0)
        assert err[up].max() < bound, (k, err[up].max())
        assert np.isfinite(g).all(), k
    daz = np.asarray(want["azimuth"], np.float64) - got["azimuth"].numpy()
    daz = np.abs((daz + np.pi) % (2 * np.pi) - np.pi)
    assert daz[up].max() < 4e-4
