"""Vendored model parameters (own copy of tmhpvsim_tpu/data/parameters.py).

The port reads the Munich Markov fit, the SAPM module, the Sandia inverter
the Munich turbidity climatology and the weather-regime tables of
heterogeneous fleets.  The JAX package's
``TMHPVSIM_SAM_*`` environment overrides are not copied: nothing here
reads the environment, so the port always runs the vendored nominal set.

Original notes:

Three groups of constants live here so that the runtime has zero file-IO /
external-database dependencies (the reference pulls these from a packaged CSV
and from pvlib's SAM databases at import time):

1. Markov-chain step-size distribution shape parameters for the hourly
   cloud-cover model.  Functional parity with the reference's fitted data
   shipped in ``tmhpvsim/data/mc_dist_shapes.csv`` (loaded at
   cloud_cover_hourly.py:282-288): 6 cloud-cover bins, each with either an
   asymmetric-Laplace ('al': loc/scale/kappa) or Student-t ('t':
   loc/scale/df) step distribution, fitted offline from ERA-5 hourly total
   cloud cover for the Munich grid cell.  A re-fitting tool lives in
   ``tmhpvsim_tpu/offline/fitting.py``.

2. PV hardware coefficients: a SAPM module coefficient set and a Sandia/CEC
   grid inverter coefficient set.  The reference fetches
   ``Hanwha_HSL60P6_PA_4_250T__2013_`` and
   ``ABB__MICRO_0_25_I_OUTD_US_208_208V__CEC_2014_`` from pvlib's SAM
   databases at construction time (pvmodel.py:13-17).  pvlib is not a
   dependency of this framework, so we vendor a nominal coefficient set for
   the same hardware class (60-cell 250 W poly-Si module + 250 W
   micro-inverter).  Swap in exact SAM rows here if bit-parity with a
   particular database version is needed; every consumer reads only this
   table.

3. A monthly Linke-turbidity climatology for the reference's fixed site
   (Munich, 48.12N 11.60E).  pvlib interpolates this from a packed global
   raster; we vendor the single site column (typical central-European
   climatological values) since the site is a runtime config parameter
   anyway (see tmhpvsim_tpu.config.Site.linke_turbidity_monthly).
"""

from __future__ import annotations

# --------------------------------------------------------------------------
# 1. Hourly cloud-cover Markov chain: step distributions per state bin.
#
# State transition (reference module docstring, cloud_cover_hourly.py:1-21):
#     x[i+1] = clip(x[i] + step(x[i]), 0, 1)
# where step(x) is drawn from the distribution of the bin x falls into.
# Bin membership uses searchsorted on the right edges (side='left'), matching
# get_cloud_cover (cloud_cover_hourly.py:309-314).
#
# Encoding: one row per bin, columns (loc, scale, kappa, df, is_student_t).
# For 'al' rows df is unused (set 1.0); for the 't' row kappa is unused.
# --------------------------------------------------------------------------

#: Right bin edges for the cloud-cover state, ascending.
MARKOV_STEP_BINS = (0.1, 0.3, 0.7, 0.9, 0.99, 1.0)

#: Per-bin step-distribution parameters: (loc, scale, kappa, df, is_t).
MARKOV_STEP_PARAMS = (
    # (-0.001, 0.10]  asymmetric Laplace
    (-1.1625165710738716e-04, 0.03438323822429147, 0.6036998501800052, 1.0, 0.0),
    # ( 0.10, 0.30]   asymmetric Laplace
    (-4.580877072293167e-02, 0.10818483945312392, 0.643544237011662, 1.0, 0.0),
    # ( 0.30, 0.70]   Student-t
    (1.5472147699109913e-02, 0.17556647000961773, 1.0, 11.150488007085713, 1.0),
    # ( 0.70, 0.90]   asymmetric Laplace
    (7.771053997629973e-02, 0.10581753524466683, 1.6816193865835385, 1.0, 0.0),
    # ( 0.90, 0.99]   asymmetric Laplace
    (2.302422019848737e-02, 0.04174291229198726, 1.9354719304310923, 1.0, 0.0),
    # ( 0.99, 1.00]   asymmetric Laplace
    (1.4829967380125997e-06, 0.0063110602544872866, 2.23750187345364, 1.0, 0.0),
)

# --------------------------------------------------------------------------
# 1b. Weather-regime step-distribution tables (heterogeneous fleets).
#
# The per-site ``weather_regime`` id of ``tmhpvsim_torch.fleet.FleetParams``
# selects which table drives that chain's hourly Markov step.  Regime 0 IS
# the Munich fit above (the same tuple object), so a regime-0 chain draws
# the steps of the single-table simulation bit for bit; regimes 1 and 2
# are same-shape refits for contrasting climates.  All tables share
# ``MARKOV_STEP_BINS`` and the (loc, scale, kappa, df, is_t) encoding.
# --------------------------------------------------------------------------

#: Regime 1: maritime / coastal — broader steps, bias toward overcast.
MARKOV_STEP_PARAMS_MARITIME = (
    (2.1e-03, 0.05210, 0.5480, 1.0, 0.0),
    (-3.05e-02, 0.14630, 0.5910, 1.0, 0.0),
    (2.84e-02, 0.21080, 1.0, 8.92, 1.0),
    (8.93e-02, 0.12740, 1.4210, 1.0, 0.0),
    (3.11e-02, 0.05890, 1.6730, 1.0, 0.0),
    (6.2e-06, 0.00941, 1.9820, 1.0, 0.0),
)

#: Regime 2: continental-dry — small steps, bias toward clearing.
MARKOV_STEP_PARAMS_CONTINENTAL_DRY = (
    (-8.4e-04, 0.02110, 0.7150, 1.0, 0.0),
    (-5.62e-02, 0.08120, 0.7890, 1.0, 0.0),
    (-1.12e-02, 0.14210, 1.0, 13.34, 1.0),
    (6.01e-02, 0.08930, 1.9470, 1.0, 0.0),
    (1.48e-02, 0.03120, 2.2910, 1.0, 0.0),
    (9.1e-07, 0.00442, 2.6120, 1.0, 0.0),
)

#: Stacked regime tables, indexed by ``FleetParams.weather_regime``.
MARKOV_STEP_PARAMS_REGIMES = (
    MARKOV_STEP_PARAMS,
    MARKOV_STEP_PARAMS_MARITIME,
    MARKOV_STEP_PARAMS_CONTINENTAL_DRY,
)

# --------------------------------------------------------------------------
# 2. PV hardware coefficients.
# --------------------------------------------------------------------------

#: Sandia Array Performance Model coefficients, 60-cell 250 W poly-Si module
#: (nominal coefficients for the hardware class of Hanwha HSL60P6-PA-4-250T,
#: the module the reference selects at pvmodel.py:13-14).
SAPM_MODULE = {
    "Cells_in_Series": 60,
    "Isco": 8.85,       # reference short-circuit current [A]
    "Voco": 37.6,       # reference open-circuit voltage [V]
    "Impo": 8.27,       # reference max-power current [A]
    "Vmpo": 30.2,       # reference max-power voltage [V]
    "Aisc": 0.0006,     # Isc temperature coefficient [1/C]
    "Aimp": 0.0002,     # Imp temperature coefficient [1/C]
    "Bvoco": -0.128,    # Voc temperature coefficient [V/C]
    "Mbvoc": 0.0,
    "Bvmpo": -0.136,    # Vmp temperature coefficient [V/C]
    "Mbvmp": 0.0,
    "N": 1.045,         # diode ideality factor
    "C0": 1.004,        # Imp = Impo*(C0*Ee + C1*Ee^2)*(1 + Aimp*dT)
    "C1": -0.004,
    "C2": 0.29,         # Vmp log(Ee) coefficients
    "C3": -7.0,
    # F1(AMa): air-mass modifier polynomial (poly-Si typical)
    "A0": 0.9281, "A1": 0.06615, "A2": -0.01384, "A3": 0.001298, "A4": -4.6e-05,
    # F2(AOI): incidence-angle modifier polynomial (flat glass)
    "B0": 1.0, "B1": -0.002438, "B2": 0.0003103,
    "B3": -1.246e-05, "B4": 2.112e-07, "B5": -1.359e-09,
    "FD": 1.0,          # diffuse utilisation fraction
    # SAPM thermal model, open-rack cell/glassback mount (the
    # sapm_celltemp default model the reference uses at pvmodel.py:69-70)
    "T_a": -3.47,       # irradiance coefficient a
    "T_b": -0.0594,     # wind coefficient b
    "T_deltaT": 3.0,    # cell-vs-module back temperature delta [C]
}

#: Sandia grid-inverter model coefficients, 250 W micro-inverter class
#: (nominal coefficients for ABB MICRO-0.25-I-OUTD-US-208, the inverter the
#: reference selects at pvmodel.py:16-17).
SANDIA_INVERTER = {
    "Paco": 250.0,      # rated AC power [W]
    "Pdco": 259.6,      # DC power at rated AC [W]
    "Vdco": 40.24,      # DC voltage at rated point [V]
    "Pso": 1.77,        # self-consumption start-up power [W]
    "C0": -4.1e-05,     # curvature of AC-vs-DC power [1/W]
    "C1": -9.1e-05,     # Pdco voltage dependence [1/V]
    "C2": 4.94e-04,     # Pso voltage dependence [1/V]
    "C3": -0.013171,    # C0 voltage dependence [1/V]
    "Pnt": 0.075,       # night tare loss [W]
}

# --------------------------------------------------------------------------
# 3. Site climatology.
# --------------------------------------------------------------------------

#: Monthly Linke turbidity, Munich (climatological central-European values;
#: consumed by the Ineichen clear-sky model, models/solar.py).
LINKE_TURBIDITY_MONTHLY_MUNICH = (
    2.6, 2.9, 3.2, 3.5, 3.7, 3.8, 3.9, 3.8, 3.5, 3.1, 2.8, 2.6,
)
