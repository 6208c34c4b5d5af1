"""SAM database loaders: exact hardware rows, when you have the files (own
copy of the JAX package's data/sam.py).

The reference pins its hardware to two concrete SAM database rows fetched
through pvlib at construction time (pvmodel.py:13-17):

* module:   ``Hanwha_HSL60P6_PA_4_250T__2013_``  (Sandia module library)
* inverter: ``ABB__MICRO_0_25_I_OUTD_US_208_208V__CEC_2014_`` (CEC library)

This framework vendors nominal same-hardware-class coefficients instead
(data/parameters.py) because neither pvlib nor the SAM CSVs exist in the
runtime image and the build environment has no network egress — the exact
rows are *public* data but unobtainable here, and inventing 40 six-digit
coefficients would be worse than honest nominals.

This module closes the gap from the other side: it parses the standard SAM
library CSVs (``sam-library-sandia-modules-*.csv``, ``CEC Inverters.csv``
— the exact files pvlib ships and ``retrieve_sam`` reads) into the dict
shape ``models/pv.py`` and the kernels' generated constants consume.  Point the env vars

    TMHPVSIM_SAM_MODULES=/path/to/sam-library-sandia-modules-2015-6-30.csv
    TMHPVSIM_SAM_INVERTERS=/path/to/sam-library-cec-inverters-2019-03-05.csv

at the files (optionally ``TMHPVSIM_SAM_MODULE_NAME`` /
``TMHPVSIM_SAM_INVERTER_NAME`` to pick different rows) and every consumer
— the plain models and, through ``consts.cuh`` (kernels/build.py), the
kernels — runs with the exact reference hardware, the same rows the JAX
package reads from the same variables.
"""

from __future__ import annotations

import csv
import re

#: The rows the reference selects (pvmodel.py:13-17), in pvlib's
#: normalised-name form.
REFERENCE_MODULE_NAME = "Hanwha_HSL60P6_PA_4_250T__2013_"
REFERENCE_INVERTER_NAME = "ABB__MICRO_0_25_I_OUTD_US_208_208V__CEC_2014_"


def _norm(name: str) -> str:
    """Name canonicalisation for row lookup.

    pvlib's retrieve_sam maps each punctuation character to '_'
    one-for-one, which makes the underscore *count* depend on the exact
    spacing in a given library vintage.  Both the lookup key and the CSV
    names are therefore canonicalised the same way — non-alphanumerics to
    '_', runs collapsed, ends stripped — so every historical spelling of
    the same product matches.
    """
    return re.sub(r"_+", "_", re.sub(r"[^A-Za-z0-9]", "_", name)).strip("_")


def _read_rows(path: str):
    """Yield (name, {normalised_column: raw_value}) for each data row.

    SAM CSVs have a header row, then a units row, then data; some variants
    insert a ``[0]/[1]/[2]`` type row.  Non-data rows are filtered by
    failing to parse any numeric field.
    """
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        cols = [_norm(c).lower() for c in header]
        for row in reader:
            if not row or not row[0]:
                continue
            rec = dict(zip(cols, row))
            yield row[0], rec


def _pick(path: str, name: str, kind: str) -> dict:
    want = _norm(name)
    names = []
    for raw_name, rec in _read_rows(path):
        if _norm(raw_name) == want:
            return rec
        names.append(raw_name)
    raise KeyError(
        f"{kind} {name!r} not found in {path}; rows present: "
        f"{names[:5]}... ({len(names)} total)"
    )


def _f(rec: dict, *candidates: str, default=None) -> float:
    for c in candidates:
        v = rec.get(c.lower())
        if v not in (None, ""):
            try:
                return float(v)
            except ValueError:
                continue
    if default is not None:
        return default
    raise KeyError(f"none of {candidates} present/numeric in SAM row")


def load_sam_module(path: str, name: str = REFERENCE_MODULE_NAME) -> dict:
    """A Sandia-library module row -> the SAPM dict models/pv.py reads.

    Column synonyms cover the header variations across SAM library vintages
    (e.g. ``BVmpo`` vs ``Bvmpo``, ``DTC`` for the cell/back temperature
    delta, ``A``/``B`` for the thermal-model coefficients).
    """
    rec = _pick(path, name, "module")
    return {
        "Cells_in_Series": int(_f(rec, "Cells_in_Series", "Cells in Series",
                                  "Serial_Cells")),
        "Isco": _f(rec, "Isco"),
        "Voco": _f(rec, "Voco"),
        "Impo": _f(rec, "Impo"),
        "Vmpo": _f(rec, "Vmpo"),
        "Aisc": _f(rec, "Aisc", "AIsc"),
        "Aimp": _f(rec, "Aimp", "AImp"),
        "Bvoco": _f(rec, "Bvoco", "BVoco", "BVoc0"),
        "Mbvoc": _f(rec, "Mbvoc", "MBVoc", default=0.0),
        "Bvmpo": _f(rec, "Bvmpo", "BVmpo", "BVmp0"),
        "Mbvmp": _f(rec, "Mbvmp", "MBVmp", default=0.0),
        "N": _f(rec, "N"),
        "C0": _f(rec, "C0"),
        "C1": _f(rec, "C1"),
        "C2": _f(rec, "C2"),
        "C3": _f(rec, "C3"),
        "A0": _f(rec, "A0"), "A1": _f(rec, "A1"), "A2": _f(rec, "A2"),
        "A3": _f(rec, "A3"), "A4": _f(rec, "A4"),
        "B0": _f(rec, "B0"), "B1": _f(rec, "B1"), "B2": _f(rec, "B2"),
        "B3": _f(rec, "B3"), "B4": _f(rec, "B4"), "B5": _f(rec, "B5"),
        "FD": _f(rec, "FD", default=1.0),
        "T_a": _f(rec, "A"),
        "T_b": _f(rec, "B"),
        "T_deltaT": _f(rec, "DTC"),
    }


def load_sam_inverter(path: str,
                      name: str = REFERENCE_INVERTER_NAME) -> dict:
    """A CEC-library inverter row -> the Sandia-inverter dict."""
    rec = _pick(path, name, "inverter")
    return {
        "Paco": _f(rec, "Paco"),
        "Pdco": _f(rec, "Pdco"),
        "Vdco": _f(rec, "Vdco"),
        "Pso": _f(rec, "Pso"),
        "C0": _f(rec, "C0"),
        "C1": _f(rec, "C1"),
        "C2": _f(rec, "C2"),
        "C3": _f(rec, "C3"),
        "Pnt": _f(rec, "Pnt"),
    }


def env_overrides() -> tuple:
    """(module|None, inverter|None) from the TMHPVSIM_SAM_* env vars."""
    import os

    module = inverter = None
    mpath = os.environ.get("TMHPVSIM_SAM_MODULES")
    if mpath:
        module = load_sam_module(
            mpath, os.environ.get("TMHPVSIM_SAM_MODULE_NAME",
                                  REFERENCE_MODULE_NAME))
    ipath = os.environ.get("TMHPVSIM_SAM_INVERTERS")
    if ipath:
        inverter = load_sam_inverter(
            ipath, os.environ.get("TMHPVSIM_SAM_INVERTER_NAME",
                                  REFERENCE_INVERTER_NAME))
    return module, inverter
