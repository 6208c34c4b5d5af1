"""K11 on its own: one table transcendental over a float32 array.

Replaces, elementwise, tmhpvsim_tpu/models/tables.py ``table_kernels``
(:354).  The block step inlines the same device functions in its Table
instantiations (csrc/block_step_table.cu); ``table_eval`` is the check
entry that holds each function against its plain version
(models/tables.py ``TABLE``) on many arguments.  On CPU tensors it runs
the plain version; on CUDA tensors it launches csrc/tables.cu.
"""

from __future__ import annotations

import ctypes

import torch

from tmhpvsim_torch.kernels import build
from tmhpvsim_torch.models import tables

K11 = build.LaunchCounter("table_eval")
COUNTERS = (K11,)

#: the functions of the table set, in csrc/tables.cu's ``Fn`` order
FUNCS = ("sin", "cos", "tan", "arcsin", "arccos", "arctan2", "exp", "log",
         "powc", "spencer_factor")

#: operations per call of each function, counted from its code
#: (csrc/tables.cuh: a multiply-add counts 2; an add, multiply, divide,
#: square root, rounding, conversion, compare, select, min or max 1; the
#: integer steps of exp2i and frexp too): exp 28 (clamp 4, reduction 6,
#: polynomial 10, the rest 8), log 40 (frexp 16, polynomial 6, the rest
#: 18), sin / cos 31 / 32 (reduction 10, both polynomials 16, selects),
#: tan 33, arccos 25, arcsin 26, atan2 35, powc = log + 1 + exp; the
#: Spencer factor 4 and one 4-byte load
OPS = {"sin": 31, "cos": 32, "tan": 33, "arcsin": 26, "arccos": 25,
       "arctan2": 35, "exp": 28, "log": 40, "powc": 69,
       "spencer_factor": 4}


def kernel_constants() -> dict:
    """The constants csrc/tables.cuh reads (TB_*, SPENCER_LUT)."""
    t = tables
    return {
        "TB_LOG2E": t._LOG2E, "TB_LN2_HI": t._LN2_HI, "TB_LN2_LO": t._LN2_LO,
        "TB_EXP_P": list(t.EXP_P), "TB_SQRT_HALF": t._SQRT_HALF,
        "TB_LOG_W": list(t.LOG_W), "TB_TWO_OVER_PI": t._TWO_OVER_PI,
        "TB_PI2_HI": t._PI2_HI, "TB_PI2_MID": t._PI2_MID,
        "TB_PI2_LO": t._PI2_LO, "TB_SIN_W": list(t.SIN_W),
        "TB_COS_W": list(t.COS_W), "TB_ACOS_P": list(t.ACOS_P),
        "TB_PI": t._PI, "TB_HALF_PI": t._HALF_PI,
        "TB_QUARTER_PI": t._QUARTER_PI, "TB_TAN_PI8": t._TAN_PI8,
        "TB_ATAN_TINY": t._ATAN_TINY, "TB_ATAN_W": list(t.ATAN_W),
        "SPENCER_LUT": [float(v) for v in t.SPENCER_LUT],
    }


def table_eval_plain(name: str, x, y=None, p=None):
    """The plain version: ``TABLE.<name>`` (``arctan2(x, y)``,
    ``powc(x, p)``)."""
    fn = getattr(tables.TABLE, name)
    if name == "arctan2":
        return fn(x, y)
    if name == "powc":
        return fn(x, p)
    return fn(x)


def table_eval(name: str, x: torch.Tensor, y: torch.Tensor | None = None,
               p: float | None = None) -> torch.Tensor:
    """``name`` of the table set over ``x`` (float32, contiguous): on the
    card one launch of csrc/tables.cu, on the CPU the plain version."""
    if name not in FUNCS:
        raise ValueError(f"table_eval: unknown function {name!r}")
    if (name == "arctan2") != (y is not None):
        raise ValueError("table_eval: y goes with arctan2 alone")
    if (name == "powc") != (p is not None):
        raise ValueError("table_eval: p goes with powc alone")
    if x.device.type == "cpu":
        return table_eval_plain(name, x, y, p)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for t in (x, y):
        if t is not None and (t.dtype != torch.float32 or t.device != x.device
                              or not t.is_contiguous() or
                              t.shape != x.shape):
            raise ValueError("table_eval: arguments must be contiguous "
                             "float32 tensors of one shape on one device")
    out = torch.empty_like(x)
    fn = build.entry("tables.cu", "table_eval",
                     [ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    p_ = build.ptr
    rc = fn(FUNCS.index(name), x.numel(), p_(x),
            None if y is None else p_(y), 0.0 if p is None else float(p),
            p_(out), build.stream_ptr(x.device))
    build.check(rc, "table_eval")
    K11.launches += 1
    return out
