"""K11's plain version (tmhpvsim_torch/models/tables.py, the table
transcendentals) against the JAX package's, on the CPU.

Tolerances, per function: every table kernel is bit-identical to the JAX
package's jitted ``table_kernels(jnp)`` function on 10**4 seeded arguments
over ``ARG_RANGES`` (0 ULP), in x32 and in the suite's x64: the port
writes a multiply-add exactly where float32 XLA contracts one (read off
the jitted functions; tests/test_torch_stride.py does the same for the
strided lerp).  Against a float64 reference each stays within its
published ``MAX_ULP``.  The site geometry with the table set agrees with
the JAX package's within the bounds tests/test_torch_models.py holds the
exact set's to (``GEOM_BOUNDS``: absolute, relative for the airmass and
the csi cap, under daylight): the polynomials match bit for bit, the
arithmetic around them is the exact set's, where float32 XLA contracts
other multiply-adds that the port rounds twice (the engine tolerance
covers it, tests/test_torch_stride.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmhpvsim_torch.kernels import tables as k11
from tmhpvsim_torch.models import solar as tsolar
from tmhpvsim_torch.models import tables as tt
from tmhpvsim_tpu.models import solar as jsolar
from tmhpvsim_tpu.models import tables as jt
from test_torch_threads import one_torch_thread  # noqa: F401

N = 10_000
FUNCS = ("sin", "cos", "tan", "arcsin", "arccos", "arctan2", "exp", "log",
         "spencer_factor")
#: the exponents powc takes in the models (Kasten-Young, Kasten 1966) and
#: the ends of the published range
POWC_EXPONENTS = (-1.6364, -1.253, -1.7, -0.1)
#: the site geometry (table set) against the JAX package's, where the sun
#: is up (zenith < 88 deg): the exact set's bounds (tests/test_torch_models
#: .py); relative for the airmass and the csi cap, absolute otherwise
GEOM_BOUNDS = {"zenith": 4e-4, "cos_zenith": 4e-4, "apparent_zenith": 4e-4,
               "cos_aoi": 4e-4, "ghi_clear": 1.0, "csi_cap": 1e-3,
               "dni_extra": 1e-3, "airmass_abs": 1e-3}


def _args(name, seed=0, n=N):
    gen = np.random.default_rng(seed)
    if name == "arctan2":
        return tuple(gen.uniform(-1e3, 1e3, n).astype(np.float32)
                     for _ in range(2))
    lo, hi = tt.ARG_RANGES[name]
    if name == "log":
        x = np.exp(gen.uniform(np.log(lo), np.log(hi), n))
    elif name == "spencer_factor":
        x = gen.integers(int(lo), int(hi) + 1, n)
    else:
        x = gen.uniform(lo, hi, n)
    return (x.astype(np.float32),)


def _port(name, args, p=None):
    ts = tuple(torch.from_numpy(a) for a in args)
    if name == "powc":
        return tt.TABLE.powc(ts[0], p).numpy()
    return getattr(tt.TABLE, name)(*ts).numpy()


def _jax(name, args, p=None):
    k = jt.table_kernels(jnp)
    if name == "powc":
        return np.asarray(jax.jit(lambda x: k.powc(x, p))(*args))
    return np.asarray(jax.jit(getattr(k, name))(*args))


@pytest.fixture(params=[False, True], ids=["x32", "x64"])
def x64(request):
    with jax.enable_x64(request.param):
        yield request.param


@pytest.mark.parametrize("name", FUNCS)
def test_table_kernel_bit_identical_to_jax(name, x64):
    args = _args(name)
    got, want = _port(name, args), _jax(name, args)
    assert want.dtype == np.float32 and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("p", POWC_EXPONENTS)
def test_powc_bit_identical_to_jax(p, x64):
    args = _args("powc", seed=1)
    got, want = _port("powc", args, p), _jax("powc", args, p)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _ulp_err(got, ref64):
    """Error in float32 ULPs at the float64 reference, floored at one ULP
    of 1.0 (how MAX_ULP is published)."""
    ulp = np.maximum(np.spacing(np.abs(ref64).astype(np.float32)),
                     np.spacing(np.float32(1.0)))
    return np.abs(np.asarray(got, np.float64) - ref64) / ulp


@pytest.mark.parametrize("name", sorted(tt.MAX_ULP))
def test_table_kernel_within_published_bound(name):
    if name == "powc":
        (x,) = _args("powc", seed=2)
        err = np.concatenate([_ulp_err(_port("powc", (x,), p),
                                       x.astype(np.float64) ** p)
                              for p in POWC_EXPONENTS])
    elif name == "spencer_factor":
        doy = np.arange(1, 367, dtype=np.float32)
        err = _ulp_err(_port(name, (doy,)), tt._spencer_factor64(doy))
    else:
        args = _args(name, seed=2)
        ref = getattr(np, name)(*(a.astype(np.float64) for a in args))
        err = _ulp_err(_port(name, args), ref)
    assert float(err.max()) <= tt.MAX_ULP[name]


def test_published_tables_equal_jax():
    assert tt.MAX_ULP == jt.MAX_ULP
    assert tt.ARG_RANGES == jt.ARG_RANGES
    np.testing.assert_array_equal(tt.SPENCER_LUT.view(np.int32),
                                  jt.SPENCER_LUT.view(np.int32))


def test_exact_set_is_the_torch_ops():
    k = tt.exact_kernels()
    assert k.sin is torch.sin and k.exp is torch.exp
    assert k.arctan2 is torch.atan2 and k.spencer_factor is None
    assert tt.get_kernels("exact") is k
    assert tt.get_kernels("table") is tt.table_kernels()
    with pytest.raises(ValueError, match="kernel_impl"):
        tt.get_kernels("fast")


def test_frexp_matches_jnp():
    gen = np.random.default_rng(3)
    x = np.concatenate([
        np.exp(gen.uniform(-80, 80, N)) * gen.choice([-1, 1], N),
        [0.0, -0.0, np.inf, -np.inf, 1.0, 0.5, 2.0 ** -126]]
    ).astype(np.float32)
    m, e = tt.frexp(torch.from_numpy(x))
    jm, je = jnp.frexp(jnp.asarray(x))
    np.testing.assert_array_equal(m.numpy().view(np.int32),
                                  np.asarray(jm).view(np.int32))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))


def test_table_eval_cpu_is_the_plain_version():
    k11.K11.launches = 0
    for name in k11.FUNCS:
        args = _args(name, seed=4, n=257)
        x = torch.from_numpy(args[0])
        y = torch.from_numpy(args[1]) if name == "arctan2" else None
        p = -1.253 if name == "powc" else None
        assert torch.equal(k11.table_eval(name, x, y, p),
                           k11.table_eval_plain(name, x, y, p))
    assert k11.K11.launches == 0
    with pytest.raises(ValueError):
        k11.table_eval("sin", torch.zeros(3), torch.zeros(3))


def test_kernel_constants_are_the_plain_coefficients():
    c = k11.kernel_constants()
    assert c["TB_EXP_P"] == list(tt.EXP_P)
    assert c["TB_ACOS_P"] == list(tt.ACOS_P)
    assert len(c["SPENCER_LUT"]) == 366
    assert all(float(np.float32(v)) == v for v in c["SPENCER_LUT"])


def test_device_geometry_table_set_against_jax():
    """The site geometry with the table set, 64 sites from the equator to
    70 N over a day's hours, against the JAX package's jitted one."""
    gen = np.random.default_rng(5)
    n = 64
    site = {"latitude": gen.uniform(-60, 70, n),
            "longitude": gen.uniform(-170, 170, n),
            "altitude": gen.uniform(0, 2000, n),
            "surface_tilt": gen.uniform(0, 60, n),
            "surface_azimuth": gen.uniform(90, 270, n),
            "albedo": np.full(n, 0.25)}
    site = {k: v.astype(np.float32) for k, v in site.items()}
    epoch = 1567663200 + np.arange(0, 86400, 600)
    day = (epoch // 86400 - 10957).astype(np.float32)[:, None]
    sec = (epoch % 86400).astype(np.float32)[:, None]
    doy = np.full_like(day, 248.0)
    turb = np.full(12, 3.5, np.float32)
    names = ("latitude", "longitude", "altitude", "surface_tilt",
             "surface_azimuth", "albedo")
    with jax.enable_x64(False):
        want = jax.jit(lambda d, s, y, *a: jsolar.device_geometry(
            d, s, y, *a, turb, xp=jnp, kernels=jt.table_kernels(jnp)))(
            day, sec, doy, *(site[k] for k in names))
    got = tsolar.device_geometry(
        torch.from_numpy(day), torch.from_numpy(sec), torch.from_numpy(doy),
        *(torch.from_numpy(site[k]) for k in names),
        torch.from_numpy(turb), kernels=tt.table_kernels())
    day_ = np.asarray(want["zenith"]) < np.radians(88.0)
    assert day_.mean() > 0.3
    for k, bound in GEOM_BOUNDS.items():
        w = np.broadcast_to(np.asarray(want[k], np.float64), day_.shape)
        g = np.broadcast_to(got[k].numpy().astype(np.float64), day_.shape)
        err = np.abs(g - w) / (np.abs(w) if k in ("airmass_abs", "csi_cap")
                               else 1.0)
        assert err[day_].max() < bound, (k, err[day_].max())
        assert np.isfinite(g).all(), k
