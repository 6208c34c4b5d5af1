"""The port's metersim against the JAX package's: K15's plain version
(models/clearsky_index.py ``meter_block``) bit for bit against
``jax.jit(ci.meter_block)`` under every key implementation, the kernel
wrapper on the CPU, both producers against the JAX producers, the
``metersim`` CLI, and the reference file's metersim section
(tests/test_torch_engine.py checks it).

K15 itself runs only on the card: tests/test_torch_kernels.py
``test_k15_matches_plain_on_card`` and chip_smoke.py's ``phase_k15``.
"""

import asyncio
import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmhpvsim_torch import kernels, rng
from tmhpvsim_torch.apps import metersim as tm
from tmhpvsim_torch.kernels import meter as k15
from tmhpvsim_torch.models import clearsky_index as tci
from tmhpvsim_tpu.apps import metersim as jm
from tmhpvsim_tpu.models import clearsky_index as jci

IMPLS = ("threefry2x32", "rbg", "unsafe_rbg")
SEC0 = (0, 600, 85800)
START = dt.datetime(2019, 9, 5, 10, 0, 0)
#: the reference file's metersim section: seed and blocks of the JAX
#: producer kept per key implementation (chip_smoke.py phase_k15 reads it)
REF_SEED = 7
REF_BLOCKS = 3
BLOCK_S = 600


def _jax_block(impl, seed, sec0, T):
    root = jax.random.key(seed, impl=impl)
    return np.asarray(jax.jit(
        lambda s: jci.meter_block(root, s + jnp.arange(T), jm.METER_MAX_W)
    )(sec0))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("T", [600, 60])
@pytest.mark.parametrize("impl", IMPLS)
def test_meter_block_plain_matches_jax(impl, T):
    """K15's plain version is jax's ``meter_block`` bit for bit: the
    minute keys' nesting (11 groups for 600 s), the batched draws of rbg
    and unsafe_rbg, the float32 multiply by 9000."""
    root = jax.random.key(3, impl=impl)
    f = jax.jit(lambda s: jci.meter_block(root, s + jnp.arange(T),
                                          jm.METER_MAX_W))
    key = rng.root_key(3, impl)
    for sec0 in SEC0:
        t = sec0 + torch.arange(T, dtype=torch.int64)
        got = tci.meter_block(key, t, jm.METER_MAX_W, impl)
        assert got.dtype == torch.float32 and got.shape == (T,)
        assert np.array_equal(_bits(got), _bits(f(sec0))), (impl, sec0)


def test_minute_grouped_keys_match_jax():
    """The minute keys and offsets, mid-minute alignment included."""
    for impl in IMPLS:
        t = 130 + torch.arange(600, dtype=torch.int64)
        keys, off = tci.minute_grouped_keys(rng.root_key(5, impl), t, impl)
        jk, joff = jci.minute_grouped_keys(jax.random.key(5, impl=impl),
                                           130 + jnp.arange(600))
        assert keys.shape[0] == 11
        assert np.array_equal(keys.numpy().astype(np.uint32),
                              np.asarray(jax.random.key_data(jk)))
        assert np.array_equal(off.numpy(), np.asarray(joff))


@pytest.mark.parametrize("impl", IMPLS)
def test_k15_wrapper_runs_plain_on_cpu(impl):
    """On a CPU key the wrapper is the plain version and counts no
    launch; a batch of keys, a negative start and a wrong key width are
    refused."""
    kernels.reset_counts()
    key = rng.root_key(9, impl)
    got = k15.meter_block(key, 1200, 600, 9000.0, impl)
    want = tci.meter_block(key, 1200 + torch.arange(600), 9000.0, impl)
    assert torch.equal(got, want)
    assert k15.K15.launches == 0 and "meter_block" in kernels.counts()
    with pytest.raises(ValueError):
        k15.meter_block(key[None], 0, 600, 9000.0, impl)
    with pytest.raises(ValueError):
        k15.meter_block(key, -60, 600, 9000.0, impl)
    with pytest.raises(ValueError):
        k15.meter_block(key[:1], 0, 600, 9000.0, impl)


#: seconds a test's event loop may run before the test fails (a hang
#: fails its test, not the run)
LOOP_TIMEOUT_S = 120


def _arun(coro):
    return asyncio.run(asyncio.wait_for(coro, LOOP_TIMEOUT_S))


def _collect(fn, *args, **kw):
    async def go():
        q = asyncio.Queue()
        await fn(q, *args, **kw)
        return [q.get_nowait() for _ in range(q.qsize())]

    return _arun(go())


@pytest.mark.parametrize("impl", IMPLS)
def test_device_producer_matches_jax(impl):
    """The device producer on the CPU (K15's plain version) gives the
    values of the JAX ``read_meter_values_jax`` over 1800 s: three
    blocks, each filled when the previous one is used up."""
    kw = dict(seed=11, duration_s=1800, start=START, prng_impl=impl)
    want = _collect(jm.read_meter_values_jax, False, **kw)
    got = _collect(tm.read_meter_values_device, False, device="cpu", **kw)
    assert len(got) == 1800 and got == want
    assert got[0][0] == START and got[-1][0] == START + dt.timedelta(
        seconds=1799)
    assert all(0.0 <= v < tm.METER_MAX_W for _, v in got)


def test_numpy_producer_matches_jax():
    kw = dict(duration_s=1800, start=START)
    want = _collect(jm.read_meter_values, False,
                    rng=np.random.default_rng(4), **kw)
    got = _collect(tm.read_meter_values, False,
                   rng=np.random.default_rng(4), **kw)
    assert len(got) == 1800 and got == want
    assert tm.get_meter_value(np.random.default_rng(1)) == \
        jm.get_meter_value(np.random.default_rng(1))


def test_device_producer_needs_the_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.block_producer(1)
    with pytest.raises(ValueError, match="multiple of 60"):
        tm.block_producer(1, block_s=90, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        _arun(tm.metersim_main("local://none", "meter", False, 1, 60))
    with pytest.raises(ValueError, match="backend"):
        _arun(tm.metersim_main("local://none", "meter", False, 1, 60,
                               backend="jax"))


@pytest.mark.parametrize("backend", ["device", "asyncio"])
def test_metersim_main_publishes_every_second(backend):
    """A bounded run publishes every value (the queue drains before the
    publisher stops), each with its seq and publish time out of band; the
    device backend's values are the JAX device producer's."""
    from tmhpvsim_torch.runtime.broker import LocalTransport

    url = f"local://metersim-{backend}"

    async def go():
        got = []

        async def consume():
            async with LocalTransport(url, "meter") as t:
                async for item in t.subscribe(with_meta=True):
                    got.append(item)

        task = asyncio.create_task(consume())
        await asyncio.sleep(0.01)
        await tm.metersim_main(url, "meter", False, 5, 1260, START,
                               backend=backend, device="cpu")
        await asyncio.sleep(0.01)
        task.cancel()
        return got

    got = _arun(go())
    assert len(got) == 1260
    assert [m["seq"] for _, _, m in got] == list(range(1260))
    assert all(isinstance(m["pub_us"], int) for _, _, m in got)
    values = [(t, v) for t, v, _ in got]
    if backend == "device":
        assert values == _collect(jm.read_meter_values_jax, False, seed=5,
                                  duration_s=1260, start=START)
    else:
        assert values == _collect(jm.read_meter_values, False,
                                  rng=np.random.default_rng(5),
                                  duration_s=1260, start=START)


def test_metersim_cli(capsys):
    """``metersim --device cpu`` over local:// runs to its end; without a
    card the default raises; the waiting flags and a compile cache
    without the device backend are usage errors."""
    from tmhpvsim_torch.cli import main as cli

    assert cli(["metersim", "--device", "cpu", "--no-realtime",
                "--duration", "120", "--seed", "1", "--amqp-url",
                "local://cli"]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            cli(["metersim", "--no-realtime", "--duration", "60"])
    with pytest.raises(SystemExit):
        cli(["metersim", "--backend", "asyncio", "--compile-cache", "x"])
    assert "--compile-cache requires --backend=device" in \
        capsys.readouterr().err


def jax_reference_blocks() -> dict:
    """The JAX producer's first REF_BLOCKS blocks at REF_SEED for each key
    implementation, as the reference file keeps them: the SHA-256 of the
    float32 values' little-endian bytes (a bit-for-bit check in a few
    bytes of the size-capped file) and the first values of each block."""
    import hashlib

    out = {"seed": REF_SEED, "block_s": BLOCK_S, "blocks": REF_BLOCKS}
    for impl in IMPLS:
        vals = np.concatenate([_jax_block(impl, REF_SEED, b * BLOCK_S,
                                          BLOCK_S)
                               for b in range(REF_BLOCKS)]).astype("<f4")
        out[impl] = {
            "sha256": hashlib.sha256(vals.tobytes()).hexdigest(),
            "head": [[float(np.format_float_positional(x, unique=True,
                                                       trim="-"))
                      for x in vals[b * BLOCK_S:b * BLOCK_S + 4]]
                     for b in range(REF_BLOCKS)]}
    return out


def test_reference_blocks_digest_the_port_values():
    """The digest the card checks K15 against is the plain version's too:
    the same three blocks through the CPU wrapper hash to it."""
    import hashlib

    ref = jax_reference_blocks()
    for impl in IMPLS:
        key = rng.root_key(REF_SEED, impl)
        vals = torch.cat([k15.meter_block(key, b * BLOCK_S, BLOCK_S,
                                          tm.METER_MAX_W, impl)
                          for b in range(REF_BLOCKS)]).numpy().astype("<f4")
        assert hashlib.sha256(vals.tobytes()).hexdigest() == \
            ref[impl]["sha256"], impl
