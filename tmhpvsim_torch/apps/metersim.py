"""``metersim`` on the port: the 1 Hz random electricity-demand producer
(own copy of the JAX package's apps/metersim.py).

The reference's behaviour: sample a uniform [0, 9000) W demand once per
second on the fixed-clock grid, queue it, and publish each value as a
JSON float to a fanout exchange with the measurement time as the
message's timestamp.  The publisher reconnects forever on broker
failures; on shutdown, queued values that were never sent are counted
and warned about.

Two producers feed the same publisher:

* the device producer (``backend='device'``, the default; the JAX
  package's ``--backend=jax``): K15 (kernels/meter.py) fills one
  ``block_s``-second block of the keyed stream per launch, from the root
  key of ``seed`` under ``prng_impl``, and the publisher drains it; on a
  CPU device the wrapper runs K15's plain version.  A run is
  deterministic per seed.
* ``backend='asyncio'``: the reference's per-second numpy producer (host
  code, as in the JAX package).
"""

from __future__ import annotations

import asyncio
import datetime as _dt
import logging
import time as _time
from typing import Optional

import numpy as np

from tmhpvsim_torch.obs import metrics as obs_metrics
from tmhpvsim_torch.runtime import fixedclock, reconnect_policy
from tmhpvsim_torch.runtime.broker import make_transport

logger = logging.getLogger(__name__)

#: the demand ceiling [W]: the reference's uniform [0, 9000)
METER_MAX_W = 9000.0
#: the producers of ``metersim_main``
BACKENDS = ("device", "asyncio")


def get_meter_value(rng: Optional[np.random.Generator] = None,
                    max_w: float = METER_MAX_W) -> float:
    """One uniform [0, max_w) demand sample."""
    rng = rng if rng is not None else np.random.default_rng()
    return float(max_w * rng.random())


async def read_meter_values(queue: asyncio.Queue, realtime: bool,
                            rng=None, duration_s=None,
                            start: Optional[_dt.datetime] = None) -> None:
    """The per-second producer: one (time, value) per clock tick."""
    rng = rng if rng is not None else np.random.default_rng()
    async for time in fixedclock(rate=1, realtime=realtime, start=start,
                                 duration_s=duration_s):
        await queue.put((time, get_meter_value(rng)))


def block_producer(seed: int, block_s: int = 600,
                   prng_impl: str = "threefry2x32", device="cuda"):
    """``block_vals(sec0) -> (block_s,)`` float64 numpy values: one K15
    launch on ``device`` (the card unless ``'cpu'``, where the wrapper
    runs its plain version) and the copy to the host, both on the calling
    thread's current stream.  Asking for CUDA where there is none raises.
    The root key is made on the first call, on an explicit device, in the
    caller's thread."""
    import torch

    from tmhpvsim_torch import rng
    from tmhpvsim_torch.engine.simulation import resolve_device
    from tmhpvsim_torch.kernels import meter as k15

    if block_s % 60:
        raise ValueError(f"block_s must be a multiple of 60, got {block_s}")
    dev = resolve_device(device)
    root = []

    def block_vals(sec0: int) -> np.ndarray:
        if not root:
            d = dev
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            root.append(rng.root_key(seed, prng_impl, d))
        v = k15.meter_block(root[0], sec0, block_s, METER_MAX_W, prng_impl)
        return v.cpu().numpy().astype(np.float64)

    return block_vals


async def read_meter_values_device(queue: asyncio.Queue, realtime: bool,
                                   seed=None, duration_s=None,
                                   start: Optional[_dt.datetime] = None,
                                   block_s: int = 600,
                                   prng_impl: str = "threefry2x32",
                                   device="cuda") -> None:
    """The device producer: one uniform [0, METER_MAX_W) value per
    fixed-clock tick into the queue, as :func:`read_meter_values`, drawn
    in ``block_s``-second blocks by K15 (the minute index counts from the
    run's start; a block is filled only when the previous one is used
    up).  Each block's launch and copy run in a worker thread: the first
    call builds the kernels (nvcc, tens of seconds cold), which must not
    freeze the event loop the publisher lives on.  ``seed=None`` draws
    one with ``secrets.randbits(31)``."""
    if start is None:
        start = _dt.datetime.now()
    start = start.replace(microsecond=0)
    if seed is None:
        import secrets

        seed = secrets.randbits(31)
    assert block_s % 60 == 0
    block_vals = block_producer(seed, block_s, prng_impl, device)
    m_blocks = obs_metrics.get_registry().counter("metersim.blocks_total")
    vals, i, sec = None, 0, 0
    async for time in fixedclock(rate=1, realtime=realtime, start=start,
                                 duration_s=duration_s):
        if vals is None or i == block_s:
            vals = await asyncio.to_thread(block_vals, sec)
            m_blocks.inc()
            i = 0
        await queue.put((time, float(vals[i])))
        i += 1
        sec += 1


async def send_queue_to_transport(queue: asyncio.Queue, url,
                                  exchange) -> None:
    """The publisher loop, reconnecting forever.

    A value dequeued when a publish fails is held across the reconnect and
    sent first, and ``task_done`` always matches its ``get``, so a bounded
    run's ``queue.join()`` cannot hang on a failed publish.  Each message
    carries, out of band, a ``seq`` and the publisher's monotonic publish
    time ``pub_us`` (microseconds; a held value keeps its seq and is
    stamped with the time it is actually sent)."""
    pending = None
    seq = 0
    m_pub = obs_metrics.get_registry().counter(
        "metersim.values_published_total")

    async def run():
        nonlocal pending, seq
        async with make_transport(url, exchange) as transport:
            while True:
                if pending is None:
                    time, value = await queue.get()
                    pending = (seq, time, value)
                    seq += 1
                n, time, value = pending
                meta = {"seq": n, "pub_us": _time.monotonic_ns() // 1000}
                await transport.publish(value, time, meta=meta)
                m_pub.inc()
                pending = None
                queue.task_done()

    await reconnect_policy(name="metersim.send_queue").call(run)


async def metersim_main(amqp_url, exchange, realtime, seed=None,
                        duration_s=None, start=None,
                        backend: str = "device", device="cuda") -> None:
    """The app: a producer task and the publisher task.  ``backend``
    'device' (K15 in 600-second threefry2x32 blocks on ``device``; 'cpu'
    runs its plain version) or 'asyncio' (the per-second numpy producer,
    the reference's); the
    publisher is the same.  A bounded run (``duration_s``) waits for the
    queue to drain before it stops the publisher."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    queue: asyncio.Queue = asyncio.Queue()
    if backend == "device":
        from tmhpvsim_torch.engine.simulation import resolve_device

        resolve_device(device)  # no card: raise before anything starts
        read = asyncio.create_task(read_meter_values_device(
            queue, realtime, seed, duration_s, start, device=device))
    else:
        read = asyncio.create_task(read_meter_values(
            queue, realtime, np.random.default_rng(seed), duration_s,
            start))
    send = asyncio.create_task(send_queue_to_transport(queue, amqp_url,
                                                       exchange))
    try:
        done, _ = await asyncio.wait({read, send},
                                     return_when=asyncio.FIRST_COMPLETED)
        for t in done:
            t.result()
        # a bounded run: wait for the queue to drain before stopping
        await queue.join()
    finally:
        for t in (read, send):
            t.cancel()
        if not queue.empty():
            logger.warning("%d sampled meter_values have not been sent",
                           queue.qsize())
