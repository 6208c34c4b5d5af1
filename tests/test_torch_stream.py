"""The port's streaming deployment against the JAX package's: the runtime
copies (fixed clock, funnel, retries, the fanout transports) through the
scenarios of tests/test_runtime.py, tests/test_tcpbroker.py and
tests/test_amqp.py (each run on both packages' copies where it has an
outcome to compare), the metersim -> broker -> pvsim pair against the JAX
pair row for row, the three-process tcp:// deployment across timezones,
the run report of ``pvsim --backend asyncio``, and the usage errors of
the flags that wait.
"""

import asyncio
import csv
import datetime as dt
import json
import os
import subprocess
import sys
import time
from collections import namedtuple

import pytest

from test_amqp import FakeMessage, FakeQueue, fake_aio_pika  # noqa: F401
from tmhpvsim_torch.apps import metersim as tmeter
from tmhpvsim_torch.apps import pvsim as tpv
from tmhpvsim_torch.obs import metrics as tmetrics
from tmhpvsim_torch.obs.report import validate_report
from tmhpvsim_torch.runtime import asyncrun as t_asyncrun
from tmhpvsim_torch.runtime import broker as tbroker
from tmhpvsim_torch.runtime import clock as tclock
from tmhpvsim_torch.runtime import funnel as tfunnel
from tmhpvsim_torch.runtime import resilience as tres
from tmhpvsim_torch.runtime import tcpbroker as ttcp
from tmhpvsim_tpu.apps import metersim as jmeter
from tmhpvsim_tpu.apps import pvsim as jpv
from tmhpvsim_tpu.obs.report import validate_report as j_validate_report
from tmhpvsim_tpu.runtime import broker as jbroker
from tmhpvsim_tpu.runtime import clock as jclock
from tmhpvsim_tpu.runtime import funnel as jfunnel
from tmhpvsim_tpu.runtime import resilience as jres
from tmhpvsim_tpu.runtime import tcpbroker as jtcp
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Data = namedtuple("Data", ["meter", "pv"])
START = dt.datetime(2019, 9, 5, 10, 0, 0)
#: (JAX package, port) copies of each runtime module
PKGS = {"jax": dict(clock=jclock, funnel=jfunnel, res=jres, broker=jbroker,
                    tcp=jtcp),
        "torch": dict(clock=tclock, funnel=tfunnel, res=tres,
                      broker=tbroker, tcp=ttcp)}


#: seconds a test's event loop may run before the test fails (a hang
#: fails its test, not the run)
LOOP_TIMEOUT_S = 120


def _run(coro):
    return asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(coro, LOOP_TIMEOUT_S))


def _both(scenario):
    """``scenario(modules)`` on the JAX package's copies, then the port's;
    returns the port's outcome after asserting the two are equal."""
    want = scenario(PKGS["jax"])
    got = scenario(PKGS["torch"])
    assert got == want
    return got


# --------------------------------------------------------------------------
# the fixed clock
# --------------------------------------------------------------------------


def test_fixedclock_grid():
    """The ideal start + i/rate grid, at 1 Hz and 4 Hz; no floor sleep
    without realtime (1000 ticks well under a second)."""

    def scenario(m):
        async def collect(rate, n):
            return [t async for t in m["clock"].fixedclock(
                rate=rate, realtime=False, start=START, duration_s=n)]

        t0 = time.perf_counter()
        many = _run(collect(1, 1000))
        fast = time.perf_counter() - t0 < 2.0
        return _run(collect(1, 5)), _run(collect(4, 1)), len(many), fast

    ones, quarters, n, fast = _both(scenario)
    assert ones == [START + dt.timedelta(seconds=s) for s in range(5)]
    assert len(quarters) == 4 and \
        quarters[1] - quarters[0] == dt.timedelta(seconds=0.25)
    assert n == 1000 and fast


def test_pacing_monitor_rate_limits_and_records_slip():
    def scenario(m):
        reg = (tmetrics.MetricsRegistry() if m is PKGS["torch"] else None)
        if reg is None:
            from tmhpvsim_tpu.obs import metrics as jm

            reg, use = jm.MetricsRegistry(), jm.use_registry
        else:
            use = tmetrics.use_registry
        with use(reg):
            mon = m["clock"].PacingMonitor(1.0, warn_every_s=10.0)
            warned = [mon.observe(b, now=t) for b, t in
                      ((0.5, 0.0), (3.0, 1.0), (4.0, 2.0), (1.0, 3.0),
                       (5.0, 12.0))]
        snap = reg.snapshot()["gauges"]
        return warned, snap["clock.pacing_lag_s"], \
            snap["clock.pacing_slip_total_s"]

    warned, lag, slip = _both(scenario)
    assert warned == [False, True, False, False, True]
    assert lag == 5.0 and slip == 8.0


# --------------------------------------------------------------------------
# the funnel: join, eviction, backpressure
# --------------------------------------------------------------------------


def test_funnel_join_and_order():
    def scenario(m):
        async def go():
            out = asyncio.Queue()
            f = m["funnel"].SynchronizingFunnel(Data, out)
            await f.put(1, meter=5.0)
            first = (out.qsize(), len(f))
            await f.put(1, pv=2.0)
            await f.put(3, meter=1.0)
            await f.put(2, meter=2.0)
            await f.put(2, pv=0.5)
            await f.put(3, pv=0.25)
            return first, [out.get_nowait() for _ in range(out.qsize())]

        return _run(go())

    first, emitted = _both(scenario)
    assert first == (0, 1)
    assert [t for t, _ in emitted] == [1, 2, 3]  # completion order
    assert tuple(emitted[0][1]) == (5.0, 2.0)


def test_funnel_eviction_bounds_cache():
    def scenario(m):
        async def go():
            f = m["funnel"].SynchronizingFunnel(Data, asyncio.Queue(),
                                                max_pending=100)
            for t in range(500):
                await f.put(t, meter=float(t))
            evicted_oldest = min(f._cache)
            f2 = m["funnel"].SynchronizingFunnel(Data, asyncio.Queue(),
                                                 max_pending=3)
            for t in range(3):
                await f2.put(t, meter=float(t))
            f2._age_heap.clear()  # a broken heap invariant is rebuilt
            await f2.put(3, meter=3.0)
            return (len(f), f.n_evicted, evicted_oldest, sorted(f2._cache),
                    f2.n_evicted)

        return _run(go())

    assert _both(scenario) == (100, 400, 400, [1, 2, 3], 1)


def test_funnel_backpressure_bounds_lookahead():
    """A producer blocks once it is max_lookahead past the slowest other
    stream (its value delivered first) and resumes as that stream
    advances."""

    def scenario(m):
        async def go():
            out = asyncio.Queue()
            f = m["funnel"].SynchronizingFunnel(Data, out, max_lookahead=2,
                                                stall_timeout_s=30.0)
            await f.put(0, meter=1.0)

            async def pv():
                for t in range(6):
                    await f.put(t, pv=float(t))

            task = asyncio.ensure_future(pv())
            await asyncio.sleep(0.05)
            blocked = (task.done(), len(f) >= 3)
            await f.put(1, meter=2.0)
            await asyncio.sleep(0.05)
            await f.put(4, meter=3.0)
            await asyncio.wait_for(task, timeout=5)
            return blocked, out.qsize()

        return _run(go())

    assert _both(scenario) == ((False, True), 3)


def test_funnel_initial_pending_cap_and_stall():
    """Before the other stream's first value a producer may pile up
    max_initial_pending records; a stream that goes silent is given up
    after stall_timeout_s (free run), not waited on forever."""

    def scenario(m):
        async def capped():
            out = asyncio.Queue()
            f = m["funnel"].SynchronizingFunnel(
                Data, out, max_lookahead=100, stall_timeout_s=30.0,
                max_initial_pending=5)

            async def pv():
                for t in range(20):
                    await f.put(t, pv=float(t))

            task = asyncio.ensure_future(pv())
            await asyncio.sleep(0.05)
            held = (task.done(), len(f))
            await f.put(0, meter=1.0)
            await asyncio.wait_for(task, timeout=5)
            return held, out.qsize()

        async def stalled():
            out = asyncio.Queue()
            f = m["funnel"].SynchronizingFunnel(Data, out, max_lookahead=2,
                                                stall_timeout_s=0.05)
            await f.put(0, meter=1.0)
            t0 = time.perf_counter()
            for t in range(50):
                await f.put(t, pv=float(t))
            return out.qsize(), time.perf_counter() - t0 < 1.0

        return _run(capped()), _run(stalled())

    assert _both(scenario) == (((False, 6), 1), (1, True))
    with pytest.raises(ValueError, match="max_initial_pending"):
        tfunnel.SynchronizingFunnel(Data, asyncio.Queue(), max_pending=10,
                                    max_initial_pending=10)


# --------------------------------------------------------------------------
# retries
# --------------------------------------------------------------------------


def test_asyncretry_semantics():
    """Retries until success, re-raises on exhaustion, applies a fallback
    value, never retries a cancellation."""

    def scenario(m):
        retry, forever = m["res"].asyncretry, m["res"].forever
        calls = []

        @retry(attempts=5, delay=0)
        async def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("down")
            return "up"

        @retry(attempts=2, delay=0)
        async def bad():
            raise ValueError("nope")

        @retry(attempts=1, delay=0, fallback=42)
        async def fb():
            raise ValueError

        loops = []

        async def cancelled():
            @retry(attempts=forever, delay=0)
            async def sleeper():
                loops.append(1)
                await asyncio.sleep(3600)

            task = asyncio.ensure_future(sleeper())
            await asyncio.sleep(0.01)
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                return "cancelled"

        with pytest.raises(ValueError):
            _run(bad())
        return (_run(flaky()), len(calls), _run(fb()), _run(cancelled()),
                len(loops))

    assert _both(scenario) == ("up", 3, 42, "cancelled", 1)


def test_reconnect_policy_and_breaker_refusal():
    p = tres.reconnect_policy(name="x")
    assert p.attempts is tres.forever and (p.base_delay_s, p.max_delay_s) \
        == (0.5, 5.0)
    prev = p.base_delay_s
    for _ in range(20):
        prev = p.backoff(prev)
        assert 0.5 <= prev <= 5.0
    fixed = tres.ResiliencePolicy(base_delay_s=0.1, max_delay_s=1.0,
                                  jitter=False)
    assert [fixed.backoff(d) for d in (0.0, 0.1, 3.0)] == [0.1] * 3
    br = tres.CircuitBreaker("t", failure_threshold=1, reset_s=60.0,
                             registry=tmetrics.MetricsRegistry())
    br.record_failure()
    pol = tres.ResiliencePolicy(attempts=3, breaker=br)

    async def ok():
        return 1

    with pytest.raises(tres.BreakerOpenError, match="open"):
        _run(pol.call(ok))
    assert issubclass(tres.BreakerOpenError, ConnectionError)


def test_asyncrun_returns_and_cancels():
    async def value():
        return 7

    async def cancelled():
        asyncio.current_task().cancel()
        await asyncio.sleep(1)

    assert t_asyncrun(value()) == 7
    assert t_asyncrun(cancelled()) is None


# --------------------------------------------------------------------------
# the fanout transports
# --------------------------------------------------------------------------


def test_local_fanout_and_transport_choice():
    def scenario(m):
        async def go():
            url = f"local://stream-{id(m)}"
            pub = m["broker"].LocalTransport(url, "meter")
            subs = [m["broker"].LocalTransport(url, "meter")
                    for _ in range(2)]
            got = [[], []]

            async def consume(i):
                async for t, v in subs[i].subscribe():
                    got[i].append((t, v))
                    if len(got[i]) == 3:
                        return

            tasks = [asyncio.create_task(consume(i)) for i in range(2)]
            await asyncio.sleep(0.01)
            for k in range(3):
                await pub.publish(float(k), START + dt.timedelta(seconds=k))
            await asyncio.gather(*tasks)
            return got

        return _run(go())

    got = _both(scenario)
    assert got[0] == got[1] == [(START + dt.timedelta(seconds=k), float(k))
                                for k in range(3)]
    assert isinstance(tbroker.make_transport(None, "m"),
                      tbroker.LocalTransport)
    assert isinstance(tbroker.make_transport("tcp://h:1", "m"),
                      ttcp.TcpTransport)
    with pytest.raises(RuntimeError, match="aio_pika"):
        tbroker.make_transport("amqp://localhost:5672/", "meter")


def _tcp_consume(m, url, exchange, n, with_meta=False):
    async def consume():
        out = []
        async with m["tcp"].TcpTransport(url, exchange) as t:
            async for item in t.subscribe(with_meta=with_meta):
                out.append(item)
                if len(out) == n:
                    return out

    return asyncio.create_task(consume())


TCP_TIMES = [dt.datetime(2019, 9, 5, 12, 0, 0, 1),
             dt.datetime(2019, 9, 5, 12, 0, 0, 333333),
             dt.datetime(2038, 1, 19, 3, 14, 7, 999999),
             dt.datetime(1969, 12, 31, 23, 59, 59, 7)]


def test_tcp_fanout_exact_times_and_isolation():
    """Two subscribers each get the whole stream, sub-second and negative
    epoch times come back exactly, meta rides along, and a subscriber of
    exchange A never sees exchange B."""

    def scenario(m):
        async def main():
            async with m["tcp"].TcpFanoutBroker(port=0) as b:
                url = f"tcp://127.0.0.1:{b.port}"
                c1 = _tcp_consume(m, url, "meter", 4, with_meta=True)
                c2 = _tcp_consume(m, url, "meter", 4)
                other = _tcp_consume(m, url, "other", 1)
                await asyncio.sleep(0.1)
                async with m["tcp"].TcpTransport(url, "meter") as pub, \
                        m["tcp"].TcpTransport(url, "other") as pb:
                    await pb.publish(42.0, START)
                    for i, t in enumerate(TCP_TIMES):
                        await pub.publish(100.0 + i, t,
                                          meta={"seq": i} if i else None)
                return await c1, await c2, await other

        return _run(main())

    r1, r2, other = _both(scenario)
    assert [(t, v) for t, v, _ in r1] == r2
    assert [t for t, _ in r2] == TCP_TIMES
    assert [m for _, _, m in r1] == [None, {"seq": 1}, {"seq": 2},
                                     {"seq": 3}]
    assert other == [(START, 42.0)]


def test_tcp_wire_interoperates_with_the_jax_broker():
    """The port's client on the JAX package's broker and the JAX client
    on the port's: the same frames."""

    async def main(server, client):
        async with server.TcpFanoutBroker(port=0) as b:
            url = f"tcp://127.0.0.1:{b.port}"
            sub = _tcp_consume({"tcp": client}, url, "meter", 2)
            await asyncio.sleep(0.1)
            async with client.TcpTransport(url, "meter") as pub:
                await pub.publish(1.5, TCP_TIMES[1])
                await pub.publish(2.5, TCP_TIMES[3])
            return await sub

    want = [(TCP_TIMES[1], 1.5), (TCP_TIMES[3], 2.5)]
    assert _run(main(jtcp, ttcp)) == want
    assert _run(main(ttcp, jtcp)) == want


def test_tcp_disconnects_stop_and_dead_broker():
    """Publishing survives a departed subscriber; stop() returns with a
    live subscriber connected; a dead broker raises for the reconnect
    loop."""

    async def main():
        async with ttcp.TcpFanoutBroker(port=0) as b:
            url = f"tcp://127.0.0.1:{b.port}"
            one = _tcp_consume(PKGS["torch"], url, "meter", 1)
            await asyncio.sleep(0.1)
            async with ttcp.TcpTransport(url, "meter") as pub:
                await pub.publish(1.0, START)
                assert await one == [(START, 1.0)]
                await asyncio.sleep(0.1)
                await pub.publish(2.0, START)
            assert not b._exchanges.get("meter")
        broker = ttcp.TcpFanoutBroker(port=0)
        await broker.start()
        url = f"tcp://127.0.0.1:{broker.port}"
        parked = _tcp_consume(PKGS["torch"], url, "meter", 10)
        await asyncio.sleep(0.1)
        await asyncio.wait_for(broker.stop(), timeout=5)
        with pytest.raises((ConnectionError, asyncio.IncompleteReadError,
                            OSError)):
            await asyncio.wait_for(parked, timeout=5)
        with pytest.raises(OSError):
            async with ttcp.TcpTransport(url, "meter"):
                pass
        return True

    assert _run(main())


def test_tcp_subscriber_backlog_drops_oldest():
    reg = tmetrics.MetricsRegistry()
    with tmetrics.use_registry(reg):
        sub = ttcp._Subscriber(writer=None, max_backlog=2)
        for i in range(5):
            sub.offer(b"%d\n" % i)
        assert sub.n_dropped == 3
        assert [sub.queue.get_nowait() for _ in range(2)] == [b"3\n",
                                                              b"4\n"]
        sub.offer(b"5\n")
        sub.unregistered()
    snap = reg.snapshot()
    assert snap["counters"]["tcpbroker.dropped_total"] == 3
    assert snap["gauges"]["tcpbroker.backlog_depth"] == 2  # 5 - 3 drained


# --------------------------------------------------------------------------
# AMQP, against the fake aio_pika of tests/test_amqp.py
# --------------------------------------------------------------------------


def test_amqp_topology_and_wire_format(fake_aio_pika):  # noqa: F811
    mod, log = fake_aio_pika
    assert isinstance(tbroker.make_transport("amqp://h:5672/", "meter"),
                      tbroker.AmqpTransport)
    captured = FakeQueue(exclusive=True, log=log)

    async def scenario():
        async with tbroker.AmqpTransport("amqp://host/", "meter") as t:
            t._exchange.queues.append(captured)
            await t.publish(4321.25, START)

    _run(scenario())
    assert ("connect", "amqp://host/") in log
    assert ("declare_exchange", "meter", "fanout") in log
    assert ("publish", "meter", "") in log and ("close",) in log
    msg = captured._items.get_nowait()
    assert json.loads(msg.body.decode()) == 4321.25
    assert msg.timestamp == START and msg.headers is None


def test_amqp_consumer_meta_and_posix_time(fake_aio_pika):  # noqa: F811
    """Prefetch 1 on an exclusive queue bound to the exchange; meta in the
    headers (None without); a POSIX-seconds timestamp read as a naive
    local datetime."""
    mod, log = fake_aio_pika
    got = []

    async def scenario():
        async with tbroker.AmqpTransport("amqp://host/", "meter") as pub:
            async with tbroker.AmqpTransport("amqp://host/",
                                             "meter") as sub:
                async def consume():
                    async for item in sub.subscribe(with_meta=True):
                        got.append(item)
                        if len(got) == 3:
                            return

                task = asyncio.ensure_future(consume())
                await asyncio.sleep(0)
                await pub.publish(100.0, START, meta={"seq": 0, "pub_us": 5})
                await pub.publish(200.5, START)
                ex = mod._connections[0]._channel.exchanges["meter"]
                await ex.publish(FakeMessage(json.dumps(42.0).encode(),
                                             timestamp=START.timestamp()))
                await asyncio.wait_for(task, timeout=5)

    _run(scenario())
    assert ("set_qos", 1) in log and ("declare_queue", True) in log
    assert ("bind", "meter", True) in log
    assert got == [(START, 100.0, {"seq": 0, "pub_us": 5}),
                   (START, 200.5, None), (START, 42.0, None)]


def test_apps_join_over_fake_amqp(fake_aio_pika, tmp_path):  # noqa: F811
    out = tmp_path / "amqp.csv"

    async def both():
        consumer = asyncio.ensure_future(tpv.pvsim_main(
            str(out), "amqp://host/", "meter", False, 1, None, START))
        await asyncio.sleep(0.2)
        await tmeter.metersim_main("amqp://host/", "meter", False, 2, 20,
                                   START, device="cpu")
        await asyncio.sleep(0.3)
        consumer.cancel()
        try:
            await consumer
        except asyncio.CancelledError:
            pass

    _run(both())
    rows = _rows(out)
    assert len(rows) > 10
    for _, meter, pv, residual in rows:
        assert float(meter) - float(pv) == float(residual)


# --------------------------------------------------------------------------
# the pair: metersim -> broker -> pvsim
# --------------------------------------------------------------------------


def _rows(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["time", "meter", "pv", "residual load"]
    return rows[1:]


def run_pair(pv_main, meter_main, out, url, duration_s, report=None,
             **meter_kw):
    """pvsim (seed 1, unbounded) and metersim (seed 2, ``duration_s``
    seconds from START) in one event loop; pvsim is stopped once every
    published second is joined or a deadline passes."""

    async def both():
        kw = {"run_report_path": report} if report else {}
        consumer = asyncio.ensure_future(pv_main(
            str(out), url, "meter", False, 1, None, START, **kw))
        await asyncio.sleep(0.2)
        await meter_main(url, "meter", False, 2, duration_s, START,
                         **meter_kw)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            await asyncio.sleep(0.02)
            with open(out) as f:
                if sum(1 for _ in f) > duration_s:
                    break
        consumer.cancel()
        try:
            await consumer
        except asyncio.CancelledError:
            pass

    _run(both())
    return _rows(out)


@pytest.mark.parametrize("backends", [("jax", "device"),
                                      ("asyncio", "asyncio")],
                         ids=["device", "asyncio"])
def test_pair_rows_equal_jax_pair(tmp_path, backends):
    """The port's pair writes the JAX pair's rows, as equal strings, on
    every timestamp both join (300 s over local://, the same seeds): the
    device producer against the JAX ``--backend jax`` one, the numpy one
    against the JAX numpy one; both golden PV models are float64 numpy
    from one seeded generator."""
    jb, tb = backends
    want = run_pair(jpv.pvsim_main, jmeter.metersim_main,
                    tmp_path / "j.csv", f"local://jpair-{jb}", 300,
                    backend=jb)
    got = run_pair(tpv.pvsim_main, tmeter.metersim_main,
                   tmp_path / "t.csv", f"local://tpair-{tb}", 300,
                   backend=tb, device="cpu")
    want = {r[0]: r for r in want}
    got = {r[0]: r for r in got}
    common = sorted(set(want) & set(got))
    assert len(common) >= 285 and len(got) >= 285
    assert all(got[t] == want[t] for t in common)
    for t, meter, pv, residual in got.values():
        assert float(meter) - float(pv) == float(residual)
        assert 0.0 <= float(meter) < 9000.0


def test_stream_run_report(tmp_path):
    """``pvsim_main(run_report_path=...)`` writes a report of app
    ``pvsim.stream`` that both packages' validators accept, with the
    join's latencies and the funnel and broker counts."""
    report = tmp_path / "rep.json"
    with tmetrics.use_registry(tmetrics.MetricsRegistry()):
        rows = run_pair(tpv.pvsim_main, tmeter.metersim_main,
                        tmp_path / "t.csv", "local://report", 120,
                        report=str(report), device="cpu")
    with open(report) as f:
        doc = json.load(f)
    validate_report(doc)
    j_validate_report(doc)
    assert doc["app"] == "pvsim.stream" and doc["device"]["platform"] == \
        "cpu"
    sec = doc["streaming"]
    assert sec["rows_written"] == len(rows) >= 110
    assert sec["publish_to_join"]["count"] == len(rows)
    assert sec["join_to_csv"]["count"] == len(rows)
    assert sec["broker"]["published"] == sec["broker"]["delivered"] == 120
    assert sec["funnel"]["evictions"] == 0 and doc["realtime"] is None


def test_deployment_as_three_processes(tmp_path):
    """The deployment as three OS processes joined only by TCP:
    ``fanoutbroker --port 0``, ``pvsim --backend asyncio`` under
    TZ=America/Chicago and ``metersim --device cpu`` under TZ=UTC.  The
    wire carries naive wall time as as-if-UTC epochs, so the join does
    not depend on the hosts' timezones (a naive .timestamp() round trip
    would skew the streams by hours and join nothing)."""
    env = dict(os.environ, PYTHONPATH="")
    out = tmp_path / "out.csv"
    start = "2019-09-05 12:00:00"
    cmd = [sys.executable, "-m", "tmhpvsim_torch"]
    broker = subprocess.Popen(cmd + ["fanoutbroker", "--port", "0"],
                              env=env, stderr=subprocess.PIPE, text=True,
                              cwd=ROOT)
    try:
        line = broker.stderr.readline()
        assert "fanout broker listening on 127.0.0.1:" in line, line
        url = f"tcp://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        consumer = subprocess.Popen(
            cmd + ["pvsim", str(out), "--backend", "asyncio", "--device",
                   "cpu", "--amqp-url", url, "--no-realtime", "--start",
                   start],
            env=dict(env, TZ="America/Chicago"), stderr=subprocess.PIPE,
            text=True, cwd=ROOT)
        try:
            deadline = time.time() + 60
            while time.time() < deadline and not out.exists():
                time.sleep(0.2)
            assert out.exists(), "the consumer never started"
            time.sleep(1.0)  # its subscribe frame
            producer = subprocess.run(
                cmd + ["metersim", "--device", "cpu", "--amqp-url", url,
                       "--no-realtime", "--duration", "40", "--start", start,
                       "--seed", "3"],
                env=dict(env, TZ="UTC"), capture_output=True, text=True,
                timeout=120, cwd=ROOT)
            assert producer.returncode == 0, producer.stderr
            deadline = time.time() + 30
            while time.time() < deadline and len(_rows(out)) < 40:
                time.sleep(0.2)
        finally:
            consumer.terminate()
            consumer.wait(timeout=30)
    finally:
        broker.terminate()
        broker.wait(timeout=30)
    rows = _rows(out)
    assert len(rows) > 20
    for t, meter, pv, residual in rows:
        assert float(meter) - float(pv) == float(residual)
        assert 0 <= float(meter) < 9000
        assert t.startswith("2019-09-05 12:")


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------


@pytest.mark.parametrize("command", ["metersim", "pvsim"])
@pytest.mark.parametrize("flag", ["--trace", "--obs-port", "--obs-bind",
                                  "--metrics", "--chaos", "--chaos-seed",
                                  "--supervise"])
def test_waiting_flags_are_usage_errors(capsys, command, flag):
    from tmhpvsim_torch.cli import main as cli

    argv = [command] + (["out.csv", "--backend", "asyncio"]
                        if command == "pvsim" else []) + [flag, "1"]
    with pytest.raises(SystemExit) as e:
        cli(argv)
    assert e.value.code == 2
    assert f"{flag} is not ported to tmhpvsim_torch yet" in \
        capsys.readouterr().err


@pytest.mark.parametrize("argv, message", [
    (["--chains", "4"], "--chains requires --backend=device"),
    (["--output", "reduce"], "--output requires --backend=device"),
    (["--prng-impl", "rbg"], "--prng-impl requires --backend=device"),
    (["--compile-cache", "x"], "--compile-cache requires --backend=device"),
    (["--start", "noon"], "bad --start"),
])
def test_pvsim_stream_refuses_device_flags(capsys, argv, message):
    from tmhpvsim_torch.cli import main as cli

    with pytest.raises(SystemExit):
        cli(["pvsim", "out.csv", "--backend", "asyncio"] + argv)
    assert message in capsys.readouterr().err


def test_pvsim_device_backend_needs_duration(capsys):
    from tmhpvsim_torch.cli import main as cli

    with pytest.raises(SystemExit):
        cli(["pvsim", "out.csv", "--device", "cpu"])
    assert "--duration is required with --backend=device" in \
        capsys.readouterr().err
