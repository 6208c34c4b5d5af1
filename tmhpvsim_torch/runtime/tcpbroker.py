"""TCP fanout broker: cross-process streaming without RabbitMQ (own copy of
the JAX package's runtime/tcpbroker.py).

The reference's deployment is two shells joined through an external
RabbitMQ server.  ``local://`` cannot span OS processes and ``amqp://``
needs aio-pika and a running broker; this in-tree fanout broker speaks a
minimal newline-delimited JSON protocol over TCP:

    shell 1:  python -m tmhpvsim_torch fanoutbroker --port 5673
    shell 2:  python -m tmhpvsim_torch pvsim out.csv --backend asyncio \
                  --amqp-url tcp://127.0.0.1:5673
    shell 3:  python -m tmhpvsim_torch metersim --amqp-url tcp://127.0.0.1:5673

Semantics are the AMQP fanout contract the apps rely on: named exchanges,
every subscriber sees every message published after it subscribed, the
measurement time rides with the value.  A slow subscriber gets its own
buffer with oldest-first drop beyond a cap (``tcpbroker.dropped_total``
counts the drops), so one stalled consumer never wedges the broker.

Wire protocol (one JSON object per line, UTF-8):

    {"op": "sub", "exchange": E}                      client -> broker
    {"op": "pub", "exchange": E, "v": f, "ts_us": n}  client -> broker
    {"v": f, "ts_us": n}                              broker -> subscriber

An optional ``"m"`` object on pub frames (metersim's ``seq`` and
``pub_us``) is forwarded to subscribers when it is a dict and dropped
otherwise.

``ts_us`` is the measurement's NAIVE wall time as integer microseconds
since the epoch *as if UTC*: the apps join on naive fixed-clock
datetimes, and pinning the wire encoding to UTC makes producer and
consumer agree even when their hosts run different timezones (a naive
``.timestamp()`` round trip would skew by the timezone difference).
Integer microseconds, not float seconds, because the funnel joins on
exact datetime equality and a float64 epoch can perturb the microsecond
field of sub-second times through json.
"""

from __future__ import annotations

import asyncio
import contextlib
import datetime as _dt
import json
import logging
from typing import AsyncIterator, Dict, Optional, Set
from urllib.parse import urlparse

from tmhpvsim_torch.obs import metrics as obs_metrics
from tmhpvsim_torch.runtime.broker import (_count_connect, _deliver_counter,
                                           _pub_counter)

#: wire-protocol epoch for the integer-microsecond "ts_us" field
_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)

logger = logging.getLogger(__name__)

#: per-subscriber buffered messages before oldest-first drop
MAX_SUBSCRIBER_BACKLOG = 10_000


class _Subscriber:
    """One consumer connection: a bounded queue + drain task, so a slow or
    stalled consumer back-pressures onto ITS buffer, never the broker.

    ``tcpbroker.backlog_depth`` is the AGGREGATE queued-message count
    across all live subscribers, maintained by +/- deltas (an absolute
    ``set(qsize)`` per subscriber would be last-write-wins: with many
    concurrent subscribers the gauge read whichever one touched it
    last, hiding every other backlog)."""

    def __init__(self, writer: asyncio.StreamWriter,
                 max_backlog: int = MAX_SUBSCRIBER_BACKLOG):
        self.writer = writer
        self.max_backlog = int(max_backlog)
        self.queue: asyncio.Queue = asyncio.Queue()
        self.n_dropped = 0
        reg = obs_metrics.get_registry()
        self._c_dropped = reg.counter("tcpbroker.dropped_total")
        self._g_backlog = reg.gauge("tcpbroker.backlog_depth")

    def offer(self, line: bytes) -> None:
        while self.queue.qsize() >= self.max_backlog:
            self.queue.get_nowait()
            self._g_backlog.add(-1)
            self.n_dropped += 1
            self._c_dropped.inc()
            if self.n_dropped == 1 or self.n_dropped % 1000 == 0:
                logger.warning(
                    "tcp broker: subscriber backlog exceeded %d; dropped "
                    "%d oldest messages (consumer stalled?)",
                    self.max_backlog, self.n_dropped,
                )
        self.queue.put_nowait(line)
        self._g_backlog.add(1)

    def unregistered(self) -> None:
        """Hand back this queue's share of the aggregate backlog gauge
        (idempotent: the queue is emptied)."""
        n = self.queue.qsize()
        if n:
            self._g_backlog.add(-n)
        while not self.queue.empty():
            self.queue.get_nowait()

    async def drain(self) -> None:
        while True:
            line = await self.queue.get()
            self._g_backlog.add(-1)
            self.writer.write(line)
            await self.writer.drain()


class TcpFanoutBroker:
    """The broker server: named fanout exchanges over one TCP port."""

    def __init__(self, host: str = "127.0.0.1", port: int = 5673,
                 max_backlog: int = MAX_SUBSCRIBER_BACKLOG):
        self.host = host
        self.port = port
        self.max_backlog = int(max_backlog)
        self._exchanges: Dict[str, Set[_Subscriber]] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        #: writers of ALL live connections (not just subscribers): since
        #: Python 3.12.1 Server.wait_closed() also waits for connection
        #: handlers, so stop() must actively disconnect clients or it
        #: deadlocks behind a handler parked in readline()
        self._conn_writers: Set[asyncio.StreamWriter] = set()

    async def __aenter__(self):
        await self.start()
        return self

    async def __aexit__(self, *exc):
        await self.stop()
        return False

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        # resolve port 0 -> the bound port, so tests can ask for "any"
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("tcp fanout broker listening on %s:%d",
                    self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for w in list(self._conn_writers):  # see _conn_writers note
                w.close()
            await self._server.wait_closed()
            self._server = None

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    def _unregister(self, exchange: Optional[str],
                    sub: Optional[_Subscriber]) -> None:
        """Detach a subscriber (idempotent): stop fanning out to it and
        return its queued share of the backlog gauge."""
        subs = self._exchanges.get(exchange)
        if subs is not None and sub in subs:
            subs.discard(sub)
            if not subs:
                self._exchanges.pop(exchange, None)
            sub.unregistered()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        sub: Optional[_Subscriber] = None
        sub_exchange: Optional[str] = None
        drain_task: Optional[asyncio.Task] = None
        self._conn_writers.add(writer)
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    frame = json.loads(line)
                    op = frame["op"]
                except (json.JSONDecodeError, KeyError, TypeError):
                    logger.warning("tcp broker: malformed frame %r",
                                   line[:100])
                    continue
                if op == "pub":
                    v, ts = frame.get("v"), frame.get("ts_us")
                    exchange = frame.get("exchange")
                    # validate here: forwarding a malformed frame would
                    # crash EVERY subscriber's decode loop, not just the
                    # bad publisher (and a non-str exchange would TypeError
                    # the dict lookup)
                    if not isinstance(v, (int, float)) or \
                            not isinstance(ts, (int, float)) or \
                            not isinstance(exchange, str):
                        logger.warning(
                            "tcp broker: dropping malformed pub frame: %r",
                            line[:100],
                        )
                        continue
                    frame_out = {"v": v, "ts_us": ts}
                    m = frame.get("m")
                    if isinstance(m, dict):  # additive meta passthrough
                        frame_out["m"] = m
                    out = json.dumps(frame_out).encode() + b"\n"
                    for s in self._exchanges.get(exchange, ()):  # fanout
                        s.offer(out)
                elif op == "sub" and sub is None:
                    sub_exchange = frame.get("exchange")
                    if not isinstance(sub_exchange, str):
                        logger.warning(
                            "tcp broker: dropping malformed sub frame: %r",
                            line[:100],
                        )
                        continue
                    sub = _Subscriber(writer, self.max_backlog)
                    self._exchanges.setdefault(sub_exchange, set()).add(sub)
                    drain_task = asyncio.create_task(sub.drain())
                    # a consumer that dies mid-write kills the drain task
                    # with ConnectionError while this reader loop may stay
                    # parked in readline() (half-open socket): unregister
                    # immediately so publishes stop piling into a queue
                    # nothing will ever drain
                    drain_task.add_done_callback(
                        lambda _t, e=sub_exchange, s=sub:
                        self._unregister(e, s))
                else:
                    logger.warning("tcp broker: unexpected op %r", op)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._conn_writers.discard(writer)
            if sub is not None:
                self._unregister(sub_exchange, sub)
            if drain_task is not None:
                drain_task.cancel()
                # the drain task may already be DONE with a ConnectionError
                # (consumer died mid-write) — that must not re-raise here
                # and skip the writer cleanup below
                with contextlib.suppress(asyncio.CancelledError,
                                         ConnectionError):
                    await drain_task
            writer.close()
            with contextlib.suppress(ConnectionError):
                await writer.wait_closed()


class TcpTransport:
    """Client transport for ``tcp://host:port`` URLs, with the interface of
    LocalTransport and AmqpTransport (runtime/broker.py): a dropped
    connection raises out of publish / subscribe, and the apps' reconnect
    policy reconnects with backoff."""

    def __init__(self, url: str, exchange: str):
        parsed = urlparse(url)
        if parsed.scheme != "tcp":
            raise ValueError(f"TcpTransport needs a tcp:// URL, got {url!r}")
        self._host = parsed.hostname or "127.0.0.1"
        self._port = parsed.port or 5673
        self._exchange = exchange
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    async def __aenter__(self):
        self._reader, self._writer = await asyncio.open_connection(
            self._host, self._port
        )
        _count_connect(f"tcp://{self._host}:{self._port}", self._exchange)
        return self

    async def __aexit__(self, *exc):
        if self._writer is not None:
            self._writer.close()
            with contextlib.suppress(ConnectionError):
                await self._writer.wait_closed()
        return False

    async def _send(self, frame: dict) -> None:
        self._writer.write(json.dumps(frame).encode() + b"\n")
        await self._writer.drain()

    async def publish(self, value: float, time: _dt.datetime,
                      meta: Optional[dict] = None) -> None:
        # naive wall time -> as-if-UTC epoch in integer microseconds (see
        # the module docstring); an aware datetime keeps its instant
        if time.tzinfo is None:
            time = time.replace(tzinfo=_dt.timezone.utc)
        ts_us = round((time - _EPOCH) / _dt.timedelta(microseconds=1))
        frame = {"op": "pub", "exchange": self._exchange,
                 "v": value, "ts_us": ts_us}
        if meta:
            frame["m"] = meta
        # shielded: a cancellation mid-publish must not truncate the
        # frame on the wire
        await asyncio.shield(self._send(frame))
        _pub_counter().inc()

    async def subscribe(self, with_meta: bool = False) -> AsyncIterator:
        """Yields ``(time, value)``, or ``(time, value, meta)`` with
        ``with_meta=True``; a closed connection raises
        ``ConnectionError`` for the caller's reconnect loop."""
        await self._send({"op": "sub", "exchange": self._exchange})
        deliver = _deliver_counter()
        while True:
            line = await self._reader.readline()
            if not line:
                raise ConnectionError("tcp broker closed the connection")
            frame = json.loads(line)
            deliver.inc()
            # the inverse of publish: as-if-UTC microseconds -> naive wall
            t = (_EPOCH + _dt.timedelta(microseconds=frame["ts_us"])
                 ).replace(tzinfo=None)
            if with_meta:
                m = frame.get("m")
                yield t, frame["v"], (m if isinstance(m, dict) else None)
            else:
                yield t, frame["v"]
