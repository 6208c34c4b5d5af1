"""Message transport with fanout semantics (own copy of the part of the
JAX package's runtime/broker.py that in-process serving uses).

A named exchange delivers every published message to every subscriber
bound to it at publish time (the reference's RabbitMQ fanout exchange).
The wire format is the reference's: a UTF-8 JSON float body and a
timestamp, with metadata (``meta``) riding out of band, so the body stays
a plain JSON float.

``local://NAME`` URLs are served by :class:`LocalTransport`, an
in-process broker (one per URL).  The JAX package's ``tcp://`` and
``amqp://`` transports are not ported yet: :func:`make_transport` refuses
them by name.
"""

from __future__ import annotations

import asyncio
import dataclasses
import datetime as _dt
import json
import logging
import weakref
from typing import AsyncIterator, Dict, List, Optional, Tuple

from tmhpvsim_torch.obs import metrics as obs_metrics

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Message:
    body: bytes
    timestamp: Optional[_dt.datetime]
    #: out-of-band metadata; None on the reference wire shape
    meta: Optional[dict] = None


def encode(value: float, time: _dt.datetime,
           meta: Optional[dict] = None) -> Message:
    """JSON float body + timestamp."""
    return Message(body=json.dumps(value).encode(), timestamp=time,
                   meta=meta)


def decode(msg: Message) -> Tuple[_dt.datetime, float]:
    """(measurement time, value)."""
    return msg.timestamp, json.loads(msg.body.decode())


def decode_with_meta(msg: Message) -> Tuple[_dt.datetime, float,
                                            Optional[dict]]:
    """(time, value, meta)."""
    return msg.timestamp, json.loads(msg.body.decode()), msg.meta


#: endpoints each registry has seen a connect to (first connects vs
#: reconnects), keyed weakly on the registry
_seen_endpoints: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _count_connect(url: str, exchange: str) -> None:
    reg = obs_metrics.get_registry()
    reg.counter("broker.connects_total").inc()
    seen = _seen_endpoints.setdefault(reg, set())
    if (url, exchange) in seen:
        reg.counter("broker.reconnects_total").inc()
    else:
        seen.add((url, exchange))


def _pub_counter():
    return obs_metrics.get_registry().counter("broker.published_total")


def _deliver_counter():
    return obs_metrics.get_registry().counter("broker.delivered_total")


#: per-subscriber buffered messages before the oldest is dropped (a
#: subscriber that stopped reading must not grow without bound)
MAX_CONSUMER_BACKLOG = 10_000


class _LocalBroker:
    """Named fanout exchanges; one bounded queue per subscriber (oldest
    dropped past :data:`MAX_CONSUMER_BACKLOG`, counted in
    ``broker.dropped_total``)."""

    _registry: Dict[str, "_LocalBroker"] = {}

    def __init__(self):
        self._exchanges: Dict[str, List[asyncio.Queue]] = {}

    @classmethod
    def get(cls, url: str) -> "_LocalBroker":
        """One broker per local:// URL."""
        return cls._registry.setdefault(url, cls())

    def publish(self, exchange: str, msg: Message) -> None:
        depth = dropped = 0
        for q in self._exchanges.get(exchange, []):
            while q.qsize() >= MAX_CONSUMER_BACKLOG:
                q.get_nowait()
                dropped += 1
            q.put_nowait(msg)
            depth = max(depth, q.qsize())
        reg = obs_metrics.get_registry()
        if dropped:
            reg.counter("broker.dropped_total").inc(dropped)
            logger.warning(
                "local broker: subscriber backlog exceeded %d on %r; "
                "dropped %d oldest messages", MAX_CONSUMER_BACKLOG,
                exchange, dropped)
        if depth:
            reg.gauge("broker.queue_depth").set(depth)

    def bind(self, exchange: str) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue()
        self._exchanges.setdefault(exchange, []).append(q)
        return q

    def unbind(self, exchange: str, q: asyncio.Queue) -> None:
        try:
            self._exchanges.get(exchange, []).remove(q)
        except ValueError:
            pass


class LocalTransport:
    """Fanout pub/sub inside one process (``local://`` URLs)."""

    def __init__(self, url: str, exchange: str):
        self._url = url
        self._broker = _LocalBroker.get(url)
        self._exchange = exchange

    async def __aenter__(self):
        _count_connect(self._url, self._exchange)
        return self

    async def __aexit__(self, *exc):
        return False

    async def publish(self, value: float, time: _dt.datetime,
                      meta: Optional[dict] = None) -> None:
        self._broker.publish(self._exchange, encode(value, time, meta))
        _pub_counter().inc()

    async def subscribe(self, with_meta: bool = False) -> AsyncIterator:
        """Yields ``(time, value)``, or ``(time, value, meta)`` with
        ``with_meta=True``."""
        q = self._broker.bind(self._exchange)
        deliver = _deliver_counter()
        try:
            while True:
                msg = await q.get()
                deliver.inc()
                yield decode_with_meta(msg) if with_meta else decode(msg)
        finally:
            self._broker.unbind(self._exchange, q)


class AmqpTransport:
    """Fanout pub/sub over a RabbitMQ broker through ``aio_pika``.

    The reference's topology: a named fanout exchange; a publisher without
    confirms whose publish is shielded from cancellation; a consumer with
    an exclusive queue and prefetch 1.  ``meta`` rides in the AMQP
    headers; a timestamp delivered as POSIX seconds is read as a naive
    local datetime.
    """

    def __init__(self, url: str, exchange: str):
        try:
            import aio_pika
        except ImportError as err:
            raise RuntimeError(
                "aio_pika is not installed; use a local:// or tcp:// URL, "
                "or install aio-pika for AMQP") from err
        self._aio_pika = aio_pika
        self._url = url
        self._exchange_name = exchange
        self._conn = None

    async def __aenter__(self):
        ap = self._aio_pika
        self._conn = await ap.connect_robust(self._url)
        self._channel = await self._conn.channel()
        self._exchange = await self._channel.declare_exchange(
            self._exchange_name, ap.ExchangeType.FANOUT)
        _count_connect(self._url, self._exchange_name)
        return self

    async def __aexit__(self, *exc):
        if self._conn is not None:
            await self._conn.close()
        return False

    async def publish(self, value: float, time: _dt.datetime,
                      meta: Optional[dict] = None) -> None:
        msg = self._aio_pika.Message(body=json.dumps(value).encode(),
                                     timestamp=time, headers=meta or None)
        await asyncio.shield(self._exchange.publish(msg, routing_key=""))
        _pub_counter().inc()

    async def subscribe(self, with_meta: bool = False) -> AsyncIterator:
        """Yields ``(time, value)``, or ``(time, value, meta)`` with
        ``with_meta=True``."""
        await self._channel.set_qos(prefetch_count=1)
        queue = await self._channel.declare_queue(exclusive=True)
        await queue.bind(self._exchange)
        deliver = _deliver_counter()
        async with queue.iterator() as it:
            async for message in it:
                async with message.process():
                    ts = message.timestamp
                    if isinstance(ts, (int, float)):
                        ts = _dt.datetime.fromtimestamp(ts)
                    deliver.inc()
                    value = json.loads(message.body.decode())
                    if with_meta:
                        meta = (dict(message.headers) if message.headers
                                else None)
                        yield ts, value, meta
                    else:
                        yield ts, value


def make_transport(url: Optional[str], exchange: str):
    """The transport of a URL: ``local://`` (the default) the in-process
    broker, ``tcp://`` the in-tree TCP fanout broker, anything else AMQP."""
    url = url or "local://default"
    if url.startswith("local://"):
        return LocalTransport(url, exchange)
    if url.startswith("tcp://"):
        from tmhpvsim_torch.runtime.tcpbroker import TcpTransport

        return TcpTransport(url, exchange)
    return AmqpTransport(url, exchange)
