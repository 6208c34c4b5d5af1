"""The port's streaming runtime: the fixed-rate clock, the timestamp join,
retries and the circuit breaker, the coroutine runner, and the fanout
transports (runtime/broker.py: local://, tcp:// through
runtime/tcpbroker.py, amqp://)."""

from tmhpvsim_torch.runtime.clock import fixedclock  # noqa: F401
from tmhpvsim_torch.runtime.funnel import SynchronizingFunnel  # noqa: F401
from tmhpvsim_torch.runtime.resilience import (  # noqa: F401
    CircuitBreaker,
    ResiliencePolicy,
    asyncretry,
    forever,
    reconnect_policy,
)
from tmhpvsim_torch.runtime.run import asyncrun  # noqa: F401
