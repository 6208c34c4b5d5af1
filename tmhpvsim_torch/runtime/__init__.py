"""Runtime of the port's serving path: the in-process fanout transport and
the retry / circuit-breaker policy."""
