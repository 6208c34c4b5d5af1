"""Scenario serving: a warm simulation on the card answering "what-if"
queries (own copy of the JAX package's serve/, one worker, in-process
``local://`` transport).

Modules: :mod:`.schema` (the request/reply wire format, validation and
the scenario -> knob-tensor encoding), :mod:`.batcher` (the window and
continuous schedulers), :mod:`.server` (the warm engine, the rolling
session, the asyncio server and client).
"""
