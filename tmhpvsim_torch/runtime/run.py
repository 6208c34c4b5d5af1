"""Top-level coroutine runner with an orderly SIGINT shutdown (own copy of
the JAX package's runtime/run.py).

Runs the coroutine on a fresh event loop, turns the first SIGINT into
task cancellation (so ``finally`` blocks and shutdown accounting run),
and shuts down async generators before closing the loop.
"""

from __future__ import annotations

import asyncio
import signal


def asyncrun(coro):
    """Run ``coro`` to completion; SIGINT cancels it cleanly.

    Returns the coroutine's result, or None if it was cancelled.
    """
    loop = asyncio.new_event_loop()
    task = loop.create_task(coro)
    try:
        loop.add_signal_handler(signal.SIGINT, task.cancel)
    except (NotImplementedError, RuntimeError):
        pass  # non-main thread or platform without signal support
    try:
        return loop.run_until_complete(task)
    except asyncio.CancelledError:
        return None
    finally:
        try:
            loop.remove_signal_handler(signal.SIGINT)
        except (NotImplementedError, RuntimeError, ValueError):
            pass
        loop.run_until_complete(loop.shutdown_asyncgens())
        loop.close()
