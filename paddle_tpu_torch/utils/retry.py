"""Bounded exponential-backoff retry for transient faults (the port's own
copy of ``paddle_tpu/utils/retry.py``).

Attempts are capped, the backoff is exponential with a deterministic
(unjittered) base so a test reproduces it, and every retry bumps a
``fault.retry.*`` counter on the metrics bus. The serving engine runs its
decode dispatches through one (``ContinuousBatchingEngine.retry_policy``).
"""
import time

from .metrics_bus import counters

#: transient failures worth retrying: the Python transports' timeouts and
#: dropped connections, and raw socket/ctypes OSErrors
TRANSIENT_ERRORS = (ConnectionError, TimeoutError, OSError)


class RetryPolicy:
    def __init__(self, attempts=4, base_delay=0.05, max_delay=2.0,
                 retry_on=TRANSIENT_ERRORS):
        if attempts < 1:
            raise ValueError("attempts must be >= 1")
        self.attempts = int(attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.retry_on = retry_on

    def delay(self, attempt):
        """Backoff before retry `attempt` (1-based): base * 2^(attempt-1)."""
        return min(self.base_delay * (2 ** (attempt - 1)), self.max_delay)

    def run(self, fn, *, name="op", on_retry=None):
        """Call fn() with up to `attempts` tries. `on_retry(exc, attempt)`
        runs before each retry (a transport drops a poisoned connection
        there, so the retry redials)."""
        last = None
        for attempt in range(1, self.attempts + 1):
            try:
                return fn()
            except self.retry_on as e:
                last = e
                if attempt == self.attempts:
                    break
                counters.bump(f"fault.retry.{name}")
                if on_retry is not None:
                    try:
                        on_retry(e, attempt)
                    except Exception:
                        pass  # cleanup failure must not mask the real error
                time.sleep(self.delay(attempt))
        counters.bump(f"fault.exhausted.{name}")
        raise last


#: default policy; ~0.35 s worst-case added latency
DEFAULT_POLICY = RetryPolicy()


def with_retries(fn, name="op", policy=None, on_retry=None):
    return (policy or DEFAULT_POLICY).run(fn, name=name, on_retry=on_retry)
