"""Environment readers of the port (the port's own copy of
``paddle_tpu/utils/envs.py``).

The only module of ``paddle_tpu_torch`` that reads the environment. The
names it is asked for switch telemetry on and set its cadence
(``PADDLE_DYNAMICS*``, ``observability.dynamics``) or set the non-finite
guard's tolerance and check cadence (``PADDLE_NONFINITE_TOLERANCE``,
``PADDLE_NONFINITE_CHECK_EVERY``, ``jit_api``) or size the LoRA plane
(``PADDLE_LORA_SLOTS``, ``inference.continuous``; ``PADDLE_LORA_MAX_MB``
and ``PADDLE_LORA_CACHE_MB``, ``serving.adapters``), or are the serving
control plane's own, under the reference's names (chaos arming, span
tracing, devprof, the compile ledger's bounds, the handoff and wire
transports, the KV fabric, tenancy, the disaggregation switch); none
picks a kernel or its plain version, which the tensor's device alone
decides. A garbage value reads as the default, so a typo'd variable never
stops a process.
"""
import os

__all__ = ["env_int", "env_float", "env_bool", "env_str"]

#: truthy spellings for env_bool — everything else (including unset and
#: garbage) is False unless a different default is passed
_TRUE = ("1", "true", "yes", "on")


def env_int(name, default):
    """int(os.environ[name]) with ``default`` for unset/empty/garbage —
    config knobs must never crash a process over a typo'd env var."""
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def env_float(name, default):
    """float(os.environ[name]) with ``default`` for unset/empty/garbage."""
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def env_bool(name, default=False):
    """True for '1'/'true'/'yes'/'on' (case-insensitive), False for any
    other SET value, ``default`` when unset/empty."""
    raw = os.environ.get(name, "")
    if not raw:
        return default
    return raw.strip().lower() in _TRUE


def env_str(name, default=None):
    """The variable's value, an empty string reading as unset (a launcher
    that exports ``PADDLE_X=`` to clear a knob means 'not set')."""
    return os.environ.get(name, "") or default
