"""Elastic job membership (the port's own copy of
``paddle_tpu/distributed/fleet/elastic/membership.py``).

One module answers "who is in the job right now" for every layer that
would otherwise assume ``range(world_size)``. A launcher that (re-)forms
the job publishes the membership contract through three variables:

- ``PADDLE_TRAINERS_NUM``: the current world size (it shrinks and grows
  across generations; trainer ids are reassigned contiguously at each
  re-form);
- ``PADDLE_ELASTIC_RANKS``: the live-rank set, comma separated;
- ``PADDLE_ELASTIC_GENERATION``: the job incarnation counter, bumped on
  every re-form. Writes are fenced on it (``fencing.py``), so a straggler
  of a dead generation cannot clobber the live job's state.

Without the launcher's variables the answers come from
``torch.distributed`` when a process group is up, else they describe one
process (rank 0 of a world of 1).
"""
from ....utils.envs import env_int, env_str

__all__ = ["RANK_ENV", "WORLD_ENV", "GENERATION_ENV", "LIVE_RANKS_ENV",
           "ORIG_WORLD_ENV", "rank", "world_size", "generation",
           "live_ranks", "original_world", "scaled_per_rank_batch"]

RANK_ENV = "PADDLE_TRAINER_ID"
WORLD_ENV = "PADDLE_TRAINERS_NUM"
GENERATION_ENV = "PADDLE_ELASTIC_GENERATION"
LIVE_RANKS_ENV = "PADDLE_ELASTIC_RANKS"
ORIG_WORLD_ENV = "PADDLE_ELASTIC_ORIG_WORLD"


def _dist():
    """``torch.distributed`` when a process group is initialised, else
    None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def rank():
    """This process's trainer rank: the launcher contract when present,
    else the process group's rank (a single process is rank 0)."""
    r = env_str(RANK_ENV)
    if r:
        return int(r)
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def world_size():
    """The current job world size: the launcher contract when present (it
    shrinks and grows across elastic generations), else the process
    group's (a single process is a world of 1)."""
    w = env_str(WORLD_ENV)
    if w:
        return int(w)
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def generation():
    """The elastic incarnation this process belongs to (0 = first launch)."""
    return env_int(GENERATION_ENV, 0)


def live_ranks(world=None):
    """Sorted live-rank set. The launcher-published set wins when present;
    otherwise every rank of ``world`` (default: :func:`world_size`) is
    assumed live, the fixed-width case."""
    raw = env_str(LIVE_RANKS_ENV)
    if raw:
        return sorted(int(r) for r in raw.split(",") if r.strip() != "")
    return list(range(world if world is not None else world_size()))


def original_world():
    """The generation-0 world size (what the job was launched at): the
    denominator elastic batch rescaling keeps constant."""
    return env_int(ORIG_WORLD_ENV, world_size())


def scaled_per_rank_batch(global_batch, world=None):
    """Per-rank batch size that keeps ``global_batch`` constant at the
    current world size: training scripts call this at each (re)start and
    the global batch never moves. Raises when the global batch does not
    divide evenly: silently training at another effective batch would break
    the learning-rate schedule's assumptions."""
    w = int(world if world is not None else world_size())
    gb = int(global_batch)
    if w < 1 or gb < 1:
        raise ValueError(f"need world>=1 and global_batch>=1, got {w}, {gb}")
    if gb % w:
        raise ValueError(
            f"global batch {gb} does not divide by the live world size {w}; "
            f"choose a global batch divisible by every world size the job "
            f"may shrink to")
    return gb // w
