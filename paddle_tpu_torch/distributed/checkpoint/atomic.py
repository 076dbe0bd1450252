"""Atomic file writes (the port's own copy of
``paddle_tpu/distributed/checkpoint/atomic.py``): serialize to a sibling
``*.tmp``, ``fsync``, then ``os.replace`` into place. A writer killed at
any instruction leaves either the previous committed file or a ``*.tmp``
no loader reads, never a torn file under the real name. The handoff spool
(``serving/handoff.py``) commits its bundles through it.
"""
import json
import os
import time

__all__ = ["atomic_write", "atomic_write_bytes", "atomic_write_json",
           "sweep_orphan_tmps"]


def atomic_write(path, writer, before_commit=None):
    """Write ``path`` atomically: ``writer(f)`` fills a temp file, which is
    fsynced and renamed over ``path``. ``before_commit(tmp_path)`` runs after
    the fsync and before the rename — the seam for manifest fingerprinting
    and fault injection (a chaos ``truncate`` there commits a torn file the
    loader's crc gate must catch). A failure anywhere leaves no litter and
    never touches the previously committed ``path``."""
    # pid-suffixed temp: two writers racing on the same target (e.g. ranks
    # that both think they own a shared file) can never fsync-then-rename
    # each other's half-written bytes or remove each other's in-flight temp
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:  # ckpt-atomic-ok
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        if before_commit is not None:
            before_commit(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # failed commit leaves no litter
            try:
                os.remove(tmp)
            except OSError:
                pass


def sweep_orphan_tmps(directory, prefix="", min_age_s=60.0):
    """Remove ``<prefix>*.tmp.<pid>`` litter a SIGKILLed writer left behind
    (its finally-block never ran, and the restarted incarnation writes
    under a new pid). The age floor keeps a LIVE writer's in-flight temp
    safe — full-state temps are multi-GB, so somebody must reclaim them.
    Returns the number of files removed; never raises."""
    removed = 0
    try:
        names = os.listdir(directory)
    except OSError:
        return removed
    now = time.time()
    for name in names:
        if not name.startswith(prefix) or ".tmp." not in name:
            continue
        path = os.path.join(directory, name)
        try:
            if os.path.isfile(path) and now - os.path.getmtime(path) >= min_age_s:
                os.remove(path)
                removed += 1
        except OSError:
            continue
    return removed


def atomic_write_bytes(path, data, before_commit=None):
    atomic_write(path, lambda f: f.write(data), before_commit=before_commit)


def atomic_write_json(path, obj, before_commit=None):
    atomic_write_bytes(path, json.dumps(obj).encode("utf-8"),
                       before_commit=before_commit)
