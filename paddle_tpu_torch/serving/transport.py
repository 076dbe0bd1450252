"""Wire transport for KV-page handoff bundles and fabric blob fetches (the
port's own copy of ``paddle_tpu/serving/transport.py``).

:mod:`.handoff` moves bundles through a spool *directory*: fine within one
host, useless across hosts. This module carries the SAME
atomic handoff-bundle frames (chained keyed blake2b page digests,
generation fencing, consumed-in-every-outcome semantics) over a
TCPStore-style socket channel, so a prefill replica on one host can hand
pages to a decode replica — or the KV fabric can fetch a hot prefix —
on another.

Design rules, in priority order:

1. **The digest gate is the only trust boundary.** The wire adds zero
   validation of its own and removes none: every byte string that
   crosses it is re-validated by :meth:`HandoffBundle.from_bytes` +
   :meth:`verify_prompt_digests` (bundles) or the blob frame digest +
   :meth:`KVFabric._validate` (fabric entries) on the receiving side —
   and every wire payload is the NON-EXECUTABLE :mod:`.wireformat`
   encoding, so the channel (which has no peer authentication) cannot
   be leveraged into code execution; see wireformat's trust-model
   notes. A flaky or malicious wire can cost latency, never a wrong
   token.
2. **One dial per op.** Like the native TCPStore client, each RPC opens
   a fresh connection, sends one request, reads one response, closes.
   No connection pool to leak, no half-open stream to reason about
   after a peer death — a dead peer is just a refused/timed-out dial.
3. **Bounded everything.** Retries use the handoff manager's exact
   bounded-backoff-inside-a-deadline loop. A timeout while CONNECTING
   is a dial failure like a refusal — retried, exhausting into
   :class:`KVPartitionError` (a blackholed peer is a partition, not a
   slow one). A timeout AFTER the dial was accepted — bounded by the op
   deadline, not the connect timeout — is typed :class:`KVFetchTimeout`
   immediately and never retried (waiting longer on a stuck peer is
   worse than recomputing).
4. **Consumed in every outcome.** Bundle adoption uses the server's
   ``TAK`` op (get+delete in one critical section), so a bundle is
   gone from the wire store whether adoption succeeds, finds it
   corrupt, or finds it stale — exactly the spool unlink discipline.

Transport selection (:func:`make_transport`): ``PADDLE_KV_TRANSPORT=spool``
(default) returns a plain :class:`HandoffManager`, the spool path;
``wire`` returns a :class:`WireTransport` speaking to a
:class:`KVPageServer` (a loopback one is owned and started lazily when
no endpoint is configured).

Chaos seams: ``serving.kv.partition`` (per RPC attempt, before the
dial), ``serving.kv.timeout`` (between send and receive — converted to
the same ``socket.timeout`` path a stuck peer takes), ``serving.kv.corrupt``
(after receive — truncates the received bytes so the digest gate must
refuse them).
"""
import hashlib
import socket
import struct
import threading
import time

from ..observability.metrics import registry as _registry
from ..testing import chaos
from .handoff import (HandoffBundle, HandoffCorruptError, HandoffError,
                      HandoffManager, StaleHandoffError)
from ..utils.envs import env_float, env_int, env_str

__all__ = ["KVTransportError", "KVFetchTimeout", "KVPartitionError",
           "KVPageServer", "WireTransport", "make_transport",
           "frame_blob", "unframe_blob"]

#: blob frame magic ("paddle_tpu KV v1") — fabric spill entries get the
#: same cheap torn/foreign prefix check handoff bundles have
_BLOB_MAGIC = b"PTKV1\n"
_LEN = struct.Struct(">Q")
_KLEN = struct.Struct(">I")
_DIGEST_SIZE = 16

_M_PUBLISHED = _registry.counter("serving.handoff.published")
_M_ADOPTED = _registry.counter("serving.handoff.adopted")
_M_CORRUPT = _registry.counter("serving.handoff.corrupt")
_M_STALE = _registry.counter("serving.handoff.stale")
_M_SEND_RETRIES = _registry.counter("serving.handoff.send_retries")
_M_TRANSFER = _registry.histogram("serving.handoff.transfer_s")


class KVTransportError(HandoffError):
    """Wire-level failure that is neither a timeout nor retry exhaustion
    (protocol violation, unexpected response). ``reason`` feeds the
    fabric's typed ``kv.fallthrough{reason=}`` accounting."""

    reason = "transport"


class KVFetchTimeout(KVTransportError):
    """The peer accepted the dial but the response never arrived inside
    the socket timeout. Not retried: a peer slow enough to time out is
    slower than local recompute, and retrying a stuck peer holds the
    request hostage."""

    reason = "timeout"


class KVPartitionError(KVTransportError):
    """Every dial attempt inside the retry/deadline budget failed —
    connection refused, reset, unreachable, or timed out CONNECTING (a
    blackholed peer). The peer (or the network between us) is gone; the
    caller falls down the tier ladder."""

    reason = "partition"


def frame_blob(payload):
    """MAGIC + length + blake2b-16 + payload — the same frame discipline
    as :meth:`HandoffBundle.to_bytes`, for opaque fabric entries."""
    digest = hashlib.blake2b(payload, digest_size=_DIGEST_SIZE).digest()
    return _BLOB_MAGIC + _LEN.pack(len(payload)) + digest + payload


def unframe_blob(data):
    """Validate + strip a :func:`frame_blob` frame. Any defect raises
    :class:`HandoffCorruptError` — there is no partial success."""
    hdr = len(_BLOB_MAGIC) + _LEN.size + _DIGEST_SIZE
    if len(data) < hdr or not data.startswith(_BLOB_MAGIC):
        raise HandoffCorruptError("blob frame torn or foreign")
    (n,) = _LEN.unpack(data[len(_BLOB_MAGIC):len(_BLOB_MAGIC) + _LEN.size])
    digest = data[len(_BLOB_MAGIC) + _LEN.size:hdr]
    payload = data[hdr:]
    if len(payload) != n:
        raise HandoffCorruptError(
            f"blob payload truncated: {len(payload)}/{n} bytes")
    if hashlib.blake2b(payload, digest_size=_DIGEST_SIZE).digest() != digest:
        raise HandoffCorruptError("blob payload digest mismatch")
    return payload


def _recv_exact(sock, n):
    """Read exactly ``n`` bytes or raise ConnectionError — a short read
    means the peer died mid-stream, and a torn message must become a
    typed failure, not a silent truncation."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(65536, n - len(buf)))
        if not chunk:
            raise ConnectionError(
                f"peer closed mid-message ({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


class KVPageServer:
    """Minimal keyed byte store behind a socket — the wire-side spool.

    Protocol (all big-endian): request = op(3) + keylen(>I) + key +
    datalen(>Q) + data; response = status(3: ``OK `` / ``MIS``) +
    len(>Q) + body. Ops: ``PUT`` store, ``GET`` fetch, ``TAK`` fetch and
    delete in one critical section (the consumed-in-every-outcome op
    bundle adoption uses), ``DEL`` delete.

    Threading mirrors the native TCPStore server: an accept loop with a
    short timeout (so :meth:`stop` is prompt) hands each connection to a
    daemon thread. A handler reads the complete request off the socket
    BEFORE touching the store lock — a slow or stalled client must never
    hold the store hostage (the blocking-under-lock rule's contract).
    """

    def __init__(self, host="127.0.0.1", port=0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self._sock.settimeout(0.2)
        self.host, self.port = self._sock.getsockname()[:2]
        self._store = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._accept_loop, name="kv-page-server", daemon=True)
        self._thread.start()

    @property
    def endpoint(self):
        return f"{self.host}:{self.port}"

    def __len__(self):
        with self._lock:
            return len(self._store)

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()
        try:
            self._sock.close()
        except OSError:
            pass

    def _handle(self, conn):
        try:
            with conn:
                conn.settimeout(5.0)
                op = _recv_exact(conn, 3)
                (klen,) = _KLEN.unpack(_recv_exact(conn, _KLEN.size))
                key = _recv_exact(conn, klen).decode("utf-8")
                (dlen,) = _LEN.unpack(_recv_exact(conn, _LEN.size))
                data = _recv_exact(conn, dlen) if dlen else b""
                # full request is in hand — only now touch the store
                if op == b"PUT":
                    with self._lock:
                        self._store[key] = data
                    body, status = b"", b"OK "
                elif op == b"GET":
                    with self._lock:
                        body = self._store.get(key)
                    status = b"MIS" if body is None else b"OK "
                    body = body or b""
                elif op == b"TAK":
                    with self._lock:
                        body = self._store.pop(key, None)
                    status = b"MIS" if body is None else b"OK "
                    body = body or b""
                elif op == b"DEL":
                    with self._lock:
                        self._store.pop(key, None)
                    body, status = b"", b"OK "
                else:
                    body, status = b"", b"ERR"
                conn.sendall(status + _LEN.pack(len(body)) + body)
        except (OSError, ConnectionError, struct.error):
            pass        # client died mid-request; its RPC layer retries

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


class WireTransport:
    """Socket-channel drop-in for :class:`HandoffManager`.

    Same surface — ``publish(bundle) -> token``, ``load(token,
    expected_generation)``, ``discard(token)`` — so the frontend's
    handoff code paths (cancel, expiry, shutdown, re-prefill) work on
    either transport unchanged. Tokens are ``kv:handoff-<rid>-g<gen>``
    strings: opaque to callers, like spool paths. Adds
    :meth:`fetch_blob` / :meth:`put_blob` for the fabric's peer-fetch
    tier.

    Unless an ``endpoint`` (or ``PADDLE_KV_WIRE_ADDR``) is given, the
    transport owns a loopback :class:`KVPageServer`, started lazily —
    single-host setups get cross-process handoff for free, tests get a
    real socket path without ceremony.
    """

    def __init__(self, endpoint=None, deadline_s=None, retries=None,
                 backoff_s=None, connect_timeout_s=None,
                 clock=time.monotonic, sleep=time.sleep):
        self._endpoint = endpoint or env_str("PADDLE_KV_WIRE_ADDR")
        self.deadline_s = (env_float("PADDLE_KV_DEADLINE_S", 5.0)
                           if deadline_s is None else float(deadline_s))
        self.retries = (env_int("PADDLE_KV_RETRIES", 2)
                        if retries is None else int(retries))
        self.backoff_s = (env_float("PADDLE_KV_BACKOFF_S", 0.05)
                          if backoff_s is None else float(backoff_s))
        self.connect_timeout_s = (
            env_float("PADDLE_KV_CONNECT_TIMEOUT_S", 1.0)
            if connect_timeout_s is None else float(connect_timeout_s))
        self.clock = clock
        self.sleep = sleep
        self._owned_server = None
        self._server_lock = threading.Lock()

    # ---- endpoint / lifecycle ---------------------------------------------
    @property
    def endpoint(self):
        if self._endpoint:
            return self._endpoint
        with self._server_lock:
            if self._owned_server is None:
                self._owned_server = KVPageServer()
            return self._owned_server.endpoint

    def close(self):
        with self._server_lock:
            if self._owned_server is not None:
                self._owned_server.stop()
                self._owned_server = None

    # ---- raw RPC ----------------------------------------------------------
    def _rpc(self, endpoint, op, key, data=b""):
        """One dial, one request, one response. A timeout in the CONNECT
        phase is a dial failure — reraised as a plain ConnectionError so
        _call's retry loop treats it like a refusal (exhausting into
        :class:`KVPartitionError`); once the peer has accepted the dial,
        the socket timeout is re-armed from the op deadline (the connect
        timeout must not bound response reads) and a send/recv
        ``socket.timeout`` surfaces as :class:`KVFetchTimeout`. Any other
        raw OSError propagates for the retry loop to classify."""
        host, _, port = endpoint.rpartition(":")
        kb = key.encode("utf-8")
        try:
            sock = socket.create_connection(
                (host, int(port)), timeout=self.connect_timeout_s)
        except socket.timeout as e:
            raise ConnectionError(
                f"{op.decode().strip()} {key!r}: dial {endpoint} "
                f"timed out: {e}")
        try:
            with sock:
                sock.settimeout(max(self.deadline_s,
                                    self.connect_timeout_s))
                sock.sendall(op + _KLEN.pack(len(kb)) + kb
                             + _LEN.pack(len(data)) + data)
                try:
                    # drill seam: models the peer going silent after
                    # accepting the request — same path a stuck peer takes
                    chaos.site("serving.kv.timeout")
                except chaos.FaultInjected:
                    raise socket.timeout("injected: peer went silent")
                status = _recv_exact(sock, 3)
                (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
                body = _recv_exact(sock, n) if n else b""
        except socket.timeout as e:
            raise KVFetchTimeout(f"{op.decode().strip()} {key!r} via "
                                 f"{endpoint}: {e}")
        if status == b"MIS":
            return None
        if status != b"OK ":
            raise KVTransportError(
                f"{op.decode().strip()} {key!r} via {endpoint}: "
                f"unexpected status {status!r}")
        return self._maybe_corrupt(body)

    @staticmethod
    def _maybe_corrupt(body):
        """``serving.kv.corrupt`` drill: truncate the received bytes so
        the digest gate downstream must refuse them — the drill proves
        the refusal path, not the injection."""
        try:
            chaos.site("serving.kv.corrupt")
        except chaos.FaultInjected:
            return body[:max(0, len(body) - 7)]
        return body

    def _call(self, endpoint, op, key, data=b""):
        """Bounded-backoff retry inside a deadline — the handoff
        manager's exact loop. Typed errors pass straight through (a
        timeout or digest refusal must not be retried into); transient
        dial failures retry until the attempt budget or deadline runs
        out, then raise :class:`KVPartitionError`."""
        t0 = self.clock()
        attempt = 0
        while True:
            try:
                chaos.site("serving.kv.partition")
                return self._rpc(endpoint, op, key, data)
            except (KVFetchTimeout, KVTransportError,
                    HandoffCorruptError, StaleHandoffError):
                raise
            except Exception as e:
                attempt += 1
                delay = self.backoff_s * (2 ** (attempt - 1))
                if (attempt > self.retries
                        or self.clock() - t0 + delay > self.deadline_s):
                    raise KVPartitionError(
                        f"{op.decode().strip()} {key!r} via {endpoint} "
                        f"failed after {attempt} attempt(s): {e}")
                _M_SEND_RETRIES.inc()
                self.sleep(delay)

    # ---- HandoffManager-compatible surface --------------------------------
    @staticmethod
    def _token(bundle):
        return f"kv:handoff-{bundle.rid}-g{bundle.generation}"

    def publish(self, bundle):
        """Serialize + PUT the bundle; returns its wire token. Fires the
        ``serving.handoff.send`` seam per attempt (same drill plans cover
        both transports) on top of the wire seams."""
        bundle.t_publish = time.time()
        data = bundle.to_bytes()
        token = self._token(bundle)
        t0 = self.clock()
        attempt = 0
        while True:
            try:
                chaos.site("serving.handoff.send")
                self._call(self.endpoint, b"PUT", token, data)
                _M_PUBLISHED.inc()
                return token
            except (KVFetchTimeout, KVPartitionError):
                raise
            except HandoffError:
                raise
            except Exception as e:
                attempt += 1
                delay = self.backoff_s * (2 ** (attempt - 1))
                if (attempt > self.retries
                        or self.clock() - t0 + delay > self.deadline_s):
                    raise HandoffError(
                        f"rid {bundle.rid}: publish failed after "
                        f"{attempt} attempt(s): {e}")
                _M_SEND_RETRIES.inc()
                self.sleep(delay)

    def load(self, token, expected_generation=None):
        """TAK + validate + fence — the spool :meth:`HandoffManager.load`
        contract over the wire. The server-side pop makes the bundle
        consumed in EVERY outcome: success, corrupt, and stale all leave
        the wire store empty."""
        chaos.site("serving.handoff.adopt")
        try:
            data = self._call(self.endpoint, b"TAK", token)
            if data is None:
                raise HandoffCorruptError(f"bundle {token!r} not on wire")
            bundle = HandoffBundle.from_bytes(data)
            bundle.verify_prompt_digests()
            if (expected_generation is not None
                    and bundle.generation != expected_generation):
                _M_STALE.inc()
                raise StaleHandoffError(
                    f"rid {bundle.rid}: bundle generation "
                    f"{bundle.generation} != expected {expected_generation}")
        except HandoffCorruptError:
            _M_CORRUPT.inc()
            raise
        _M_ADOPTED.inc()
        if bundle.t_publish is not None:
            _M_TRANSFER.observe(max(0.0, time.time() - bundle.t_publish))
        return bundle

    def discard(self, token):
        try:
            self._call(self.endpoint, b"DEL", token)
        except HandoffError:
            pass        # best-effort, like the spool's silent unlink

    # ---- fabric blob surface ----------------------------------------------
    def put_blob(self, key, data, endpoint=None):
        self._call(endpoint or self.endpoint, b"PUT", key, data)

    def fetch_blob(self, endpoint, key):
        """GET one fabric entry from a peer's wire store; None on miss.
        Typed wire errors propagate for the fabric's fallthrough
        accounting; the returned bytes are still framed — the caller
        runs them through :func:`unframe_blob`'s digest gate."""
        return self._call(endpoint, b"GET", key)

    def delete_blob(self, key, endpoint=None):
        try:
            self._call(endpoint or self.endpoint, b"DEL", key)
        except HandoffError:
            pass


def make_transport(kind=None, **kw):
    """Transport selection: ``spool`` (default) returns a plain
    :class:`HandoffManager`, the spool directory's handoff; ``wire`` returns
    a :class:`WireTransport`."""
    kind = kind or env_str("PADDLE_KV_TRANSPORT", "spool")
    if kind == "spool":
        return HandoffManager(**kw)
    if kind == "wire":
        return WireTransport(**kw)
    raise ValueError(
        f"PADDLE_KV_TRANSPORT={kind!r}: expected 'spool' or 'wire'")
