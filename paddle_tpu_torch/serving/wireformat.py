"""Non-executable wire encoding for handoff bundles and fabric entries (the
port's own copy of ``paddle_tpu/serving/wireformat.py``).

Everything that crosses the KV wire — handoff bundles, fabric spill
entries — used to be a pickle, which made ``loads`` itself the attack
surface: the transport has no peer authentication, so ANY reachable
endpoint (or a MITM on the segment) could return a crafted pickle and
execute code in the frontend before a single digest check ran. This
module closes that hole structurally instead of cryptographically: the
encoding simply cannot express code.

Format::

    >Q spec-length | UTF-8 JSON spec | raw array heap

The JSON spec is the value tree; binary leaves are markers referencing
the heap. Exactly these Python types are expressible, nothing else:

    None / bool / int / float / str      plain JSON
    bytes                                {"b": "<hex>"}
    tuple                                {"t": [...]}
    list                                 {"l": [...]}
    dict (str keys)                      {"d": {...}}
    numpy.ndarray                        {"a": [dtype, shape, off, nbytes]}

Decoding is ``json.loads`` plus ``np.frombuffer`` against a dtype
allowlist with offset/length bounds checks — no object construction, no
imports, no callables. A malformed spec raises :class:`WireFormatError`
(a ``ValueError``), which the callers' digest gates convert to their
typed corrupt errors.

Trust model (documented here because this IS the trust boundary): the
blob/bundle frame digest is unkeyed and guards against torn frames and
bit rot, not against an adversary — an attacker who owns the wire can
forge a self-consistent frame. What they get for it is a *refused*
entry, never code execution: the decoder is non-executable, and adoption
is still gated behind the independent keyed page-digest-chain
recomputation against the digests the REQUESTER derived locally
(:meth:`KVFabric._validate`, :meth:`HandoffBundle.verify_prompt_digests`).
A hostile wire can cost latency, never a wrong token and never control
of the process.
"""
import json
import math
import struct

import numpy as np

__all__ = ["WireFormatError", "encode", "decode"]

_JLEN = struct.Struct(">Q")

#: the ONLY dtypes the decoder will materialize — numeric data, no
#: object/void/structured dtypes (those are pickle's attack surface
#: wearing a numpy hat)
_DTYPES = {name: np.dtype(name) for name in (
    "bool", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64",
    "float16", "float32", "float64")}
# (numpy has no bfloat16: the engine exports bf16 pools as float32, exactly)


class WireFormatError(ValueError):
    """The bytes do not decode under this format (or the tree holds a
    type the format refuses to express). Callers at the digest gate
    surface this as their typed corrupt error."""


def _enc(node, heap):
    if node is None or isinstance(node, (bool, str)):
        return node
    if isinstance(node, (int, float)):
        return node
    if isinstance(node, np.generic):        # numpy scalar -> python scalar
        return _enc(node.item(), heap)
    if isinstance(node, (bytes, bytearray, memoryview)):
        return {"b": bytes(node).hex()}
    if isinstance(node, tuple):
        return {"t": [_enc(v, heap) for v in node]}
    if isinstance(node, list):
        return {"l": [_enc(v, heap) for v in node]}
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if not isinstance(k, str):
                raise WireFormatError(
                    f"dict key {k!r} is not a str: not wire-encodable")
            out[k] = _enc(v, heap)
        return {"d": out}
    if isinstance(node, np.ndarray):
        a = np.ascontiguousarray(node)
        name = a.dtype.name
        if name not in _DTYPES:
            raise WireFormatError(f"dtype {name!r} is not wire-encodable")
        off = len(heap)
        heap.extend(a.tobytes())
        return {"a": [name, list(a.shape), off, a.nbytes]}
    raise WireFormatError(
        f"type {type(node).__name__} is not wire-encodable")


def encode(tree):
    """Serialize ``tree`` (the closed type set above) to bytes."""
    heap = bytearray()
    spec = json.dumps(_enc(tree, heap), separators=(",", ":")).encode("utf-8")
    return _JLEN.pack(len(spec)) + spec + bytes(heap)


def _dec(node, heap):
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    if isinstance(node, dict) and len(node) == 1:
        (tag, val), = node.items()
        if tag == "b" and isinstance(val, str):
            try:
                return bytes.fromhex(val)
            except ValueError:
                raise WireFormatError("malformed hex bytes leaf")
        if tag == "t" and isinstance(val, list):
            return tuple(_dec(v, heap) for v in val)
        if tag == "l" and isinstance(val, list):
            return [_dec(v, heap) for v in val]
        if tag == "d" and isinstance(val, dict):
            return {k: _dec(v, heap) for k, v in val.items()}
        if tag == "a" and isinstance(val, list) and len(val) == 4:
            name, shape, off, nbytes = val
            dt = _DTYPES.get(name)
            if (dt is None or not isinstance(shape, list)
                    or not all(isinstance(d, int) and d >= 0 for d in shape)
                    or not isinstance(off, int) or not isinstance(nbytes, int)
                    or off < 0 or nbytes < 0 or off + nbytes > len(heap)
                    or math.prod(shape) * dt.itemsize != nbytes):
                raise WireFormatError("malformed array leaf")
            return np.frombuffer(
                heap[off:off + nbytes], dt).reshape(shape)
    raise WireFormatError(f"unknown spec node {node!r:.80}")


def decode(data):
    """Inverse of :func:`encode`. Raises :class:`WireFormatError` on any
    structural defect; never constructs anything beyond the closed type
    set (decoded arrays are read-only views into ``data``)."""
    if len(data) < _JLEN.size:
        raise WireFormatError("wire payload shorter than its header")
    (jlen,) = _JLEN.unpack_from(data)
    if len(data) < _JLEN.size + jlen:
        raise WireFormatError("wire spec truncated")
    try:
        spec = json.loads(bytes(data[_JLEN.size:_JLEN.size + jlen])
                          .decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireFormatError(f"wire spec unparsable: {e}")
    return _dec(spec, memoryview(data)[_JLEN.size + jlen:])
