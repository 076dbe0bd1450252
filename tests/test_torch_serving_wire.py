"""Port parity: the KV handoff's wire layer against the JAX package's, on
the CPU (the port's own copies of ``serving/wireformat.py``,
``handoff.py``, ``transport.py`` and ``kvfabric.py``):

- the wire encoding: the same trees encode to the same bytes, bit for
  bit, and decode back equal; hostile or torn specs are refused alike
  (the same error type and message);
- handoff bundles: the page-digest chain, the framed bytes, each
  package decoding the other's frames, torn frames refused alike; the
  spool manager's retried publish, stale and corrupt bundles, on an
  injected clock;
- the wire transport: blob frames bit for bit, and a bundle published by
  one package's client to the other's ``KVPageServer`` over a loopback
  socket and loaded back;
- the fabric: the host spill ring's LRU evictions under byte and entry
  bounds, residency and ``resident_owners``, and the tier ladder's hits
  and typed fallthroughs (corrupt, fetch_failed, timeout, partition,
  peer_saturated, peer_fetch_shed) for the same scripted peers.
Exact equality throughout: no arithmetic here rounds.
"""
import hashlib
import json
import struct

import numpy as np
import pytest

from paddle_tpu.observability.metrics import registry as ref_registry
from paddle_tpu.serving import handoff as ref_handoff
from paddle_tpu.serving import kvfabric as ref_kvfabric
from paddle_tpu.serving import transport as ref_transport
from paddle_tpu.serving import wireformat as ref_wire
from paddle_tpu.testing import chaos as ref_chaos
from paddle_tpu_torch.observability.metrics import registry as port_registry
from paddle_tpu_torch.serving import handoff as port_handoff
from paddle_tpu_torch.serving import kvfabric as port_kvfabric
from paddle_tpu_torch.serving import transport as port_transport
from paddle_tpu_torch.serving import wireformat as port_wire
from paddle_tpu_torch.testing import chaos as port_chaos

RNG = np.random.RandomState(11)
TREES = {
    "scalars": {"a": None, "b": True, "c": 3, "d": -2.5, "e": "xé"},
    "nested": {"t": (1, [2, (3, b"\x00\xff")]), "l": [[], {}, ()]},
    "arrays": {"f32": RNG.randn(2, 3, 4).astype(np.float32),
               "i8": RNG.randint(-128, 127, (5, 7)).astype(np.int8),
               "i32": np.arange(6, dtype=np.int32).reshape(2, 3)[:, ::2],
               "empty": np.zeros((0, 3), np.float16),
               "scalar": np.float64(1.25)},
    "payload": {"n_pages": 2,
                "ks": RNG.randn(2, 32, 2, 16).astype(np.float32),
                "vs": RNG.randn(2, 32, 2, 16).astype(np.float32)},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_wire_encoding_is_bit_identical(name):
    got = port_wire.encode(TREES[name])
    want = ref_wire.encode(TREES[name])
    assert got == want
    back = port_wire.decode(want)
    again = port_wire.encode(back)
    assert again == want


def _spec(tree, heap=b""):
    spec = json.dumps(tree).encode()
    return struct.pack(">Q", len(spec)) + spec + heap


HOSTILE = {
    "short_header": b"\x00\x00",
    "truncated_spec": struct.pack(">Q", 50) + b"{}",
    "not_json": _spec(None)[:8] + b"\xff" + _spec(None)[9:],
    "unknown_tag": _spec({"exec": "os.system"}),
    "object_dtype": _spec({"a": ["object", [1], 0, 8]}, b"\x00" * 8),
    "array_past_heap": _spec({"a": ["float32", [4], 0, 16]}, b"\x00" * 8),
    "negative_offset": _spec({"a": ["int8", [2], -1, 2]}, b"\x00" * 4),
    "shape_mismatch": _spec({"a": ["int32", [3], 0, 8]}, b"\x00" * 8),
    "bad_hex": _spec({"b": "zz"}),
    "two_key_node": _spec({"l": [], "d": {}}),
}


@pytest.mark.parametrize("name", sorted(HOSTILE))
def test_hostile_wire_specs_are_refused_alike(name):
    outcomes = []
    for mod in (ref_wire, port_wire):
        with pytest.raises(mod.WireFormatError) as e:
            mod.decode(HOSTILE[name])
        outcomes.append(str(e.value))
    assert outcomes[0] == outcomes[1]


def test_unencodable_trees_are_refused_alike():
    for tree in ({1: "int key"}, {"f": lambda: 0}, {"o": np.array([object()])}):
        msgs = []
        for mod in (ref_wire, port_wire):
            with pytest.raises(mod.WireFormatError) as e:
                mod.encode(tree)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ---- handoff bundles ---------------------------------------------------------
PROMPT = RNG.randint(1, 1000, 53).astype(np.int32)


def _bundle(mod, generation=0):
    return mod.HandoffBundle(
        rid=7, seed=3, sampling=(True, 0.8, 0, 0.9), prompt=PROMPT,
        tokens=[5, 9], n_generated=2, n_dispatched=4, max_new_tokens=16,
        eos_token_id=None, timeout_s=None, payloads=TREES["payload"],
        digests=mod.page_digests(PROMPT, 16, 3), page_size=16,
        generation=generation)


def test_bundle_digests_and_frames_are_bit_identical():
    assert (port_handoff.page_digests(PROMPT, 16, 3)
            == ref_handoff.page_digests(PROMPT, 16, 3))
    got, want = _bundle(port_handoff).to_bytes(), _bundle(ref_handoff)\
        .to_bytes()
    assert got == want
    for data, mod in ((want, port_handoff), (got, ref_handoff)):
        b = mod.HandoffBundle.from_bytes(data)
        b.verify_prompt_digests()
        assert (b.rid, b.tokens, b.n_dispatched, b.sampling) == (
            7, [5, 9], 4, (True, 0.8, 0, 0.9))
        np.testing.assert_array_equal(b.payloads["ks"],
                                      TREES["payload"]["ks"])


@pytest.mark.parametrize("cut", ["magic", "length", "digest", "payload",
                                 "prompt_chain"])
def test_torn_bundles_are_refused_alike(cut):
    msgs = []
    for mod in (ref_handoff, port_handoff):
        b = _bundle(mod)
        if cut == "prompt_chain":
            b.prompt = PROMPT.copy()
            b.prompt[3] += 1
        data = bytearray(b.to_bytes())
        if cut == "magic":
            data[0] ^= 1
        elif cut == "length":
            data = data[:-5]
        elif cut == "digest":
            data[10] ^= 1
        elif cut == "payload":
            data[-1] ^= 1
        with pytest.raises(mod.HandoffCorruptError) as e:
            mod.HandoffBundle.from_bytes(bytes(data)).verify_prompt_digests()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _spool_script(mod, chaos, tmp):
    """Publish with two injected send faults (retried on the injected
    clock), load, a stale generation, a torn commit; the transcript."""
    t = [0.0]
    sleeps = []

    def sleep(s):
        sleeps.append(round(s, 9))
        t[0] += s

    mgr = mod.HandoffManager(spool_dir=str(tmp), deadline_s=1.0, retries=3,
                             backoff_s=0.05, clock=lambda: t[0],
                             sleep=sleep)
    out = []
    with chaos.FaultPlan().fail("serving.handoff.send", times=2):
        path = mgr.publish(_bundle(mod))
    out.append((path.rsplit("/", 1)[-1], sleeps))
    b = mgr.load(path, expected_generation=0)
    out.append((b.rid, b.tokens, sorted(b.payloads)))
    path = mgr.publish(_bundle(mod, generation=1))
    try:
        mgr.load(path, expected_generation=2)
    except mod.StaleHandoffError as e:
        out.append(("stale", str(e)))
    with chaos.FaultPlan().truncate("serving.handoff.corrupt", keep_bytes=40):
        path = mgr.publish(_bundle(mod, generation=2))
    try:
        mgr.load(path)
    except mod.HandoffCorruptError as e:
        # (the frame's length varies with the publish time's digits)
        out.append(("corrupt", str(e).split(":")[0]))
    with chaos.FaultPlan().fail("serving.handoff.send", times=None):
        try:
            mgr.publish(_bundle(mod, generation=3))
        except mod.HandoffError as e:
            out.append(("exhausted", str(e).split(":")[0], sleeps[2:]))
    out.append(sorted(p.name for p in tmp.iterdir()))
    return out


def test_spool_publish_retry_stale_and_corrupt_match(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = _spool_script(ref_handoff, ref_chaos, tmp_path / "ref")
    got = _spool_script(port_handoff, port_chaos, tmp_path / "port")
    assert got == want


# ---- the wire transport --------------------------------------------------------
def test_blob_frames_are_bit_identical_and_torn_ones_refused_alike():
    payload = port_wire.encode(TREES["arrays"])
    assert port_transport.frame_blob(payload) == ref_transport.frame_blob(
        payload)
    framed = port_transport.frame_blob(payload)
    for bad in (framed[:-1], b"XX" + framed[2:], framed[:20]):
        msgs = []
        for mod, hmod in ((ref_transport, ref_handoff),
                          (port_transport, port_handoff)):
            with pytest.raises(hmod.HandoffCorruptError) as e:
                mod.unframe_blob(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("client,server", [("port", "ref"), ("ref", "port")])
def test_bundles_cross_the_wire_between_packages(client, server):
    mods = {"port": (port_transport, port_handoff),
            "ref": (ref_transport, ref_handoff)}
    srv = mods[server][0].KVPageServer()
    try:
        tmod, hmod = mods[client]
        wt = tmod.WireTransport(endpoint=srv.endpoint, deadline_s=5.0)
        token = wt.publish(_bundle(hmod, generation=4))
        b = wt.load(token, expected_generation=4)
        b.verify_prompt_digests()
        np.testing.assert_array_equal(b.payloads["vs"],
                                      TREES["payload"]["vs"])
        blob = tmod.frame_blob(b"fabric entry")
        wt.put_blob("k1", blob)
        assert wt.fetch_blob(srv.endpoint, "k1") == blob
        wt.delete_blob("k1")
        assert wt.fetch_blob(srv.endpoint, "k1") is None
        with pytest.raises(hmod.StaleHandoffError):
            wt.load(wt.publish(_bundle(hmod, generation=5)),
                    expected_generation=6)
        assert len(srv) == 0
        wt.close()
    finally:
        srv.stop()


# ---- the fabric ----------------------------------------------------------------
def _counter_deltas(registry, names, before):
    return {n: (registry.get(n).value if registry.get(n) is not None
                else 0) - before.get(n, 0) for n in names}


def _fabric_script(kv, hmod, tmod, registry):
    names = ["kv.fallthroughs"] + [
        f'kv.fallthrough{{reason="{r}"}}' for r in
        ("corrupt", "fetch_failed", "timeout", "partition",
         "peer_saturated", "peer_fetch_shed")] + [
        f'kv.hits{{tier="{t}"}}' for t in ("host", "peer")]
    before = {n: (registry.get(n).value if registry.get(n) is not None
                  else 0) for n in names}
    out = []
    ring = kv.HostSpillRing(max_bytes=3000, max_entries=3)
    for i, size in enumerate((1000, 900, 1200, 200, 5000, 100)):
        out.append((ring.put(f"k{i}", b"x" * size), len(ring), ring.nbytes))
    out.append(ring.get("k3") is not None)
    fab = kv.KVFabric(name="frontend",
                      spill=kv.HostSpillRing(max_bytes=1 << 20,
                                             max_entries=8))
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 500, n).astype(np.int32) for n in (40, 70)]
    payload = {"n_pages": 2, "ks": np.ones((1, 32, 1, 4), np.float32)}
    fab.advertise_prompt(prompts[0], 16, "replica0")
    fab.advertise_prompt(prompts[1][:33], 16, "replica1")
    out.append(fab.resident_owners(prompts[1], 16))
    out.append(fab.resident_owners(prompts[0], 16))
    out.append((fab.residency_count("replica0"),
                fab.residency_count("replica1")))
    key = fab.spill_prefix(prompts[0], 16, payload, owner="replica0")
    got = fab.acquire(prompts[0], 16)
    out.append((key, got[1], got[0]["n_pages"]))
    # a torn ring entry: discarded, counted, the walk continues
    fab.spill.put(key, fab.spill.get(key)[:-3])
    out.append(fab.acquire(prompts[0], 16))
    # peers: each fails its own typed way, then one answers
    entry = {"n_pages": 2, "page_size": 16, "prompt": prompts[1][:32],
             "payload": payload}
    good = tmod.frame_blob(port_wire.encode(entry))

    def raiser(exc):
        def fetch(key):
            raise exc
        return fetch

    fab.advertise_prompt(prompts[1][:32], 16, "replica2")
    fab.advertise_prompt(prompts[1][:32], 16, "replica3")
    fab.advertise_prompt(prompts[1][:32], 16, "replica4")
    fab.register_peer("replica1", raiser(tmod.KVFetchTimeout("slow")))
    fab.register_peer("replica2", raiser(tmod.KVPartitionError("gone")))
    fab.register_peer("replica3", lambda key: good[:-1])
    fab.register_peer("replica4", lambda key: None)
    out.append(fab.acquire(prompts[1], 16))
    out.append(fab.acquire(prompts[1], 16, allow_peer=False))
    fab.set_peer_load("replica3", 0.99)
    fab.register_peer("replica4", lambda key: good)
    got = fab.acquire(prompts[1], 16)
    out.append((got[1], got[0]["n_pages"], fab.peer_load("replica3")))
    out.append(fab.evict_replica("replica1"))
    rep = fab.report()
    out.append({k: v for k, v in rep.items() if k != "metrics"})
    out.append(_counter_deltas(registry, names, before))
    return out


def test_fabric_ring_residency_and_tier_ladder_match():
    want = _fabric_script(ref_kvfabric, ref_handoff, ref_transport,
                          ref_registry)
    got = _fabric_script(port_kvfabric, port_handoff, port_transport,
                         port_registry)
    assert got == want


def test_fabric_digests_are_the_engine_chain():
    """The fabric keys prefixes by the engine's own digest chain (the
    port's ``_page_digests``), as the reference's does."""
    from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine

    h = b""
    want = []
    for j in range(3):
        h = hashlib.blake2b(PROMPT[j * 16:(j + 1) * 16].tobytes(), key=h,
                            digest_size=16).digest()
        want.append(h)
    assert port_handoff.page_digests(PROMPT, 16, 3) == want
    assert ContinuousBatchingEngine._page_digests(
        type("E", (), {"page_size": 16})(), PROMPT, 3) == want
    assert port_kvfabric.prefix_key(want, 3) == ref_kvfabric.prefix_key(
        want, 3)
