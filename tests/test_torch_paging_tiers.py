"""The port's KV-hierarchy building blocks (``dcos_commons_tpu_torch/
models/paging.py`` and ``models/disagg.py``) against the JAX package's
(``tests/test_paging_tiers.py``): KVPAGE1 page frames and KVSPAN1 spans
byte-identical to the reference's for fp32, bf16 and int8 payloads and
unpacked across in both directions, chain keys, the truncation and
bit-flip fuzz, the tier store's LRU spill and drop, its rejection of
corrupt disk frames and its ``disk_dir`` requirement, the prefix
directory's staleness and ``exclude``, and the radix's demote seam.
Frames and bytes are held exactly."""

import json
import random
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import disagg as jdisagg
from dcos_commons_tpu.models import paging as jpaging
from dcos_commons_tpu_torch.models import disagg as tdisagg
from dcos_commons_tpu_torch.models import paging as tpaging

KINDS = ("fp32", "bf16", "int8")


def _payload(seed=0, kind="fp32", pages=1):
    """Synthetic K/V in the gathered span layout ``[layers, pages,
    page, kv_heads, head_dim]``, as numpy (bf16 through ml_dtypes, the
    reference's host type). int8 scales are bf16, as a quantized pool
    holds them."""
    rng = np.random.default_rng(seed)
    shape = (2, pages, 8, 1, 4)
    if kind == "int8":
        return {side: {"q": rng.integers(-128, 127, shape, dtype=np.int8),
                       "s": rng.random(shape[:-1] + (1,)).astype(
                           ml_dtypes.bfloat16)}
                for side in ("k", "v")}
    dt = ml_dtypes.bfloat16 if kind == "bf16" else np.float32
    return {side: rng.random(shape).astype(dt) for side in ("k", "v")}


def _entry(seed=0, kind="fp32"):
    tokens = list(range(8))
    return {"chain": jpaging.chain_keys(tokens, 8)[-1],
            "page_hash": jpaging.page_hashes(tokens, 8)[-1],
            "kv_quant": kind == "int8", "payload": _payload(seed, kind)}


def _bits(x):
    """An array's (dtype name, shape, bytes), for a tensor or an array."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).split(".")[-1]
        raw = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x)
        return name, tuple(x.shape), raw.contiguous().numpy().tobytes()
    a = np.asarray(x)
    return a.dtype.name, a.shape, a.tobytes()


def _assert_payload_equal(a, b):
    for side in ("k", "v"):
        if isinstance(a[side], dict):
            for part in ("q", "s"):
                assert _bits(a[side][part]) == _bits(b[side][part])
        else:
            assert _bits(a[side]) == _bits(b[side])


def _torch_payload(payload):
    """The same payload as CPU torch tensors (bf16 through uint16)."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return {side: ({k: conv(v) for k, v in val.items()}
                   if isinstance(val, dict) else conv(val))
            for side, val in payload.items()}


# ------------------------------------------------------------ identities


def test_chain_keys_are_the_reference_keys():
    rng = np.random.default_rng(3)
    for n, ps in ((40, 8), (7, 8), (130, 64), (64, 16)):
        prompt = [int(t) for t in rng.integers(0, 50000, n)]
        assert tpaging.chain_keys(prompt, ps) == \
            jpaging.chain_keys(prompt, ps)
    # the chain key depends on the whole prefix, not the page alone
    a, b = [1] * 8 + [2] * 8, [3] * 8 + [2] * 8
    assert tpaging.page_hashes(a, 8)[1] == tpaging.page_hashes(b, 8)[1]
    assert tpaging.chain_keys(a, 8)[1] != tpaging.chain_keys(b, 8)[1]


# ------------------------------------------------------- KVPAGE1 frames


@pytest.mark.parametrize("kind", KINDS)
def test_page_frame_bytes_are_the_reference_bytes(kind):
    """numpy payloads and the same payloads as torch tensors pack to the
    reference's bytes; each side unpacks the other's frame."""
    entry = _entry(seed=1, kind=kind)
    want = jpaging.pack_page_frame(entry)
    assert tpaging.pack_page_frame(entry) == want
    as_torch = dict(entry, payload=_torch_payload(entry["payload"]))
    assert tpaging.pack_page_frame(as_torch) == want
    ours = tpaging.unpack_page_frame(want, chain=entry["chain"])
    assert ours["chain"] == entry["chain"]
    assert ours["page_hash"] == entry["page_hash"]
    assert ours["kv_quant"] == (kind == "int8")
    _assert_payload_equal(ours["payload"], entry["payload"])
    # a promoted-then-re-demoted page packs as its own dtype again
    assert tpaging.pack_page_frame(ours) == want
    theirs = jpaging.unpack_page_frame(tpaging.pack_page_frame(as_torch),
                                       chain=entry["chain"])
    _assert_payload_equal(theirs["payload"], entry["payload"])


def test_page_frame_rejects_wrong_chain_and_magic():
    frame = tpaging.pack_page_frame(_entry())
    with pytest.raises(tpaging.PageFrameError, match="magic"):
        tpaging.unpack_page_frame(b"NOTAPAGE" + frame[8:])
    with pytest.raises(tpaging.PageFrameError, match="chain"):
        tpaging.unpack_page_frame(frame, chain="0" * 16)


@pytest.mark.parametrize("kind", KINDS)
def test_page_frame_fuzz_truncation_and_bitflips(kind):
    """Every truncation point of the reference's fuzz and a spray of
    single-bit flips either round-trip IDENTICALLY or raise
    PageFrameError, never a crash; the reference agrees on each flip."""
    frame = tpaging.pack_page_frame(_entry(seed=7, kind=kind))
    clean = tpaging.unpack_page_frame(frame)
    rng = random.Random(0x4B5041)
    cuts = {0, 4, 8, 10, 12, len(frame) - 1} | {
        rng.randrange(len(frame)) for _ in range(24)}
    for cut in sorted(cuts):
        with pytest.raises(tpaging.PageFrameError):
            tpaging.unpack_page_frame(frame[:cut])
    for _ in range(48):
        flipped = bytearray(frame)
        i = rng.randrange(len(frame))
        flipped[i] ^= 1 << rng.randrange(8)
        try:
            back = tpaging.unpack_page_frame(bytes(flipped))
        except tpaging.PageFrameError:
            with pytest.raises(jpaging.PageFrameError):
                jpaging.unpack_page_frame(bytes(flipped))
            continue
        assert back["chain"] == clean["chain"]
        _assert_payload_equal(back["payload"], clean["payload"])


# --------------------------------------------------------- KVSPAN1 spans


def _span(kind, seed=2, pages=3):
    prompt = [int(t) for t in np.random.default_rng(seed).integers(
        0, 256, pages * 8)]
    return {"version": 1, "prompt": prompt, "first_token": -1,
            "page_size": 8, "kv_quant": kind == "int8",
            "payload": _payload(seed, kind, pages)}


@pytest.mark.parametrize("kind", KINDS)
def test_span_bytes_are_the_reference_bytes(kind):
    span = _span(kind)
    want = jdisagg.pack_span(span)
    assert tdisagg.pack_span(span) == want
    as_torch = dict(span, payload=_torch_payload(span["payload"]))
    assert tdisagg.pack_span(as_torch) == want
    ours = tdisagg.unpack_span(want)
    assert ours["prompt"] == span["prompt"]
    assert ours["page_hashes"] == jpaging.page_hashes(span["prompt"], 8)
    _assert_payload_equal(ours["payload"], span["payload"])
    assert tdisagg.pack_span(ours) == want
    theirs = jdisagg.unpack_span(tdisagg.pack_span(as_torch))
    _assert_payload_equal(theirs["payload"], span["payload"])


def test_span_rejects_corruption_and_https():
    frame = tdisagg.pack_span(_span("fp32"))
    with pytest.raises(tdisagg.PageShipError, match="magic"):
        tdisagg.unpack_span(b"X" + frame[1:])
    body = bytearray(frame)
    body[-1] ^= 1
    with pytest.raises(tdisagg.PageShipError, match="digest"):
        tdisagg.unpack_span(bytes(body))
    for cut in (3, 10, len(frame) - 5):
        with pytest.raises(tdisagg.PageShipError):
            tdisagg.unpack_span(frame[:cut])
    # a prompt edited under its page hashes: the header no longer agrees
    hlen = struct.unpack_from("<I", frame, 8)[0]
    meta = json.loads(frame[12:12 + hlen])
    meta["prompt"][0] += 1
    header = json.dumps(meta).encode()
    edited = (frame[:8] + struct.pack("<I", len(header)) + header
              + frame[12 + hlen:])
    with pytest.raises(jdisagg.PageShipError, match="prefix-hash"):
        jdisagg.unpack_span(edited)
    with pytest.raises(tdisagg.PageShipError, match="prefix-hash"):
        tdisagg.unpack_span(edited)
    with pytest.raises(tdisagg.PageShipError, match="https"):
        tdisagg._transport_urlopen(
            tdisagg.urllib.request.Request("https://peer:1/v1/prefix"), 1)
    # the fetch is an optimization: an unreachable peer is a miss
    assert tdisagg.fetch_prefix("http://127.0.0.1:9", [1, 2, 3],
                                timeout_s=2) is None


# ------------------------------------------------------------ tier store


def _filed(i, kind="fp32"):
    e = _entry(seed=i, kind=kind)
    e["chain"] = f"{i:016x}"
    return e


def test_tier_store_host_lru_spills_to_disk_then_drops(tmp_path):
    """The reference's sequence on both stores: newest 2 on host, next 2
    spilled to disk, oldest dropped; equal stats and disk files."""
    stores = {}
    for name, mod in (("port", tpaging), ("jax", jpaging)):
        d = tmp_path / name
        store = mod.PageTierStore(host_pages=2, disk_dir=str(d),
                                  disk_pages=2)
        for i in range(5):
            store.put(_filed(i)["chain"], _filed(i))
        stores[name] = (store, d)
    store, d = stores["port"]
    assert store.host_count() == 2 and store.disk_count() == 2
    assert not store.has("0000000000000000")
    assert store.stats() == stores["jax"][0].stats()
    files = sorted(p.name for p in d.iterdir())
    assert files == sorted(p.name for p in stores["jax"][1].iterdir())
    for name in files:                     # the same frames on disk
        assert (d / name).read_bytes() == \
            (stores["jax"][1] / name).read_bytes()
    chain = sorted(store.chains())[0]
    back = store.take(chain)
    _assert_payload_equal(back["payload"],
                          _filed(int(chain, 16))["payload"])
    assert not store.has(chain)
    assert store.take(chain) is None       # POP semantics: gone
    st = store.stats()
    assert st["misses"] == 1 and st["disk_hits"] == 1
    assert set(st) == set(stores["jax"][0].stats())
    assert store.discard(sorted(store.chains())[0])
    assert store.stats()["discarded"] == 1
    store.clear()
    assert store.chains() == [] and list(d.iterdir()) == []


def test_tier_store_rejects_corrupt_disk_frame(tmp_path):
    store = tpaging.PageTierStore(host_pages=1, disk_dir=str(tmp_path),
                                  disk_pages=4)
    a, b = _filed(0xA, "int8"), _filed(0xB, "int8")
    store.put(a["chain"], a)
    store.put(b["chain"], b)               # displaces a to disk
    assert store.disk_count() == 1
    path = tmp_path / f"{a['chain']}.kvpage"     # content-addressed
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF           # bit-rot the body
    path.write_bytes(bytes(blob))
    assert store.take(a["chain"]) is None  # the digest check rejects it
    assert store.stats()["corrupt_frames"] == 1
    assert not store.has(a["chain"])
    store.put(a["chain"], a)
    c = _filed(0xC, "int8")
    store.put(c["chain"], c)               # displaces a to disk again
    path.write_bytes(path.read_bytes()[:10])
    assert store.take(a["chain"]) is None  # truncation dies the same way
    assert store.stats()["corrupt_frames"] == 2
    # a host hit still round-trips the int8 payload, bf16 scales included
    _assert_payload_equal(store.take(c["chain"])["payload"], c["payload"])


def test_tier_store_requires_dir_for_disk_pages():
    with pytest.raises(ValueError, match="disk_dir"):
        tpaging.PageTierStore(host_pages=1, disk_pages=4)
    with pytest.raises(ValueError, match=">= 0"):
        tpaging.PageTierStore(host_pages=-1)


# ------------------------------------------------------- prefix directory


def test_directory_staleness_and_exclude_match_the_reference():
    out = {}
    for name, mod in (("port", tpaging), ("jax", jpaging)):
        clock = [0.0]
        d = mod.PrefixDirectory(max_age_s=5.0, clock=lambda: clock[0])
        seen = []
        d.publish("r1", ["c1", "c2"])
        clock[0] = 3.0
        d.publish("r2", ["c1"])
        seen += [d.lookup("c1", exclude="r2"), d.lookup("c1")]
        clock[0] = 6.0                     # r1's claim is now stale
        seen += [d.lookup("c1"), d.holders("c1")]
        clock[0] = 20.0
        seen += [d.lookup("c1"), d.lookup("c2")]
        d.publish("r3", ["c9"])
        d.forget("r3")
        seen += [d.lookup("c9"), d.lookup("c1", exclude="r1")]
        out[name] = (seen, d.stats())
    assert out["port"] == out["jax"]
    seen, st = out["port"]
    assert seen[:4] == ["r1", "r2", "r2", ["r2"]]
    assert seen[4:] == [None] * 4
    assert st["stale_drops"] >= 2 and st["misses"] >= 2


# ------------------------------------------------------ radix demote seam


def test_radix_evict_demotes_each_victim_before_its_unref():
    """The demoter sees every victim with its prefix tokens while the
    page still holds its last reference, in the reference's order."""
    calls = {}
    for name, mod in (("port", tpaging), ("jax", jpaging)):
        pool = mod.PagePool(8, 4)
        radix = mod.PrefixRadix(pool)
        a, b = list(range(12)), list(range(8)) + [9, 9, 9, 9]
        for prompt in (a, b):
            pages = pool.alloc(3)
            radix.insert(prompt, pages)
            for p in pages:
                pool.unref(p)
        assert radix.size() == 4
        seen = []
        radix.evict(8, demoter=lambda page, toks: seen.append(
            (page, toks, pool.refcount(page))))
        calls[name] = seen
        assert radix.size() == 0 and pool.free_count() == 8
        pool2 = mod.PagePool(4, 4)
        radix2 = mod.PrefixRadix(pool2)
        radix2.insert(a, pool2.alloc(3))
        radix2.clear()
        assert radix2.size() == 0 and pool2.free_count() == 1
    assert calls["port"] == calls["jax"]
    assert all(ref == 1 for _, _, ref in calls["port"])
    assert sorted(len(t) for _, t, _ in calls["port"]) == [4, 8, 12, 12]
