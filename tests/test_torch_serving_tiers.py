"""The port's paged engine with its KV hierarchy
(``dcos_commons_tpu_torch/models/serving.py:PagedServer(tiers=...,
directory=..., peer_fetch=...)``) against the JAX ``PagedServer`` with
the same settings, on the cases of ``tests/test_paging_tiers.py``: the
tiny 2-layer model (``max_seq`` 64, page 8), weights carried over from
the JAX init.

For fp32, bf16 and int8 pools: a cached prefix demoted through the one
demote seam (host tier spilling to disk) and promoted back decodes the
JAX engine's tokens with the JAX engine's tier counters, and the
promoted pages are bit-equal to the port's own pre-demote gather. Then
the corrupt-frame fallback, the promote-during-evict race, frames the
JAX engine demoted promoting in the port, fleet adoption against
recompute, a stale directory hint, ``/v1/prefix`` adoption over HTTP
between two port front doors, ``reset``, and one case each with a draft
armed and with a dropless MoE. After every case no chain is both in the
radix and in the tiers. Tokens are exact in fp32 (bf16: the prompts'
argmaxes are tie-free); frames and bytes exact."""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import paging as jpaging
from dcos_commons_tpu.models import serving as js
from dcos_commons_tpu.parallel import aot as jaot
from dcos_commons_tpu.parallel import moe as jmoe
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import paging as tpaging
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.models.disagg import fetch_prefix
from dcos_commons_tpu_torch.models.ingress import ServingFrontend
from dcos_commons_tpu_torch.ops.quant import QTensor
from dcos_commons_tpu_torch.parallel import moe as tmoe

ENGINE = dict(slots=2, page_size=8, prefill_chunk=8)
_MODELS = {}


@pytest.fixture(scope="module")
def jax_cache():
    """One JAX compile cache for the module: every JAX engine of one
    geometry shares the first one's executables."""
    return jaot.CompileCache()


def _model(kind="fp32"):
    """(JAX cfg, port cfg, JAX params, port params) for a pool kind:
    fp32, bf16 or int8 (int8 K/V with bf16 scales, fp32 compute)."""
    if kind not in _MODELS:
        dt = "bf16" if kind == "bf16" else "fp32"
        jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                    "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
        kw = dict(n_layers=2, max_seq=64, kv_quant=kind == "int8")
        jcfg = jl.LlamaConfig.tiny(attn_impl="dense", dtype=jdt, **kw)
        tcfg = tl.LlamaConfig.tiny(dtype=tdt, **kw)
        jp = jl.init_params(jcfg, jax.random.key(0))
        _MODELS[kind] = (jcfg, tcfg, jp,
                         params_from_jax(jax.device_get(jp), device="cpu"))
    return _MODELS[kind]


def _prompt(seed, n, vocab=256):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, n)]


def _engines(kind, jax_cache, jkw=None, tkw=None):
    """(JAX engine, port engine) of ``kind`` with the given extras."""
    jcfg, tcfg, jp, tp = _model(kind)
    jeng = js.PagedServer(jcfg, jp, compile_cache=jax_cache,
                          **ENGINE, **(jkw or {}))
    teng = ts.PagedServer(tcfg, tp, device="cpu", **ENGINE, **(tkw or {}))
    return jeng, teng


def _tail_chains(eng):
    """Chain key of every node resident in the engine's radix."""
    return {tpaging.chain_keys(eng.radix.prefix_tokens(node),
                               eng.page_size)[-1]
            for node in eng.radix._iter_nodes()}


def _audit(eng):
    """Ledger and single-owner audit: every page accounted, and no
    chain in both the radix and the tier store."""
    assert eng.ledger_violations() == []
    if eng.tiers is not None:
        overlap = set(eng.tiers.chains()) & _tail_chains(eng)
        assert not overlap, overlap


def _bits(payload):
    """A gathered payload's arrays as bytes (bf16 through int16)."""
    out = []
    for side in ("k", "v"):
        val = payload[side]
        parts = [val["q"], val["s"]] if isinstance(val, dict) else [val]
        for t in parts:
            raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            out.append((str(t.dtype), tuple(t.shape),
                        raw.contiguous().numpy().tobytes()))
    return out


def _cached_gather(eng, prompt):
    """The port engine's radix pages of ``prompt`` gathered to the host
    (references taken and dropped again)."""
    shared, _ = eng.radix.lookup(prompt + [-1])
    try:
        return eng._gather_span(shared), len(shared)
    finally:
        for p in shared:
            eng.ledger.unref(p)


TIER_COUNTERS = ("tier_demoted_pages", "tier_promoted_pages",
                 "tier_fallbacks", "directory_hits", "directory_fallbacks",
                 "adopted_prefix_pages", "exported_prefixes")


def _counters(eng):
    st = eng.page_stats()
    return {k: st[k] for k in TIER_COUNTERS}, st["tiers"], st["directory"]


# ------------------------------------------- demote/promote round trips


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_demote_promote_roundtrip_matches_jax(kind, tmp_path, jax_cache):
    """Evict a cached prefix through the demote seam (one host page,
    the rest spilled to disk), hit it again: the promote lands before
    the stream prefills, the tokens are the JAX engine's, the counters
    and tier stats equal, and the promoted pages are bit-equal to the
    port's own gather before the demote."""
    def tiers(name):
        return (jpaging if name == "jax" else tpaging).PageTierStore(
            host_pages=1, disk_dir=str(tmp_path / name), disk_pages=8)

    jeng, teng = _engines(kind, jax_cache, dict(tiers=tiers("jax")),
                          dict(tiers=tiers("port")))
    prompt = _prompt({"fp32": 60, "bf16": 61, "int8": 62}[kind], 24)
    first = [{"prompt": prompt, "max_new": 6, "request_id": "a"}]
    again = [{"prompt": prompt, "max_new": 6, "request_id": "b"}]
    want_a = jeng.drain([dict(r) for r in first])
    got_a = teng.drain([dict(r) for r in first])
    assert got_a == want_a
    before, n = _cached_gather(teng, prompt)
    assert n == 3                          # 3 full prompt pages cached
    for eng in (jeng, teng):
        eng._evict(eng.ledger.pages)
    assert teng.tier_demoted_pages == 3
    assert teng.tiers.host_count() == 1 and teng.tiers.disk_count() == 2
    assert _tail_chains(teng) == set()
    want = jeng.drain([dict(r) for r in again])
    got = teng.drain([dict(r) for r in again])
    assert got == want and got["b"] == got["a"]
    assert teng.tier_promoted_pages == 2   # max_cover leaves >= 1 token
    assert _counters(teng) == _counters(jeng)
    assert teng.tiers.stats()["host_hits"] == 1
    assert teng.tiers.stats()["disk_hits"] == 1
    after, n2 = _cached_gather(teng, prompt)
    assert n2 == 3
    assert _bits(after) == _bits(before)   # bit-exact round trip
    _audit(teng)
    # packed again, the promoted pages give the frame of the demote (the
    # dtypes travel with the payload: bf16 stays "bfloat16")
    frames = [tpaging.pack_page_frame({"chain": "c", "page_hash": "h",
                                       "kv_quant": kind == "int8",
                                       "payload": p})
              for p in (before, after)]
    assert frames[0] == frames[1]


def test_corrupt_tier_frame_falls_back_to_recompute(tmp_path, jax_cache):
    """Bit-rotted disk frames die in the digest check at promote time:
    the stream recomputes, decodes the JAX engine's tokens, and both
    engines count the same fallback."""
    runs = {}
    for name, mod in (("jax", jpaging), ("port", tpaging)):
        d = tmp_path / name
        tiers = mod.PageTierStore(host_pages=0, disk_dir=str(d),
                                  disk_pages=8)
        jeng, teng = _engines("fp32", jax_cache, dict(tiers=tiers),
                              dict(tiers=tiers))
        eng = jeng if name == "jax" else teng
        prompt = _prompt(61, 24)
        eng.drain([{"prompt": prompt, "max_new": 5, "request_id": "a"}])
        eng._evict(eng.ledger.pages)
        assert tiers.disk_count() == 3
        for path in d.iterdir():           # rot every frame body
            blob = bytearray(path.read_bytes())
            blob[-3] ^= 0x55
            path.write_bytes(bytes(blob))
        runs[name] = (eng.drain([{"prompt": prompt, "max_new": 5,
                                  "request_id": "b"}]), _counters(eng),
                      eng)
    assert runs["port"][:2] == runs["jax"][:2]
    eng = runs["port"][2]
    assert eng.tier_promoted_pages == 0 and eng.tier_fallbacks == 1
    assert eng.tiers.stats()["corrupt_frames"] == 1
    assert runs["port"][0]["b"] == runs["port"][0]["a"]
    _audit(eng)


def test_promote_during_evict_race_resolves_to_one_owner(jax_cache):
    """The frames vanish between admission's plan and the promote (a
    concurrent promote took them): the plan falls back, the stream
    recomputes token-exact, the ledger stays clean."""
    _, teng = _engines("fp32", jax_cache,
                       tkw=dict(tiers=tpaging.PageTierStore(host_pages=8)))
    prompt = _prompt(62, 24)
    want = teng.drain([{"prompt": prompt, "max_new": 5,
                        "request_id": "a"}])["a"]
    teng._evict(teng.ledger.pages)
    assert teng.tiers.chains()
    teng.submit(prompt, 5, request_id="b")
    assert teng._pending_tier
    assert teng._prefill_q == type(teng._prefill_q)()  # deferred a step
    for chain in teng.tiers.chains():
        teng.tiers.discard(chain)
    for _ in range(64):
        teng.step()
        if "b" in teng.finished:
            break
    assert teng.finished["b"] == want
    assert teng.tier_fallbacks == 1 and teng.tier_promoted_pages == 0
    _audit(teng)


def test_jax_demoted_frames_promote_in_the_port(jax_cache):
    """Frames the JAX engine demoted, filed into the port's store,
    promote in the port engine: the reference's bytes install and decode
    the reference's tokens."""
    jtiers = jpaging.PageTierStore(host_pages=8)
    ttiers = tpaging.PageTierStore(host_pages=8)
    jeng, teng = _engines("fp32", jax_cache, dict(tiers=jtiers),
                          dict(tiers=ttiers))
    prompt = _prompt(63, 24)
    want = jeng.drain([{"prompt": prompt, "max_new": 6,
                        "request_id": "a"}])
    jeng._evict(jeng.ledger.pages)
    for chain in jtiers.chains():
        entry = jtiers.take(chain)
        frame = jpaging.pack_page_frame(entry)
        ttiers.put(chain, entry)
        assert tpaging.pack_page_frame(entry) == frame
    got = teng.drain([{"prompt": prompt, "max_new": 6, "request_id": "a"}])
    assert got == want
    assert teng.tier_promoted_pages == 2 and teng.tier_fallbacks == 0
    _audit(teng)


def test_reset_keeps_tier_frames_and_drops_pending_plans(jax_cache):
    _, teng = _engines("fp32", jax_cache,
                       tkw=dict(tiers=tpaging.PageTierStore(host_pages=8)))
    prompt = _prompt(64, 24)
    want = teng.drain([{"prompt": prompt, "max_new": 4,
                        "request_id": "a"}])["a"]
    teng._evict(teng.ledger.pages)
    teng.submit(prompt, 4, request_id="b")
    assert teng._pending_tier
    teng.reset()
    assert teng._pending_tier == [] and len(teng.tiers.chains()) == 3
    got = teng.drain([{"prompt": prompt, "max_new": 4, "request_id": "c"}])
    assert got["c"] == want and teng.tier_promoted_pages == 2
    _audit(teng)


# ------------------------------------------------------- fleet adoption


def _fleet(jax_cache, cls_kw_b):
    """Port replicas A and B on one directory; A serves the base
    prompt first."""
    _, tcfg, _, tp = _model("fp32")
    directory = tpaging.PrefixDirectory(max_age_s=60.0)
    a = ts.PagedServer(tcfg, tp, device="cpu", directory=directory,
                       replica_id="rep-a", **ENGINE)
    b = ts.PagedServer(tcfg, tp, device="cpu", directory=directory,
                       replica_id="rep-b", **ENGINE, **cls_kw_b(a))
    return directory, a, b


def _recompute(jax_cache, prompt, max_new):
    """The JAX engine's tokens for ``prompt`` with nothing cached."""
    jcfg, _, jp, _ = _model("fp32")
    return js.PagedServer(jcfg, jp, compile_cache=jax_cache, **ENGINE).drain(
        [{"prompt": prompt, "max_new": max_new, "request_id": "x"}])["x"]


def test_fleet_adoption_parity_vs_recompute(jax_cache):
    """B adopts A's cached prefix through the directory and
    ``export_prefix`` instead of recomputing: token-exact, with the
    pages bit-equal to A's."""
    directory, a, b = _fleet(jax_cache, lambda a: dict(
        peer_fetch=lambda holder, p: a.export_prefix(p)))
    base = _prompt(65, 24)
    a.drain([{"prompt": base, "max_new": 4, "request_id": "warm"}])
    chain = tpaging.chain_keys(base, 8)[-1]
    assert directory.lookup(chain, exclude="rep-b") == "rep-a"
    prompt = base + _prompt(66, 4)
    got = b.drain([{"prompt": prompt, "max_new": 6, "request_id": "x"}])
    assert got["x"] == _recompute(jax_cache, prompt, 6)
    assert b.directory_hits == 1 and b.adopted_prefix_pages == 3
    assert a.exported_prefixes == 1
    assert set(directory.holders(chain)) == {"rep-a", "rep-b"}
    assert _bits(_cached_gather(b, base)[0]) == \
        _bits(_cached_gather(a, base)[0])
    _audit(b)


def test_stale_directory_hint_recomputes_gracefully(jax_cache):
    """The hinted holder serves nothing: the fetch comes back empty and
    the stream recomputes, a fallback and never an error."""
    directory, _, b = _fleet(jax_cache, lambda a: dict(
        peer_fetch=lambda holder, p: None))
    base = _prompt(67, 16)
    directory.publish("rep-ghost", tpaging.chain_keys(base, 8))
    prompt = base + _prompt(68, 5)
    got = b.drain([{"prompt": prompt, "max_new": 5, "request_id": "x"}])
    assert got["x"] == _recompute(jax_cache, prompt, 5)
    assert b.directory_fallbacks == 1 and b.directory_hits == 0
    _audit(b)


def _post(url, path, payload, timeout=60):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def test_http_prefix_adoption_between_two_front_doors(jax_cache):
    """A serves its cached prefix over ``POST /v1/prefix`` (the export
    runs on A's engine thread); B, behind its own front door, adopts it
    through ``fetch_prefix`` when a request reaches B over HTTP, and
    answers the recompute's tokens. A miss probe answers None."""
    _, tcfg, _, tp = _model("fp32")
    directory = tpaging.PrefixDirectory(max_age_s=60.0)
    a = ts.PagedServer(tcfg, tp, device="cpu", directory=directory,
                       **ENGINE)
    fa = ServingFrontend(a, port=0, host="127.0.0.1")
    url_a = f"http://127.0.0.1:{fa.port}"
    a.replica_id = url_a         # the directory key IS the fetch address
    b = ts.PagedServer(tcfg, tp, device="cpu", directory=directory,
                       peer_fetch=lambda holder, p:
                           fetch_prefix(holder, p, timeout_s=30.0),
                       **ENGINE)
    fb = ServingFrontend(b, port=0, host="127.0.0.1")
    b.replica_id = f"http://127.0.0.1:{fb.port}"
    fa.start()
    fb.start()
    try:
        base = _prompt(69, 24)
        json.loads(_post(url_a, "/v1/generate",
                         {"prompt": base, "max_new": 4}))
        assert directory.lookup(tpaging.chain_keys(base, 8)[-1]) == url_a
        assert fetch_prefix(url_a, _prompt(70, 9)) is None
        prompt = base + _prompt(71, 4)
        got = json.loads(_post(b.replica_id, "/v1/generate",
                               {"prompt": prompt, "max_new": 6}))["tokens"]
        assert got == _recompute(jax_cache, prompt, 6)
        assert b.directory_hits == 1 and b.adopted_prefix_pages == 3
        assert a.exported_prefixes >= 1
        stats = json.loads(urllib.request.urlopen(
            url_a + "/v1/metrics", timeout=30).read())
        assert stats["counters"]["ingress.prefix_exports"] >= 1
    finally:
        fb.stop()
        fa.stop()
    _audit(b)


# ------------------------------------------------- draft and MoE engines


def test_tiers_with_a_draft_armed_match_jax(tmp_path, jax_cache):
    """A promote under speculation: the target's pages are installed,
    the draft still prefills the WHOLE prompt, so the streams, the
    acceptance and the tier counters equal the JAX engine armed with
    the same draft."""
    jcfg, tcfg, jp, tp = _model("fp32")
    jeng, teng = _engines(
        "fp32", jax_cache,
        dict(tiers=jpaging.PageTierStore(host_pages=8)),
        dict(tiers=tpaging.PageTierStore(host_pages=8)))
    jeng.arm_draft(*jl.truncate_layers(jcfg, jp, 1), k=4)
    teng.arm_draft(*tl.truncate_layers(tcfg, tp, 1), k=4)
    prompt = _prompt(72, 24)
    out = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        first = eng.drain([{"prompt": prompt, "max_new": 8,
                            "request_id": "a"}], decode_window=4)
        eng._evict(eng.ledger.pages)
        again = eng.drain([{"prompt": prompt, "max_new": 8,
                            "request_id": "b"}], decode_window=4)
        spec = eng.page_stats()["spec"]
        out[name] = (first, again, _counters(eng)[0],
                     spec["proposed"], spec["accepted"])
    assert out["port"] == out["jax"]
    assert out["port"][1]["b"] == out["port"][0]["a"]
    assert teng.tier_promoted_pages == 2
    _audit(teng)


def test_tiers_with_a_dropless_moe_match_jax(jax_cache):
    jcfg, tcfg, _, _ = _model("fp32")
    jp = jl.init_moe_params(jcfg, 4, jax.random.key(0))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    jeng = js.PagedServer(jcfg, jp, moe=jmoe.dropless(jmoe.MoEConfig(4)),
                          tiers=jpaging.PageTierStore(host_pages=8),
                          **ENGINE)
    teng = ts.PagedServer(tcfg, tp, moe=tmoe.dropless(tmoe.MoEConfig(4)),
                          tiers=tpaging.PageTierStore(host_pages=8),
                          device="cpu", **ENGINE)
    prompt = _prompt(73, 24)
    out = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        first = eng.drain([{"prompt": prompt, "max_new": 5,
                            "request_id": "a"}])
        eng._evict(eng.ledger.pages)
        again = eng.drain([{"prompt": prompt, "max_new": 5,
                            "request_id": "b"}])
        out[name] = (first, again, _counters(eng))
    assert out["port"] == out["jax"]
    assert teng.tier_promoted_pages == 2
    _audit(teng)


def test_promote_installs_in_place():
    """A promote writes into the pool tensors the engine was built with
    (captured windows bind them): same storage before and after."""
    _, tcfg, _, tp = _model("int8")
    eng = ts.PagedServer(tcfg, tp, device="cpu",
                         tiers=tpaging.PageTierStore(host_pages=8),
                         **ENGINE)
    ptrs = [(t.q.data_ptr(), t.s.data_ptr()) if isinstance(t, QTensor)
            else t.data_ptr() for t in eng.pool.values()]
    prompt = _prompt(74, 24)
    eng.drain([{"prompt": prompt, "max_new": 3, "request_id": "a"}])
    eng._evict(eng.ledger.pages)
    eng.drain([{"prompt": prompt, "max_new": 3, "request_id": "b"}])
    assert eng.tier_promoted_pages == 2
    assert ptrs == [(t.q.data_ptr(), t.s.data_ptr())
                    for t in eng.pool.values()]
