"""Live migration in the port (``dcos_commons_tpu_torch/models/migrate.py``:
``pack_decstate``/``unpack_decstate``, ``MigrationManager``,
``MigrateReceiver``, ``RemoteReplica``; ``PagedServer.export_stream`` /
``import_stream`` / ``release_stream``) against the JAX reference: the
tiny 2-layer model (``max_seq`` 64, page 8) in fp32, weights carried over
from the JAX init.

DECSTATE frames equal the reference's byte for byte for the same state,
and ``unpack_decstate`` refuses every corrupt frame the reference
refuses; a stream the JAX engine froze resumes on the port's engine
token-for-token (and the reverse); the cases of ``tests/test_migrate.py``
run on the port's engines against the JAX stream; an import is a
transaction that raises before any reservation and unwinds a failed
install; ``adopt_rng`` restores the generator state; and an import
rebinds none of the tensors a captured window reads. Every case ends with
clean page ledgers."""

import hashlib
import json
import struct
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import migrate as jmig
from dcos_commons_tpu.models import router as jrouter
from dcos_commons_tpu.models import serving as js
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import migrate as tmig
from dcos_commons_tpu_torch.models import router as trouter
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.ops.sampling import make_sampler

ENGINE = dict(slots=2, page_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, port cfg, JAX params, port params), fp32."""
    kw = dict(n_layers=2, max_seq=64)
    jcfg = jl.LlamaConfig.tiny(attn_impl="dense", dtype=jnp.float32, **kw)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, **kw)
    jp = jl.init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, jp, params_from_jax(jax.device_get(jp), device="cpu")


def _port(model, **kw):
    return ts.PagedServer(model[1], model[3], device="cpu",
                          **{**ENGINE, **kw})


def _jax(model, **kw):
    return js.PagedServer(model[0], model[2], **{**ENGINE, **kw})


def _prompt(seed, n, vocab=256):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, n)]


def _solo(model, prompt, steps):
    """The JAX package's uninterrupted greedy stream."""
    toks = jl.generate_stepwise(model[0], model[2],
                                jnp.asarray([prompt], jnp.int32), steps)
    return [int(t) for t in toks[0]]


def _drain(engine):
    for _ in range(200):
        if not engine.requests_active():
            break
        engine.step()
    return dict(engine.finished)


def _audit(*engines):
    for eng in engines:
        assert eng.ledger_violations() == []


def _frozen(engine, prompt, max_new, rid, steps=5):
    slot = engine.submit(prompt, max_new, request_id=rid)
    for _ in range(steps):
        engine.step()
    assert 0 < len(engine.requests[slot].tokens) < max_new
    return slot


# ---------------------------------------------------------- the frame bytes


def _bits(seed, shape, kind):
    """The same pool bytes for both packages: (reference array, port
    tensor)."""
    rng = np.random.default_rng(seed)
    if kind == "bf16":
        u = rng.integers(0, 1 << 16, shape, dtype=np.uint16)
        u[(u & 0x7F80) == 0x7F80] = 0          # no NaN/inf patterns
        return (u.view(ml_dtypes.bfloat16),
                torch.from_numpy(u.astype(np.int16)).view(torch.bfloat16))
    if kind == "int8":
        a = rng.integers(-128, 128, shape, dtype=np.int8)
        return a, torch.from_numpy(a.copy())
    a = rng.standard_normal(shape).astype(np.float32)
    return a, torch.from_numpy(a.copy())


def _states(kind, n_prompt, n_tokens, rng_kind):
    """A reference state dict and the port's for the same stream: L=2,
    page 8, KV 4, D 8, the last page partial."""
    ps = 8
    kv_len = n_prompt + n_tokens - 1
    shape = (2, -(-kv_len // ps), ps, 4, 8)
    jpay, tpay = {}, {}
    for i, side in enumerate(("k", "v")):
        if kind == "int8":
            q, tq = _bits(10 + i, shape, "int8")
            s, t_s = _bits(20 + i, shape[:4] + (1,), "bf16")
            jpay[side], tpay[side] = {"q": q, "s": s}, {"q": tq, "s": t_s}
        else:
            jpay[side], tpay[side] = _bits(10 + i, shape, kind)
    rng = {"none": None,
           "jax": np.asarray(jax.random.key_data(jax.random.key(7))),
           "torch": torch.Generator().manual_seed(3).get_state()}[rng_kind]
    base = {"version": 1, "prompt": _prompt(30, n_prompt),
            "tokens": _prompt(31, n_tokens), "max_new": 20,
            "page_size": ps, "kv_quant": kind == "int8"}
    j_rng = None if rng is None else (rng.numpy()
                                      if isinstance(rng, torch.Tensor)
                                      else rng)
    return ({**base, "rng_key": j_rng, "payload": jpay},
            {**base, "rng_key": rng, "payload": tpay})


IDENTITY = {"unset": {},
            "set": dict(tenant="gold", qos="premium",
                        trace="0123456789abcdef-fedcba9876543210",
                        request_id="req-7")}


@pytest.mark.parametrize("identity", sorted(IDENTITY))
@pytest.mark.parametrize("kind,rng_kind", [("bf16", "jax"),
                                           ("bf16", "torch"),
                                           ("int8", "none"),
                                           ("fp32", "torch")])
def test_decstate_bytes_equal_the_reference(kind, rng_kind, identity):
    """The same state through both ``pack_decstate``: the same frame,
    byte for byte (bf16 and int8 pools, a partial last page, the RNG
    field in every form, the identity fields set and unset); each
    package's unpack reads the other's frame back to the same fields."""
    jstate, tstate = _states(kind, 13, 5, rng_kind)
    kw = IDENTITY[identity]
    want = jmig.pack_decstate(jstate, **kw)
    got = tmig.pack_decstate(tstate, **kw)
    assert got == want
    back = tmig.unpack_decstate(want)
    ref = jmig.unpack_decstate(got)
    for key in ("version", "prompt", "tokens", "max_new", "page_size",
                "kv_quant", "tenant", "qos", "trace", "request_id"):
        assert back[key] == ref[key], key
    if ref["rng_key"] is None:
        assert back["rng_key"] is None
    else:
        np.testing.assert_array_equal(back["rng_key"], ref["rng_key"])
    assert tmig.pack_decstate({**back, "payload": back["payload"]},
                              **kw) == want


def _resign(frame, mutate):
    """``frame`` with its header JSON changed by ``mutate`` and the header
    digest recomputed (a well-formed lie)."""
    off = len(b"DECSTAT1")
    (hlen,) = struct.unpack_from("<I", frame, off)
    header = json.loads(frame[off + 12:off + 12 + hlen])
    body = frame[off + 12 + hlen:]
    mutate(header)
    h = json.dumps(header).encode()
    return (b"DECSTAT1" + struct.pack("<I", len(h))
            + hashlib.blake2s(h, digest_size=8).digest() + h + body)


def _flip(frame, at):
    b = bytearray(frame)
    b[at] ^= 0x01
    return bytes(b)


CORRUPT = {
    "magic": lambda f: b"NOTADECS" + f[8:],
    "no_header_length": lambda f: f[:10],
    "short_header": lambda f: f[:40],
    "header_digest": lambda f: _flip(f, 30),
    "version": lambda f: _resign(f, lambda h: h.update(version=2)),
    "body_digest": lambda f: _flip(f, len(f) - 3),
    "truncated_body": lambda f: f[:-5],
    "prefix_hashes": lambda f: _resign(
        f, lambda h: h.update(prompt=[t + 1 for t in h["prompt"]])),
    "no_tokens": lambda f: _resign(f, lambda h: h.update(tokens=[])),
    "mangled_rng": lambda f: _resign(
        f, lambda h: h["rng_key"].update(hex="zz")),
    "rng_shape": lambda f: _resign(
        f, lambda h: h["rng_key"].update(shape=[3])),
    "not_json": lambda f: b"DECSTAT1" + struct.pack("<I", 3)
    + hashlib.blake2s(b"{{{", digest_size=8).digest() + b"{{{",
}


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_unpack_refuses_what_the_reference_refuses(case):
    """Each corrupt frame is a ``DecStateError`` in both packages."""
    jstate, _ = _states("bf16", 13, 5, "jax")
    frame = CORRUPT[case](jmig.pack_decstate(jstate))
    with pytest.raises(jmig.DecStateError):
        jmig.unpack_decstate(frame)
    with pytest.raises(tmig.DecStateError):
        tmig.unpack_decstate(frame)


# -------------------------------------------------- across implementations


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_stream_crosses_implementations_token_exact(model, direction):
    """A stream frozen by one package's ``export_stream``, framed by the
    same package and adopted by the other's ``import_stream``, finishes
    equal to the JAX engine's unmigrated stream."""
    prompt, max_new = _prompt(300, 13), 12
    src, dst = ((_jax(model), _port(model)) if direction == "jax_to_port"
                else (_port(model), _jax(model)))
    src_mig, dst_mig = ((jmig, tmig) if direction == "jax_to_port"
                        else (tmig, jmig))
    slot = _frozen(src, prompt, max_new, "x-1")
    state = src.export_stream(slot)
    frame = src_mig.pack_decstate(state, request_id="x-1")
    assert dst.import_stream(dst_mig.unpack_decstate(frame),
                             request_id="x-1") is not None
    assert src.release_stream(slot)
    assert _drain(dst)["x-1"] == _solo(model, prompt, max_new)
    assert dst.page_stats()["migrated_in"] == 1
    assert src.page_stats()["migrated_out"] == 1
    _audit(src, dst)


@pytest.mark.parametrize("steps", [5, 6, 7, 8])
def test_export_stream_equals_the_reference(model, steps):
    """The same stream frozen at the same step by both engines: the same
    prompt, tokens, budget and flags, and pages within fp32 rounding
    (the freezes cover a last written position that starts a page)."""
    prompt = _prompt(305, 21)
    je, te = _jax(model), _port(model)
    states = []
    for eng in (je, te):
        slot = _frozen(eng, prompt, 12, "e", steps=steps)
        states.append(eng.export_stream(slot))
    want, got = states
    for key in ("version", "prompt", "tokens", "max_new", "page_size",
                "kv_quant"):
        assert got[key] == want[key], key
    assert got["rng_key"] is None           # a greedy port engine
    kv_len = len(prompt) + len(got["tokens"]) - 1
    assert got["payload"]["k"].shape[1] == -(-kv_len // 8)
    for side in ("k", "v"):
        np.testing.assert_allclose(got["payload"][side].numpy(),
                                   np.asarray(want["payload"][side]),
                                   rtol=0, atol=1e-5)
    for eng in (je, te):
        assert eng.export_stream(5) is None
        fresh = eng.submit(_prompt(306, 9), 4, request_id="p")
        assert eng.export_stream(fresh) is None     # still prefilling
    _audit(je, te)


# -------------------------------------- the reference's cases on the port


def test_drain_resumes_token_exact(model):
    src, dst = _port(model), _port(model)
    prompt = _prompt(300, 13)
    slot = _frozen(src, prompt, 12, "mig-1")
    mgr = tmig.MigrationManager(ring=trouter.HashRing(["dst"], vnodes=8),
                                page_size=8)
    receipt = mgr.drain(src, "src", [("dst", dst)])
    assert receipt == {"victim": "src", "live": 1, "migrated": 1,
                       "resubmitted": 0, "failed": 0}
    assert src.requests[slot] is None
    assert "mig-1" not in src.finished
    assert src.page_stats()["migrated_out"] == 1
    assert _drain(dst)["mig-1"] == _solo(model, prompt, 12)
    assert dst.page_stats()["migrated_in"] == 1
    st = mgr.stats()
    assert st["migrated"] == 1 and st["failed"] == 0
    assert st["pause_ms"]["p95"] >= 0.0
    assert st["moves"][-1][:2] == ("src", "dst")
    _audit(src, dst)


def test_prefilling_stream_resubmits(model):
    src, dst = _port(model), _port(model)
    prompt = _prompt(301, 13)
    src.submit(prompt, 10, request_id="pre-1")     # never stepped
    receipt = tmig.MigrationManager(page_size=8).drain(src, "src",
                                                       [("dst", dst)])
    assert receipt["resubmitted"] == 1 and receipt["failed"] == 0
    assert not src.requests_active() and not src._prefill_q
    assert _drain(dst)["pre-1"] == _solo(model, prompt, 10)
    _audit(src, dst)


def test_refused_drain_leaves_victim_untouched(model):
    src, dst = _port(model), _port(model)
    for i in range(2):                       # dst: both slots busy
        dst.submit(_prompt(310 + i, 9), 16, request_id=f"busy-{i}")
        dst.step()
    free = dst.pages_free()
    prompt = _prompt(302, 13)
    slot = _frozen(src, prompt, 12, "stay-1")
    receipt = tmig.MigrationManager(page_size=8).drain(src, "src",
                                                       [("dst", dst)])
    assert receipt["failed"] == 1 and receipt["migrated"] == 0
    assert src.requests[slot] is not None
    assert src.page_stats()["migrated_out"] == 0
    assert dst.page_stats()["migrated_in"] == 0
    assert dst.pages_free() == free
    assert _drain(src)["stay-1"] == _solo(model, prompt, 12)
    _audit(src, dst)


def test_disabled_manager_is_a_noop(model):
    src, dst = _port(model), _port(model)
    slot = src.submit(_prompt(303, 9), 8, request_id="off-1")
    src.step()
    receipt = tmig.MigrationManager(enable=False, page_size=8).drain(
        src, "src", [("dst", dst)])
    assert receipt["live"] == 0 and receipt["migrated"] == 0
    assert src.requests[slot] is not None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_destination_order_equals_the_reference(seed):
    names = ["c", "b", "a", "x"]
    prompt = _prompt(400 + seed, 16 + 8 * seed)
    orders = []
    for mig, rt in ((jmig, jrouter), (tmig, trouter)):
        mgr = mig.MigrationManager(ring=rt.HashRing(["a", "b", "c"],
                                                    vnodes=8), page_size=8)
        orders.append(mgr.destination_order(prompt, names))
    assert orders[0] == orders[1]
    assert sorted(orders[1]) == sorted(names) and orders[1][-1] == "x"
    assert tmig.MigrationManager().destination_order(prompt, names) == names


def test_receiver_http_e2e(model):
    src, dst = _port(model), _port(model)
    recv = tmig.MigrateReceiver(dst, port=0, host="127.0.0.1").start()
    try:
        peer = f"http://127.0.0.1:{recv.port}"
        prompt = _prompt(320, 13)
        slot = _frozen(src, prompt, 12, "wire-1")
        state = src.export_stream(slot)
        body = tmig.ship_stream(peer, tmig.pack_decstate(
            state, tenant="gold", request_id="wire-1"))
        assert body["ok"] and body["generated"] == len(state["tokens"])
        src.release_stream(slot)
        assert _drain(dst)["wire-1"] == _solo(model, prompt, 12)
        with urllib.request.urlopen(peer + "/v1/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["migrated_in"] == 1 and health["role"] == "migrate"
        with pytest.raises(tmig.DecStateError, match="400"):
            tmig.ship_stream(peer, b"NOTADECS" + b"\0" * 32)
        # a frame the engine refuses (another page size) is a 400 too
        bad = tmig.pack_decstate({**state, "page_size": 16})
        with pytest.raises(tmig.DecStateError, match="400"):
            tmig.ship_stream(peer, bad)
    finally:
        recv.stop()
    _audit(src, dst)


def test_remote_replica_maps_capacity_503_to_none(model):
    src, dst = _port(model), _port(model)
    for i in range(2):
        dst.submit(_prompt(330 + i, 9), 16, request_id=f"full-{i}")
        dst.step()
    recv = tmig.MigrateReceiver(dst, port=0, host="127.0.0.1").start()
    try:
        slot = _frozen(src, _prompt(331, 13), 12, "spill-1")
        remote = tmig.RemoteReplica(f"http://127.0.0.1:{recv.port}")
        assert remote.import_stream(src.export_stream(slot),
                                    request_id="spill-1") is None
        assert remote.submit([1, 2], 3) is None
        assert src.requests[slot] is not None
        # the manager drains over HTTP the path it drains in process
        mgr = tmig.MigrationManager(page_size=8)
        assert mgr.drain(src, "src", [("remote", remote)])["failed"] == 1
    finally:
        recv.stop()
    _audit(src, dst)


def test_manager_from_env_contract():
    for mig in (jmig, tmig):
        mgr = mig.manager_from_env({})
        assert (mgr.enable, mgr.timeout_s, mgr.max_inflight) == (True, 30.0,
                                                                 2)
        mgr = mig.manager_from_env({"MIGRATE_ENABLE": "off",
                                    "MIGRATE_TIMEOUT_S": "7.5",
                                    "MIGRATE_MAX_INFLIGHT": "4"})
        assert (mgr.enable, mgr.timeout_s, mgr.max_inflight) == (False,
                                                                 7.5, 4)
        with pytest.raises(ValueError):
            mig.MigrationManager(timeout_s=0.0)
        with pytest.raises(ValueError):
            mig.MigrationManager(max_inflight=0)


# ------------------------------------------------------------ transaction


def _refusals(state):
    """(name, state) an engine must refuse with ValueError."""
    pay = state["payload"]
    return [
        ("page_size", {**state, "page_size": 16}),
        ("kv_quant", {**state, "kv_quant": True}),
        ("shape", {**state, "payload": {s: pay[s][:, :1] for s in pay}}),
        ("complete", {**state, "max_new": len(state["tokens"])}),
        ("no_tokens", {**state, "tokens": []}),
        ("too_long", {**state, "max_new": 200}),
    ]


def test_import_refusals_raise_before_any_reservation(model):
    src, dst = _port(model), _port(model)
    state = src.export_stream(_frozen(src, _prompt(340, 13), 12, "r"))
    free, refs = dst.pages_free(), dst.expected_refs()
    for name, bad in _refusals(state):
        with pytest.raises(ValueError):
            dst.import_stream(bad)
        assert dst.pages_free() == free, name
        assert dst.expected_refs() == refs, name
        assert not dst.requests_active(), name
    _audit(src, dst)


def test_failed_install_unwinds_every_reference(model, monkeypatch):
    src, dst = _port(model), _port(model)
    prompt = _prompt(341, 21)
    # dst holds the prompt's first pages in its radix: the import shares
    # them, and the unwind must give those references back too
    dst.drain([{"prompt": prompt, "max_new": 2, "request_id": "warm"}])
    free, refs = dst.pages_free(), dst.expected_refs()
    state = src.export_stream(_frozen(src, prompt, 12, "u"))

    def boom(*a, **kw):
        raise RuntimeError("install aborted")

    monkeypatch.setattr(dst, "_install", boom)
    with pytest.raises(RuntimeError, match="install aborted"):
        dst.import_stream(state)
    assert dst.pages_free() == free and dst.expected_refs() == refs
    assert not dst.requests_active()
    monkeypatch.undo()
    assert dst.import_stream(state, request_id="u") is not None
    assert dst.page_stats()["prefix_hits"] >= 1
    src.release_stream(0)
    assert _drain(dst)["u"] == _solo(model, prompt, 12)
    _audit(src, dst)


def test_release_stream_adopts_the_prompt_pages(model):
    src = _port(model)
    prompt = _prompt(342, 21)                # two full prompt pages
    slot = _frozen(src, prompt, 12, "rel")
    assert src.radix.size() == 0
    assert src.release_stream(slot) and not src.release_stream(slot)
    assert "rel" not in src.finished
    assert src.radix.size() == 2
    shared, _ = src.radix.lookup(prompt)
    assert len(shared) == 2
    for p in shared:
        src.ledger.unref(p)
    _audit(src)


def test_full_destination_returns_none(model):
    src = _port(model)
    dst = _port(model, pages=3)              # 13 + 12 needs 4 pages
    state = src.export_stream(_frozen(src, _prompt(343, 13), 12, "n"))
    with pytest.raises(ValueError):          # never admissible: loud
        dst.import_stream(state)
    dst2 = _port(model, pages=5)
    dst2.submit(_prompt(344, 9), 8, request_id="hog")
    assert dst2.import_stream(state) is None  # transient: None
    _audit(src, dst, dst2)


# --------------------------------------------------------------- adopt_rng


def _sampled(model, **kw):
    return _port(model, sampler=make_sampler(temperature=0.9), **kw)


def test_adopt_rng_continues_the_victims_sampled_stream(model):
    """A sampled stream migrated with ``adopt_rng=True`` into an empty
    engine continues exactly as the victim's own unmigrated stream from
    the same generator state: the state round-trips through the frame
    into the destination's own generator object."""
    prompt = _prompt(350, 13)
    src, dst = _sampled(model), _sampled(model)
    gen = dst.generator
    slot = _frozen(src, prompt, 16, "s")
    state = tmig.unpack_decstate(tmig.pack_decstate(src.export_stream(slot)))
    assert torch.equal(torch.from_numpy(state["rng_key"]),
                       src.generator.get_state())
    assert dst.import_stream(state, request_id="s", adopt_rng=True) == slot
    assert dst.generator is gen
    assert torch.equal(dst.generator.get_state(), src.generator.get_state())
    assert _drain(dst)["s"] == _drain(src)["s"]
    # without adopt_rng the destination keeps its own state
    other = _sampled(model)
    before = other.generator.get_state()
    other.import_stream(state, adopt_rng=False)
    assert torch.equal(other.generator.get_state(), before)
    _audit(src, dst, other)


@pytest.mark.parametrize("rng", ["jax_key", "short", "float"])
def test_adopt_rng_refuses_a_foreign_key_before_any_reservation(model, rng):
    src, dst = _sampled(model), _sampled(model)
    state = src.export_stream(_frozen(src, _prompt(351, 13), 12, "k"))
    state["rng_key"] = {
        "jax_key": np.asarray(jax.random.key_data(jax.random.key(1))),
        "short": state["rng_key"][:16],
        "float": state["rng_key"].astype(np.float32)}[rng]
    free, before = dst.pages_free(), dst.generator.get_state()
    with pytest.raises(ValueError, match="adopt_rng"):
        dst.import_stream(state, adopt_rng=True)
    assert dst.pages_free() == free and not dst.requests_active()
    assert torch.equal(dst.generator.get_state(), before)
    greedy = _port(model)
    with pytest.raises(ValueError, match="adopt_rng"):
        greedy.import_stream(src.export_stream(0), adopt_rng=True)
    _audit(src, dst, greedy)


# ---------------------------------------------------------------- in place


def test_import_rebinds_no_bound_tensor(model):
    """The tensors a captured window reads are the same objects after an
    import, which writes the stream's length and last token into them."""
    src, dst = _port(model), _port(model)
    dst.submit(_prompt(360, 9), 20, request_id="other")
    dst.step()
    bound = {"pool": dict(dst.pool), "lengths": dst.lengths,
             "cur_tok": dst.cur_tok, "table": dst._table_buf}
    prompt = _prompt(361, 13)
    state = src.export_stream(_frozen(src, prompt, 12, "ip"))
    slot = dst.import_stream(state, request_id="ip")
    assert all(dst.pool[s] is bound["pool"][s] for s in ("k", "v"))
    assert dst.lengths is bound["lengths"]
    assert dst.cur_tok is bound["cur_tok"]
    assert dst._table_buf is bound["table"]
    assert int(dst.lengths[slot]) == len(prompt) + len(state["tokens"]) - 1
    assert int(dst.cur_tok[slot]) == state["tokens"][-1]
    src.release_stream(0)
    assert _drain(dst)["ip"] == _solo(model, prompt, 12)
    _audit(src, dst)
