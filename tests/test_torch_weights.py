"""The port's peer weight plane (``dcos_commons_tpu_torch/models/weights.py``)
against ``dcos_commons_tpu/models/weights.py``: WTSHARD1 frames byte-equal
to the reference's and every corrupt frame refused by both with the same
message; restores crossing between the two implementations bitwise (the
port's ``WeightServer`` read by the reference's ``restore_from_peers``
into a JAX template, and the reverse into a torch template); the
rotation (a corrupt sibling skipped, down-marked, re-probed once healed);
``mirror_from_peers`` committing a step; the routes, counters and live
view. Then the worker: ``WEIGHT_SERVE_PORT`` seeds step 0 and serves it,
a ``llama --serve`` replica boots from a sibling's server (``source:
peer``, the sibling's replies) and falls back loudly from a dead peer."""

import json
import socket
import struct
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import weights as jw
from dcos_commons_tpu.parallel import checkpoint as jc
from dcos_commons_tpu_torch.frameworks import worker as tworker
from dcos_commons_tpu_torch.metrics import MetricsRegistry
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import weights as tw
from dcos_commons_tpu_torch.parallel import checkpoint as tc
from tests.test_torch_worker import _post, _Worker

LOCAL = "127.0.0.1"


def _tree(seed=0):
    """A small torch tree: fp32, bf16, int8 and a 0-d leaf."""
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 8), generator=g),
            "emb": torch.randn((16, 4), generator=g).to(torch.bfloat16),
            "q": torch.randint(-128, 127, (4, 4), generator=g,
                               dtype=torch.int8),
            "n": {"count": torch.tensor(7, dtype=torch.int32)}}


def _template(tree):
    return {k: (_template(v) if isinstance(v, dict) else torch.empty_like(v))
            for k, v in tree.items()}


def _assert_bitwise(got, want):
    a, b = tc._flatten(got), tc._flatten(want)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def _shard_files(step_dir):
    manifest = json.loads((step_dir / "manifest.json").read_text())
    return sorted(s["file"] for e in manifest["leaves"].values()
                  for s in e["shards"])


def _serve_dir(tmp_path, name, tree, corrupt_all=False):
    d = tmp_path / name
    tc.save_sharded(str(d), 1, tree)
    if corrupt_all:
        step = d / "step-00000001-p0"
        for fname in _shard_files(step):
            raw = bytearray((step / fname).read_bytes())
            raw[-1] ^= 0xFF
            (step / fname).write_bytes(bytes(raw))
    return d


class _Server:
    """A started ``WeightServer`` on 127.0.0.1, stopped on exit."""

    def __init__(self, module, ckpt_dir, **kw):
        self.srv = module.WeightServer(str(ckpt_dir), port=0, host=LOCAL,
                                       **kw)

    def __enter__(self):
        self.srv.start()
        return self.srv, f"http://{LOCAL}:{self.srv.port}"

    def __exit__(self, *exc):
        self.srv.stop()


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=10) as r:
        return r.status, r.read()


# ---------------------------------------------------------------------------
# the WTSHARD1 frame


@pytest.mark.parametrize("meta,body", [
    ({"step": 3, "file": "w.o0.bin"}, b"payload"),
    ({"step": 0, "file": "layers.wq.o0_0_0.bin"}, bytes(range(256)) * 9),
    ({"step": 12, "file": "x", "live": True}, b""),
])
def test_frames_are_byte_equal_to_the_reference_s(meta, body):
    frame = tw.pack_frame(meta, body)
    assert frame == jw.pack_frame(meta, body)
    got_meta, got_body = tw.unpack_frame(jw.pack_frame(meta, body))
    assert got_body == body and got_meta == jw.unpack_frame(frame)[0]


def _wrong_version():
    hdr = json.dumps({"version": 99, "body_digest": "",
                      "body_bytes": 0}).encode()
    return b"WTSHARD1" + struct.pack("<I", len(hdr)) + hdr


def _flipped():
    frame = bytearray(jw.pack_frame({"file": "x"}, b"0123456789"))
    frame[-1] ^= 0xFF
    return bytes(frame)


CORRUPT = [
    ("bad_magic", lambda: b"NOTAFRAME", "bad magic"),
    ("no_header_length", lambda: b"WTSHARD1\x01", "no header length"),
    ("bad_header", lambda: b"WTSHARD1" + struct.pack("<I", 5) + b"{nope",
     "bad header"),
    ("truncated_body",
     lambda: jw.pack_frame({"file": "x"}, b"0123456789")[:-3],
     "truncated body"),
    ("flipped_body_byte", _flipped, "digest mismatch"),
    ("wrong_version", _wrong_version, "version"),
]


@pytest.mark.parametrize("make,match", [c[1:] for c in CORRUPT],
                         ids=[c[0] for c in CORRUPT])
def test_corrupt_frames_are_refused_as_the_reference(make, match):
    data = make()
    with pytest.raises(jw.WeightFetchError, match=match) as want:
        jw.unpack_frame(data)
    with pytest.raises(tw.WeightFetchError, match=match) as got:
        tw.unpack_frame(data)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# restores crossing the two implementations


def test_the_reference_restores_from_the_port_s_server(tmp_path):
    tree = _tree()
    d = _serve_dir(tmp_path, "src", tree)
    template = jax.tree.map(
        lambda t: jnp.zeros(tuple(t.shape), {
            torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
            torch.int8: jnp.int8, torch.int32: jnp.int32}[t.dtype]), tree)
    with _Server(tw, d) as (srv, url):
        got = jw.restore_from_peers([url], template)
        assert srv.metrics.to_dict()["counters"][
            "weights.shards_served"] == 4
    got = {"emb": got["emb"], "n.count": got["n"]["count"], "q": got["q"],
           "w": got["w"]}
    for k, leaf in tc._flatten(tree):
        value = np.asarray(got[k])
        if leaf.dtype == torch.bfloat16:
            value, leaf = value.view(np.int16), leaf.view(torch.int16)
        np.testing.assert_array_equal(value, leaf.numpy())


def test_the_port_restores_from_the_reference_s_server(tmp_path):
    k1, k2 = jax.random.split(jax.random.key(0))
    jtree = {"w": jax.random.normal(k1, (8, 8), jnp.float32),
             "emb": jax.random.normal(k2, (16, 4)).astype(jnp.bfloat16),
             "n": {"count": jnp.int32(7)}}
    d = tmp_path / "jsrc"
    jc.save_sharded(str(d), 5, jtree)
    template = {"w": torch.empty((8, 8)),
                "emb": torch.empty((16, 4), dtype=torch.bfloat16),
                "n": {"count": torch.empty((), dtype=torch.int32)}}
    registry = MetricsRegistry()
    with _Server(jw, d) as (_, url):
        fetcher = tw.PeerFetcher([url], metrics=registry)
        got = tw.restore_from_peers([url], template, fetcher=fetcher)
    assert fetcher.stats()["step"] == 5
    assert fetcher.stats()["shards_fetched"] == 3
    assert registry.to_dict()["counters"]["weights.shards_fetched"] == 3
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(jtree["w"]))
    np.testing.assert_array_equal(
        got["emb"].view(torch.int16).numpy(),
        np.asarray(jtree["emb"]).view(np.int16))
    assert int(got["n"]["count"]) == 7


# ---------------------------------------------------------------------------
# the rotation and the mirror


def test_a_corrupt_peer_rotates_to_a_healthy_sibling(tmp_path):
    tree = _tree()
    bad = _serve_dir(tmp_path, "bad", tree, corrupt_all=True)
    good = _serve_dir(tmp_path, "good", tree)
    with _Server(tw, bad) as (_, bad_url), _Server(tw, good) as (_, url):
        fetcher = tw.PeerFetcher([bad_url, url], health_recheck_s=60.0)
        got = tw.restore_from_peers([bad_url, url], _template(tree),
                                    fetcher=fetcher)
    _assert_bitwise(got, tree)
    stats = fetcher.stats()
    assert stats["retries"] >= 1 and stats["peers_down"] == [bad_url]


def test_a_downed_peer_is_reprobed_and_serves_after_healing(tmp_path):
    tree = _tree()
    d = _serve_dir(tmp_path, "peer", tree, corrupt_all=True)
    with _Server(tw, d) as (_, url):
        fetcher = tw.PeerFetcher([url], health_recheck_s=60.0)
        with pytest.raises(tw.WeightFetchError, match="manifest digest"):
            tw.restore_from_peers([url], _template(tree), fetcher=fetcher)
        assert fetcher.stats()["peers_down"] == [url]
        assert fetcher._order() == []          # skipped inside the window
        tc.save_sharded(str(d), 1, tree)       # healed
        assert fetcher._order() == []
        fetcher.health_recheck_s = 0.0         # the window elapses
        assert fetcher._order() == [url]
        _assert_bitwise(tw.restore_from_peers([url], _template(tree),
                                              fetcher=fetcher), tree)
    assert fetcher.stats()["peers_down"] == []
    with pytest.raises(tw.WeightFetchError, match="no weight"):
        tw.restore_from_peers([], _template(tree))


def test_mirror_commits_a_step_the_reference_restores(tmp_path):
    tree = _tree()
    d = _serve_dir(tmp_path, "src", tree)
    dst = tmp_path / "mirror"
    dst.mkdir()
    (dst / ".step-00000001-p0.tmp").mkdir()          # a crashed mirror
    with _Server(tw, d) as (_, url):
        assert tw.mirror_from_peers([url], str(dst)) == 1
    assert sorted(p.name for p in dst.iterdir()) == ["step-00000001-p0"]
    for fname in _shard_files(d / "step-00000001-p0") + ["manifest.json"]:
        assert (dst / "step-00000001-p0" / fname).read_bytes() == (
            d / "step-00000001-p0" / fname).read_bytes(), fname
    _assert_bitwise(tc.restore_sharded(str(dst), _template(tree)), tree)
    assert jc.latest_step(str(dst)) == 1


# ---------------------------------------------------------------------------
# the routes and the live view


def test_routes_serve_only_the_manifest_s_files(tmp_path):
    tree = _tree()
    d = tmp_path / "src"
    tc.save_sharded(str(d), 1, tree)
    tc.save_sharded(str(d), 2, tree)
    (d / "step-00000002-p0" / "secret.bin").write_bytes(b"x")
    with _Server(tw, d) as (srv, url):
        status, body = _get(url, "/v1/healthz")
        assert json.loads(body) == {"ok": True, "role": "weights",
                                    "steps": [1, 2]}
        assert json.loads(_get(url, "/v1/weights/manifest")[1])["step"] == 2
        m1 = json.loads(_get(url, "/v1/weights/manifest?step=1")[1])
        assert m1["step"] == 1 and m1["steps"] == [1, 2]
        fname = _shard_files(d / "step-00000001-p0")[0]
        frame = _get(url, f"/v1/weights/shard?step=1&file={fname}")[1]
        meta, raw = tw.unpack_frame(frame)
        assert meta == {**meta, "step": 1, "file": fname}
        assert raw == (d / "step-00000001-p0" / fname).read_bytes()
        for path, code in (("/v1/weights/shard?step=2&file=secret.bin", 404),
                           ("/v1/weights/shard?step=2&file=../x", 404),
                           ("/v1/weights/shard?step=9&file=" + fname, 404),
                           ("/v1/weights/shard?file=" + fname, 400),
                           ("/v1/weights/manifest?step=7", 404),
                           ("/v1/weights/gangstate", 404),
                           ("/v1/nope", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(url, path)
            assert e.value.code == code, path
        counters = json.loads(_get(url, "/v1/metrics")[1])["counters"]
        assert counters["weights.shards_served"] == 1
        assert counters["weights.bytes_served"] == len(frame)
        prom = _get(url, "/v1/metrics/prometheus")[1].decode()
        assert "weights_shards_served" in prom


def test_a_live_snapshot_shadows_the_disk_steps(tmp_path):
    """``publish_live`` with an opaque GANGSTATE frame: the manifest,
    shards and ``/v1/weights/gangstate`` answer it (the fetcher restores
    it bitwise) until ``clear_live``."""
    tree = _tree(1)
    d = tmp_path / "src"
    tc.save_sharded(str(d), 1, _tree(0))
    leaves, blobs = tc.export_tree(tree)
    manifest = {"step": 9, "process": 0, "num_processes": 1,
                "leaves": leaves}
    with _Server(tw, d) as (srv, url):
        srv.publish_live(9, manifest, blobs, frame=b"GANGSTATE-opaque")
        assert srv.live_step() == 9
        m = json.loads(_get(url, "/v1/weights/manifest")[1])
        assert m["live"] is True and m["steps"] == [1, 9]
        fetcher = tw.PeerFetcher([url])
        assert fetcher.gangstate() == b"GANGSTATE-opaque"
        _assert_bitwise(tw.restore_from_peers([url], _template(tree),
                                              fetcher=fetcher), tree)
        srv.clear_live()
        assert json.loads(_get(url, "/v1/weights/manifest")[1])["step"] == 1
        with pytest.raises(tw.WeightFetchError, match="gangstate"):
            tw.PeerFetcher([url]).gangstate()
        counters = srv.metrics.to_dict()["counters"]
    assert counters["weights.live_published"] == 1
    assert counters["weights.gangstate_served"] == 1


def test_https_without_the_transport_module_is_refused():
    fetcher = tw.PeerFetcher(["https://peer:1"])
    with pytest.raises(tw.WeightFetchError, match="https"):
        fetcher._get("https://peer:1", "/v1/weights/manifest")


# ---------------------------------------------------------------------------
# the worker's hooks


def _closed_port() -> int:
    with socket.socket() as s:
        s.bind((LOCAL, 0))
        return s.getsockname()[1]


def _serving_args(*argv):
    return tworker.build_parser().parse_args(["llama", "--serve", *argv])


def _changed_params(seed=1):
    """Tiny serving weights other than the worker's init (seed 0)."""
    return tl.init_params(tl.LlamaConfig.tiny(),
                          torch.Generator().manual_seed(seed), device="cpu")


@pytest.mark.parametrize("with_out", [False, True])
def test_boot_from_a_peer_restores_bitwise(tmp_path, monkeypatch, with_out):
    """Without ``--out`` the shards stream into the template; with it the
    step is mirrored into ``--out`` first (``fetch_s``), then restored.
    The registry gets the phase seconds; ``source`` is ``peer``."""
    want = _changed_params()
    src = tmp_path / "src"
    tc.save_sharded(str(src), 3, want)
    registry = MetricsRegistry()
    out = tmp_path / "out"
    with _Server(tw, src) as (_, url):
        monkeypatch.setenv("WEIGHT_FETCH_PEERS", f" {url} ,")
        args = _serving_args(*(["--out", str(out)] if with_out else []))
        params, report = tworker._boot_serving_weights(
            args, lambda: tl.param_template(tl.LlamaConfig.tiny(), "cpu"),
            lambda: pytest.fail("booted from the peer, not the init"),
            registry)
    _assert_bitwise(params, want)
    assert report["source"] == "peer" and report["restore_s"] > 0
    timers = registry.to_dict()["timers"]
    assert "autoscale.cold_start.restore_seconds" in timers
    if with_out:
        assert report["fetch_s"] > 0 and tc.latest_step(str(out)) == 3
        assert "autoscale.cold_start.fetch_seconds" in timers
    else:
        assert report["fetch_s"] == 0.0 and not out.exists()


def test_a_dead_peer_falls_back_loudly_to_disk_then_init(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    url = f"http://{LOCAL}:{_closed_port()}"
    monkeypatch.setenv("WEIGHT_FETCH_PEERS", url)
    monkeypatch.setenv("WEIGHT_FETCH_TIMEOUT_S", "2")
    init = {"w": torch.zeros(1)}
    params, report = tworker._boot_serving_weights(
        _serving_args(), lambda: tl.param_template(tl.LlamaConfig.tiny(),
                                                   "cpu"), lambda: init)
    assert params is init and report["source"] == "init"
    want = _changed_params()
    tc.save_sharded(str(tmp_path / "vol"), 2, want)
    params, report = tworker._boot_serving_weights(
        _serving_args("--out", str(tmp_path / "vol")),
        lambda: tl.param_template(tl.LlamaConfig.tiny(), "cpu"),
        lambda: pytest.fail("the disk checkpoint comes before the init"))
    assert report["source"] == "disk" and report["step"] == 2
    _assert_bitwise(params, want)
    events = [json.loads(line) for line in
              capsys.readouterr().out.splitlines()]
    assert [e["event"] for e in events] == ["weight_fetch_fallback"] * 2
    assert events[0]["peers"] == [url] and events[0]["error"]


def test_the_weight_server_seeds_step_0_and_refuses_a_taken_port(tmp_path,
                                                                 monkeypatch,
                                                                 capsys):
    params = _changed_params()
    vol = tmp_path / "vol"
    monkeypatch.setenv("WEIGHT_SERVE_PORT", "0")
    srv = tworker._start_weight_server(_serving_args("--out", str(vol)),
                                       params)
    try:
        assert tc.latest_step(str(vol)) == 0
        event = json.loads(capsys.readouterr().out)
        assert event["event"] == "weight_server"
        assert event["port"] == srv.port and event["steps"] == [0]
        assert event["seed_save_s"] > 0
        got = tw.restore_from_peers([f"http://{LOCAL}:{srv.port}"],
                                    _template(params))
        _assert_bitwise(got, params)
        monkeypatch.setenv("WEIGHT_SERVE_PORT", str(srv.port))
        assert tworker._start_weight_server(
            _serving_args("--out", str(vol)), params) is None
        event = json.loads(capsys.readouterr().out)
        assert event["event"] == "weight_server_error"
        assert "in use" in event["error"]
    finally:
        srv.stop()
    monkeypatch.delenv("WEIGHT_SERVE_PORT")
    monkeypatch.setenv("PORT_WEIGHTS", "0")
    assert tworker._start_weight_server(_serving_args(), params) is None


def test_a_replica_boots_from_its_sibling_s_weight_server(tmp_path):
    """Replica A (``--out`` holding weights other than the init, and
    ``WEIGHT_SERVE_PORT``) serves them; replica B boots with
    ``WEIGHT_FETCH_PEERS`` pointing at A: ``source: peer``, A's committed
    step mirrored into B's ``--out`` byte for byte, and B's replies equal
    A's and differ from the init's."""
    tc.save_sharded(str(tmp_path / "a" / "vol"), 5, _changed_params())
    args = ["--serve", "--slots", "2", "--serve-port", "0", "--pages", "64",
            "--out", "vol"]
    prompts = [[5, 17, 99, 3, 250, 1, 42], [7] * 20]
    (tmp_path / "b").mkdir()
    a = _Worker(tmp_path / "a", *args, env={"WEIGHT_SERVE_PORT": "0"})
    b = None
    try:
        assert a.event("weights_loaded")["source"] == "disk"
        ws = a.event("weight_server")
        assert ws["steps"] == [5] and ws["seed_save_s"] == 0.0
        a_port = a.event("serving")["port"]
        b = _Worker(tmp_path / "b", *args, env={
            "WEIGHT_FETCH_PEERS": f"http://{LOCAL}:{ws['port']}"})
        loaded = b.event("weights_loaded")
        assert loaded["source"] == "peer" and loaded["fetch_s"] > 0
        serving = b.event("serving")
        assert serving["cold_start"]["source"] == "peer"
        got = [_post(serving["port"], {"prompt": p, "max_new": 6})["tokens"]
               for p in prompts]
        want = [_post(a_port, {"prompt": p, "max_new": 6})["tokens"]
                for p in prompts]
    finally:
        a.stop()
        if b is not None:
            b.stop()
    assert got == want
    step_a = tmp_path / "a" / "vol" / "step-00000005-p0"
    step_b = tmp_path / "b" / "vol" / "step-00000005-p0"
    for f in _shard_files(step_a):
        assert (step_b / f).read_bytes() == (step_a / f).read_bytes(), f
    assert _init_replies(prompts) != want


def _init_replies(prompts):
    """The replies of the worker's init (seed 0) on the same engine."""
    from dcos_commons_tpu_torch.models import serving as ts
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    srv = ts.PagedServer(cfg, params, slots=2, pages=64, device="cpu")
    return [srv.drain([{"prompt": p, "max_new": 6, "request_id": i}],
                      decode_window=8)[i] for i, p in enumerate(prompts)]


def test_a_replica_with_a_dead_peer_serves_the_init(tmp_path):
    w = _Worker(tmp_path, "--serve", "--slots", "2", "--serve-port", "0",
                env={"WEIGHT_FETCH_PEERS":
                     f"http://{LOCAL}:{_closed_port()}"})
    try:
        fallback = w.event("weight_fetch_fallback")
        assert fallback["peers"] and fallback["error"]
        assert w.event("weights_loaded")["source"] == "init"
        assert w.event("serving")["cold_start"]["source"] == "init"
    finally:
        w.stop()
