"""Peer-to-peer weight transfer (port of
``dcos_commons_tpu/models/weights.py``): a serving replica is a
checkpoint CDN.

Every already-hot replica of a homogeneous decode tier holds the exact
bytes a booting sibling needs: committed ``parallel/checkpoint.py`` step
directories on its volume. This module moves them replica to replica
over plain HTTP, as ``models/disagg.py`` moves KV spans:

* :class:`WeightServer`: an HTTP front door over one checkpoint
  directory. ``GET /v1/weights/manifest`` answers the newest committed
  step's manifest (per-shard blake2s digests included);
  ``GET /v1/weights/shard?step=N&file=F`` answers one shard as a
  digest-checked WTSHARD1 frame (:func:`pack_frame`: magic | header
  length | header JSON | body), bytes equal to the reference's for the
  same shard. A live (in-memory) snapshot can shadow the disk steps
  (``publish_live``; ``/v1/weights/gangstate`` answers its opaque
  frame).
* :class:`PeerFetcher`: the booting replica's side. Round-robin over
  the healthy peers (``DisaggCoordinator``'s down-mark and re-probe),
  per-shard retry on the next peer, every frame checked twice: against
  its own body digest (transport) and against the digest the saving
  process wrote into the manifest (end to end). Its ``reader`` plugs
  into ``restore_sharded(reader=..., manifest=...)``.
* :func:`restore_from_peers`: fetch and restore in one call; raises
  :class:`WeightFetchError` when no peer can serve (callers fall back to
  the disk path, loudly).
* :func:`mirror_from_peers`: lands the fetched step as a committed local
  step directory (dot-tmp + rename) so the new replica serves its own
  siblings; unlike the reference's one-by-one loop it fetches a few
  shards at once.

Transport: the reference goes through ``security/transport.py`` when it
is importable (TLS for ``https://``); that module is not ported, so this
is the reference's own fallback: plain ``urllib`` for ``http://``,
:class:`WeightFetchError` for ``https://``, and the server speaks plain
HTTP.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import threading
import time
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from ..metrics import MetricsRegistry
from ..parallel import checkpoint as ckpt

_MAGIC = b"WTSHARD1"
_WIRE_VERSION = 1


class WeightFetchError(RuntimeError):
    """A peer weight fetch that must not be trusted or retried in place:
    transport failure, framing, or digest verification failed."""


def pack_frame(meta: Dict[str, Any], body: bytes) -> bytes:
    """Frame one shard for the wire, ``pack_span``-style:
    ``MAGIC | header_len | header JSON | raw shard bytes``. The header
    carries the shard metadata plus a digest of the body."""
    header = dict(meta)
    header["version"] = _WIRE_VERSION
    header["body_digest"] = hashlib.blake2s(body).hexdigest()
    header["body_bytes"] = len(body)
    hdr = json.dumps(header).encode()
    return _MAGIC + struct.pack("<I", len(hdr)) + hdr + body


def unpack_frame(data: bytes) -> (dict, bytes):
    """Parse + VERIFY one shard frame; raises :class:`WeightFetchError`
    on bad magic, version, truncation, or body-digest mismatch — a
    mangled transfer dies here, before the restore path sees it."""
    if not data.startswith(_MAGIC):
        raise WeightFetchError("bad magic: not a weight shard frame")
    off = len(_MAGIC)
    if len(data) < off + 4:
        raise WeightFetchError("truncated frame: no header length")
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    try:
        meta = json.loads(data[off:off + hlen])
    except ValueError as e:
        raise WeightFetchError(f"bad header: {e}") from None
    off += hlen
    if meta.get("version") != _WIRE_VERSION:
        raise WeightFetchError(f"wire version {meta.get('version')} != "
                               f"{_WIRE_VERSION}")
    body = data[off:]
    if len(body) != meta.get("body_bytes"):
        raise WeightFetchError(
            f"truncated body: {len(body)} bytes, frame header says "
            f"{meta.get('body_bytes')}")
    if hashlib.blake2s(body).hexdigest() != meta.get("body_digest"):
        raise WeightFetchError("body digest mismatch: corrupt transfer")
    return meta, body


def _urlopen(req, timeout: float):
    """The reference's fallback transport: cleartext ``http://`` through
    plain urllib; ``https://`` is a hard error, since silently
    unverified TLS would defeat the point."""
    url = req.full_url if hasattr(req, "full_url") else str(req)
    if str(url).startswith("https://"):
        raise WeightFetchError(
            "https:// weight fetch needs security/transport.py, which is "
            "not ported")
    return urllib.request.urlopen(req, timeout=timeout)


class WeightServer:
    """One checkpoint directory behind HTTP — attach to any serving
    replica so its committed steps double as the fleet's weight source.

    Routes (GET): ``/v1/weights/manifest[?step=N]``,
    ``/v1/weights/shard?step=N&file=F``, plus the standard
    ``/v1/healthz`` / ``/v1/metrics`` / ``/v1/metrics/prometheus``
    trio every replica shape exposes. Only files named by the step's
    own manifest are served (no path traversal by construction).

    The same routes can serve LIVE state: a training gang frozen at a
    step boundary publishes its in-memory export (``publish_live``:
    manifest, shard blobs and an opaque GANGSTATE frame, whose producer
    is restart-free resharding, not ported yet) and peers pull it with
    no checkpoint I/O; ``/v1/weights/gangstate`` answers the raw frame.
    The live snapshot shadows committed disk steps while published and
    vanishes on ``clear_live``. ``_live_lock`` guards only the snapshot
    reference; response bodies are written after it is released."""

    def __init__(self, ckpt_dir: str, port: int = 0,
                 host: str = "0.0.0.0", pid: int = 0,
                 metrics: Optional[MetricsRegistry] = None):
        self.ckpt_dir = ckpt_dir
        self.pid = pid
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._own_metrics = metrics is None
        self._live_lock = threading.Lock()
        self._live: Optional[dict] = None
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _json(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                qs = urllib.parse.parse_qs(parsed.query)
                if parsed.path == "/v1/healthz":
                    self._json(200, {"ok": True, "role": "weights",
                                     "steps": server.steps()})
                elif parsed.path == "/v1/metrics":
                    self._json(200, server.metrics.to_dict())
                elif parsed.path == "/v1/metrics/prometheus":
                    body = server.metrics.to_prometheus().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif parsed.path == "/v1/weights/manifest":
                    step = qs.get("step", [None])[0]
                    try:
                        payload = server.manifest(
                            None if step is None else int(step))
                    except FileNotFoundError as e:
                        self._json(404, {"error": str(e)})
                        return
                    self._json(200, payload)
                elif parsed.path == "/v1/weights/shard":
                    try:
                        step = int(qs["step"][0])
                        fname = qs["file"][0]
                    except (KeyError, ValueError, IndexError):
                        self._json(400, {"error": "need step= and file="})
                        return
                    try:
                        frame = server.shard_frame(step, fname)
                    except FileNotFoundError as e:
                        self._json(404, {"error": str(e)})
                        return
                    server.metrics.counter("weights.shards_served")
                    server.metrics.counter("weights.bytes_served",
                                           len(frame))
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("Content-Length", str(len(frame)))
                    self.end_headers()
                    self.wfile.write(frame)
                elif parsed.path == "/v1/weights/gangstate":
                    frame = server.gangstate_frame()
                    if frame is None:
                        self._json(404,
                                   {"error": "no live gang state published"})
                        return
                    server.metrics.counter("weights.gangstate_served")
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("Content-Length", str(len(frame)))
                    self.end_headers()
                    self.wfile.write(frame)
                else:
                    self._json(404, {"error": f"no route {parsed.path}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- live state (restart-free resharding) --------------------------------

    def publish_live(self, step: int, manifest: dict,
                     blobs: Dict[str, bytes],
                     frame: Optional[bytes] = None) -> None:
        """Expose a frozen live training state on the weight routes.
        ``blobs`` maps shard file names to raw bytes (the manifest's
        digests still verify end-to-end); ``frame`` is the opaque
        GANGSTATE frame served at ``/v1/weights/gangstate``. The
        snapshot is replaced wholesale — never mutated in place — so
        readers that copied the reference out of the lock stay
        coherent."""
        snap = {"step": int(step), "manifest": manifest,
                "blobs": dict(blobs), "frame": frame}
        with self._live_lock:
            self._live = snap
        self.metrics.counter("weights.live_published")

    def clear_live(self) -> None:
        with self._live_lock:
            self._live = None

    def _live_view(self, step: Optional[int] = None) -> Optional[dict]:
        with self._live_lock:
            live = self._live
        if live is None or (step is not None and live["step"] != step):
            return None
        return live

    def live_step(self) -> Optional[int]:
        live = self._live_view()
        return None if live is None else live["step"]

    def gangstate_frame(self) -> Optional[bytes]:
        live = self._live_view()
        return None if live is None else live.get("frame")

    # -- checkpoint surface --------------------------------------------------

    def steps(self) -> List[int]:
        return ckpt._local_steps(self.ckpt_dir, self.pid)

    def _step_dir(self, step: int) -> str:
        d = os.path.join(self.ckpt_dir, f"step-{step:08d}-p{self.pid}")
        if not os.path.isfile(os.path.join(d, "manifest.json")):
            raise FileNotFoundError(f"no committed step {step}")
        return d

    def manifest(self, step: Optional[int] = None) -> dict:
        live = self._live_view(step)
        if live is not None:
            steps = sorted(set(self.steps()) | {live["step"]})
            return {"step": live["step"], "steps": steps,
                    "manifest": live["manifest"], "live": True}
        steps = self.steps()
        if step is None:
            if not steps:
                raise FileNotFoundError(
                    f"no committed checkpoint under {self.ckpt_dir!r}")
            step = steps[-1]
        with open(os.path.join(self._step_dir(step), "manifest.json"),
                  encoding="utf-8") as f:
            manifest = json.load(f)
        return {"step": step, "steps": steps, "manifest": manifest}

    def shard_frame(self, step: int, fname: str) -> bytes:
        live = self._live_view(step)
        if live is not None:
            body = live["blobs"].get(fname)
            if body is None:
                raise FileNotFoundError(
                    f"live step {step} has no shard {fname!r}")
            return pack_frame({"step": step, "file": fname, "live": True},
                              body)
        step_d = self._step_dir(step)
        with open(os.path.join(step_d, "manifest.json"),
                  encoding="utf-8") as f:
            manifest = json.load(f)
        known = {s["file"] for e in manifest["leaves"].values()
                 for s in e["shards"]}
        if fname not in known:   # also forecloses path traversal
            raise FileNotFoundError(
                f"step {step} manifest names no shard {fname!r}")
        with open(os.path.join(step_d, fname), "rb") as f:
            body = f.read()
        return pack_frame({"step": step, "file": fname}, body)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "WeightServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="weights-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=10)
        if self._own_metrics:
            self.metrics.close()


class PeerFetcher:
    """Round-robin digest-checked shard fetch from already-hot peers.

    The rotation is ``disagg.DisaggCoordinator``'s:
    a failing peer is marked down and skipped until ``health_recheck_s``
    elapses and its ``/v1/healthz`` answers again; a shard fetch that
    fails on one peer retries on the NEXT healthy peer before the whole
    fetch gives up. ``reader`` satisfies ``restore_sharded``'s byte
    source contract, so fetched shards stream straight to device."""

    def __init__(self, peers, timeout_s: float = 120.0,
                 health_recheck_s: float = 5.0,
                 metrics: Optional[MetricsRegistry] = None):
        if isinstance(peers, str):
            self.peers = [p.strip() for p in peers.split(",") if p.strip()]
        else:
            self.peers = [str(p).strip() for p in (peers or ())
                          if str(p).strip()]
        self.timeout_s = timeout_s
        self.health_recheck_s = health_recheck_s
        self.metrics = metrics
        self._lock = threading.Lock()
        self._rr = 0
        self._down: Dict[str, float] = {}
        self.step: Optional[int] = None
        self._manifest: Optional[dict] = None
        self._by_file: Dict[str, dict] = {}
        self.shards_fetched = 0
        self.bytes_fetched = 0
        self.retries = 0

    # -- rotation ------------------------------------------------------------

    def _probe(self, peer: str) -> bool:
        try:
            req = urllib.request.Request(
                peer.rstrip("/") + "/v1/healthz")
            with _urlopen(req, timeout=5.0) as r:
                return bool(json.loads(r.read()).get("ok"))
        except Exception:
            return False

    def _mark_down(self, peer: str) -> None:
        with self._lock:
            self._down[peer] = time.monotonic()

    def _peer_ok(self, peer: str) -> bool:
        with self._lock:
            marked = self._down.get(peer)
            if marked is None:
                return True
            if time.monotonic() - marked < self.health_recheck_s:
                return False
        if self._probe(peer):
            with self._lock:
                self._down.pop(peer, None)
            return True
        self._mark_down(peer)
        return False

    def _order(self) -> List[str]:
        with self._lock:
            n = len(self.peers)
            if n == 0:
                return []
            start = self._rr % n
            self._rr += 1
            ordered = self.peers[start:] + self.peers[:start]
        return [p for p in ordered if self._peer_ok(p)]

    def _get(self, peer: str, path: str) -> bytes:
        req = urllib.request.Request(peer.rstrip("/") + path)
        with _urlopen(req, timeout=self.timeout_s) as r:
            return r.read()

    # -- fetch surface -------------------------------------------------------

    def manifest(self, step: Optional[int] = None) -> dict:
        """Resolve the step + manifest from the first healthy peer;
        pins ``self.step`` so every subsequent shard read is coherent
        (peers prune independently — mixing steps would be corrupt)."""
        last = "no healthy weight peer"
        q = f"?step={step}" if step is not None else ""
        for peer in self._order():
            try:
                payload = json.loads(
                    self._get(peer, f"/v1/weights/manifest{q}"))
            except Exception as e:
                last = f"{peer}: {e}"
                self._mark_down(peer)
                continue
            self.step = int(payload["step"])
            self._manifest = payload["manifest"]
            self._by_file = {
                s["file"]: s
                for e in self._manifest["leaves"].values()
                for s in e["shards"]}
            return self._manifest
        raise WeightFetchError(f"manifest fetch failed: {last}")

    def reader(self, fname: str) -> bytes:
        """``restore_sharded`` byte source: fetch one shard (or the
        manifest) from the rotation, verifying the frame digest AND the
        manifest digest the saving process wrote."""
        if fname == "manifest.json":
            if self._manifest is None:
                self.manifest()
            return json.dumps(self._manifest).encode()
        if self.step is None:
            self.manifest()
        q = (f"/v1/weights/shard?step={self.step}"
             f"&file={urllib.parse.quote(fname)}")
        last = "no healthy weight peer"
        first = True
        for peer in self._order():
            if not first:
                with self._lock:
                    self.retries += 1
            first = False
            try:
                meta, body = unpack_frame(self._get(peer, q))
            except Exception as e:
                last = f"{peer}: {e}"
                self._mark_down(peer)
                continue
            if meta.get("file") != fname or meta.get("step") != self.step:
                self._mark_down(peer)
                last = f"{peer}: answered wrong shard {meta.get('file')!r}"
                continue
            want = self._by_file.get(fname, {}).get("digest")
            if want is not None \
                    and hashlib.blake2s(body).hexdigest() != want:
                # the peer's frame was self-consistent but does not
                # match the manifest: wrong bytes end-to-end
                self._mark_down(peer)
                last = f"{peer}: shard {fname!r} fails manifest digest"
                continue
            with self._lock:
                self.shards_fetched += 1
                self.bytes_fetched += len(body)
            if self.metrics is not None:
                self.metrics.counter("weights.shards_fetched")
                self.metrics.counter("weights.bytes_fetched", len(body))
            return body
        raise WeightFetchError(f"shard {fname!r}: {last}")

    def gangstate(self) -> bytes:
        """Fetch the raw GANGSTATE frame a frozen gang published for its
        live training state (its consumer verifies the frame)."""
        last = "no healthy weight peer"
        for peer in self._order():
            try:
                return self._get(peer, "/v1/weights/gangstate")
            except Exception as e:
                last = f"{peer}: {e}"
                self._mark_down(peer)
                continue
        raise WeightFetchError(f"gangstate fetch failed: {last}")

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            down = sorted(self._down)
        return {"peers": list(self.peers), "peers_down": down,
                "step": self.step, "shards_fetched": self.shards_fetched,
                "bytes_fetched": self.bytes_fetched,
                "retries": self.retries}


def restore_from_peers(peers, template, step: Optional[int] = None, *,
                       workers: Optional[int] = None,
                       timeout_s: float = 120.0,
                       metrics: Optional[MetricsRegistry] = None,
                       fetcher: Optional[PeerFetcher] = None) -> Any:
    """Boot-path weight load from an already-hot sibling: resolve the
    newest step a healthy peer serves, then stream its shards through
    ``restore_sharded`` (concurrent digest-checked fetches, each tensor
    placed on the template's device as its shard lands). Raises :class:`WeightFetchError` when no peer can
    serve — the caller's contract is degrade-not-crash: fall back to
    the disk restore and count it."""
    f = fetcher if fetcher is not None else PeerFetcher(
        peers, timeout_s=timeout_s, metrics=metrics)
    if not f.peers:
        raise WeightFetchError("no weight peers configured")
    manifest = f.manifest(step)
    try:
        return ckpt.restore_sharded(None, template, workers=workers,
                                    reader=f.reader, manifest=manifest)
    except ckpt.CheckpointCorrupt as e:
        raise WeightFetchError(str(e)) from None


def mirror_from_peers(peers, out_dir: str,
                      step: Optional[int] = None, *,
                      pid: int = 0, timeout_s: float = 120.0,
                      fetcher: Optional[PeerFetcher] = None) -> int:
    """Land a peer's newest step as a committed LOCAL step directory
    (dot-tmp + ``os.rename``, the checkpoint commit protocol) so the
    freshly-booted replica immediately serves its own siblings.
    Shards are fetched, verified and written ``RESTORE_WORKERS`` (4) at
    a time: the digests release the interpreter lock. Returns the
    mirrored step number."""
    f = fetcher if fetcher is not None else PeerFetcher(
        peers, timeout_s=timeout_s)
    manifest = f.manifest(step)
    got = f.step
    final = os.path.join(out_dir, f"step-{got:08d}-p{pid}")
    tmp = os.path.join(out_dir, f".step-{got:08d}-p{pid}.tmp")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    def land(shard: dict) -> None:
        # the reader held the body to its frame and manifest digests; the
        # reference hashes it a third time, here only the length is held
        body = f.reader(shard["file"])
        ckpt._verify_shard({**shard, "digest": None}, body, "peer")
        with open(os.path.join(tmp, shard["file"]), "wb") as fh:
            fh.write(body)

    shards = [shard for entry in manifest["leaves"].values()
              for shard in entry["shards"]]
    with ThreadPoolExecutor(
            max_workers=ckpt._restore_workers(None)) as pool:
        list(pool.map(land, shards))
    with open(os.path.join(tmp, "manifest.json"), "w",
              encoding="utf-8") as fh:
        json.dump(manifest, fh)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return got
