"""KV spans on the wire: the span half of ``dcos_commons_tpu/models/
disagg.py`` (the port imports nothing of the JAX package).

A span is a run of full KV pages with its prompt, ``[L, N, page, KV,
D]`` per side (``{"q", "s"}`` for int8 pools), framed as KVSPAN1:
``MAGIC | header_len | header JSON | raw array bytes``, byte-identical
to the reference's frame for the same span. The header carries the
prompt, the per-page prefix hashes and a digest of the body, so a
mangled transfer dies in :func:`unpack_span` before anything touches a
page ledger.

:func:`fetch_prefix` is the fleet prefix-adoption client: it asks a
sibling's front door (``POST /v1/prefix``) for its longest cached prefix
of a prompt and is what ``PagedServer``'s ``peer_fetch`` calls.

Transport: the reference moves bytes through ``security/transport.py``
when it is importable (TLS for ``https://``); that module is not ported,
so this is the reference's own fallback: plain ``urllib`` for
``http://`` and :class:`PageShipError` for ``https://``. The
disaggregated tiers (``KVShipper``, ``PrefillWorker``,
``DisaggCoordinator``) are not ported yet.
"""

from __future__ import annotations

import hashlib
import json
import struct
import urllib.request
from typing import Any, Dict, List, Optional

from .paging import (flatten_payload, pack_arrays, page_hashes,
                     payload_from_arrays, unpack_arrays)

_MAGIC = b"KVSPAN1\0"
_WIRE_VERSION = 1


class PageShipError(RuntimeError):
    """A KV shipment that must not be adopted: framing, digest or
    prefix-hash verification failed."""


def pack_span(span: Dict[str, Any]) -> bytes:
    """Frame a span (``PagedServer.export_prefix``'s result) for the
    wire. The header names every array (shape and dtype), carries the
    prompt, first token, page size, the int8 flag, the per-page prefix
    hashes and a digest of the body."""
    specs, body = pack_arrays(flatten_payload(span["payload"]))
    meta = {
        "version": _WIRE_VERSION,
        "prompt": [int(t) for t in span["prompt"]],
        "first_token": int(span["first_token"]),
        "page_size": int(span["page_size"]),
        "kv_quant": bool(span["kv_quant"]),
        "page_hashes": page_hashes(span["prompt"], span["page_size"]),
        "body_digest": hashlib.blake2s(body).hexdigest(),
        "arrays": specs,
    }
    header = json.dumps(meta).encode()
    return _MAGIC + struct.pack("<I", len(header)) + header + body


def unpack_span(data: bytes) -> Dict[str, Any]:
    """Parse and VERIFY a framed span: magic, version, body digest, and
    the prefix hashes against the shipped prompt. Raises
    :class:`PageShipError` on any mismatch. Arrays come back as CPU
    tensors."""
    if not data.startswith(_MAGIC):
        raise PageShipError("bad magic: not a KV span frame")
    off = len(_MAGIC)
    if len(data) < off + 4:
        raise PageShipError("truncated frame: no header length")
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    try:
        meta = json.loads(data[off:off + hlen])
        if not isinstance(meta, dict):
            raise ValueError("not an object")
    except ValueError as e:
        raise PageShipError(f"bad header: {e}") from None
    off += hlen
    if meta.get("version") != _WIRE_VERSION:
        raise PageShipError(f"wire version {meta.get('version')} != "
                            f"{_WIRE_VERSION}")
    body = memoryview(data)[off:]
    if hashlib.blake2s(body).hexdigest() != meta.get("body_digest"):
        raise PageShipError("body digest mismatch: corrupt transfer")
    try:
        prompt = [int(t) for t in meta["prompt"]]
        hashes_ok = (page_hashes(prompt, int(meta["page_size"]))
                     == meta["page_hashes"])
    except (KeyError, TypeError, ValueError) as e:
        raise PageShipError(f"bad header: {e}") from None
    if not hashes_ok:
        raise PageShipError("prefix-hash mismatch: prompt and pages "
                            "disagree")
    arrays = unpack_arrays(body, meta.get("arrays", []), PageShipError)
    payload = payload_from_arrays(arrays, PageShipError, "pages")
    return {"version": meta["version"], "prompt": prompt,
            "first_token": meta["first_token"],
            "page_size": meta["page_size"],
            "kv_quant": meta["kv_quant"],
            "page_hashes": meta["page_hashes"], "payload": payload}


def _transport_urlopen(req, timeout: float):
    """The reference's fallback transport: cleartext ``http://`` through
    plain urllib; ``https://`` is a hard error, since silently
    unverified TLS would defeat the point."""
    url = req.full_url if hasattr(req, "full_url") else str(req)
    if str(url).startswith("https://"):
        raise PageShipError(
            "https:// KV shipping needs security/transport.py, which is "
            "not ported")
    return urllib.request.urlopen(req, timeout=timeout)


def fetch_prefix(peer: str, prompt: List[int],
                 timeout_s: float = 30.0) -> Optional[Dict[str, Any]]:
    """Fetch a sibling replica's longest cached prefix of ``prompt`` as a
    verified span (``ServingFrontend``'s ``POST /v1/prefix``). Adoption
    is an optimization: on a miss (404), a transport failure or a frame
    that fails :func:`unpack_span`, this returns None and the asker
    recomputes."""
    req = urllib.request.Request(
        peer.rstrip("/") + "/v1/prefix",
        data=json.dumps({"prompt": [int(t) for t in prompt]}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with _transport_urlopen(req, timeout=timeout_s) as r:
            data = r.read()
        return unpack_span(data)
    except Exception:
        return None
