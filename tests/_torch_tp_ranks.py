"""Rank functions of the port's tensor-parallel CPU tests: each runs in
one member of a gang that ``parallel.distributed.launch_local`` starts,
so this module imports torch and the port only, never JAX. Inputs come
from a ``torch.save`` file the test writes; results go back as numpy
arrays and plain Python values."""

import hashlib
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dcos_commons_tpu_torch.models import llama as tl  # noqa: E402
from dcos_commons_tpu_torch.models import serving as ts  # noqa: E402
from dcos_commons_tpu_torch.parallel import checkpoint as tc  # noqa: E402
from dcos_commons_tpu_torch.parallel import distributed  # noqa: E402
from dcos_commons_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


def _heads(a, mesh):
    """The rank's KV heads (axis 3) of a whole cache or pool tensor."""
    n = a.shape[3] // mesh.shape["tp"]
    return a.narrow(3, mesh.coords["tp"] * n, n).clone()


def _kv(whole, mesh):
    """A whole port cache or pool {"k", "v"} as the rank's."""
    return {side: (tl.QTensor(_heads(a.q, mesh), _heads(a.s, mesh))
                   if isinstance(a, tl.QTensor) else _heads(a, mesh))
            for side, a in whole.items()}


class _Digests:
    """Records a digest of the logits each engine step selects from."""

    def __init__(self, engine):
        self.seen = []
        inner = engine._select

        def select(logits):
            self.seen.append(hashlib.sha1(
                logits.float().contiguous().numpy().tobytes()).hexdigest())
            return inner(logits)

        engine._select = select


def battery(path: str) -> dict:
    """Everything one gang member computes for ``tests/
    test_torch_tp.py``: per model variant the decode steps' logits and
    written K/V, both engines' streams and per-step logit digests; with
    ``ckpt_dir`` the gang checkpoint round trip."""
    inputs = torch.load(path, weights_only=False)
    world = int(os.environ[distributed.NUM_PROCESSES_ENV])
    again = distributed.initialize()
    mesh = MeshSpec(tp=world).build("cpu")
    out = {"rank": mesh.rank, "backend": mesh.backend,
           "contract": again, "variants": {}}
    for name, var in inputs["variants"].items():
        cfg = tl.LlamaConfig.tiny(**var["cfg"])
        params = tl.shard_params(var["params"], mesh, cfg)
        res = out["variants"][name] = {}
        steps = var.get("steps")
        if steps is not None:
            res.update(_steps(cfg, params, mesh, steps))
        for engine, kw in var["engines"].items():
            cls = ts.SlotServer if engine == "slots" else ts.PagedServer
            srv = cls(cfg, params, device="cpu", mesh=mesh, **kw)
            dig = _Digests(srv)
            got = srv.drain([dict(r) for r in var["requests"]],
                            decode_window=var.get("window", 1))
            res[engine] = {"streams": got, "digests": dig.seen,
                           "graphs": srv.graph_stats()["off_reason"]}
            if engine == "paged":
                res[engine]["ledger"] = srv.ledger_violations()
                res[engine]["tp"] = srv.page_stats()["tp"]
    if inputs.get("ckpt_dir"):
        out["ckpt"] = _checkpoint(inputs, mesh)
    return out


def _steps(cfg, params, mesh, steps) -> dict:
    """The three decode-path steps on the rank's slices of the same
    whole caches and pools."""
    res = {}
    s = steps["slots"]
    cache = _kv(s["cache"], mesh)
    logits, cache = tl.decode_step_slots(
        cfg, params, cache, torch.from_numpy(s["lengths"]),
        torch.from_numpy(s["tokens"]), mesh=mesh)
    res["step_slots"] = (_np(logits), _cache_np(cache))
    p = steps["paged"]
    pool = _kv(p["pool"], mesh)
    logits, pool = tl.decode_step_paged(
        cfg, params, pool, torch.from_numpy(p["table"]),
        torch.from_numpy(p["lengths"]), torch.from_numpy(p["tokens"]),
        mesh=mesh)
    res["step_paged"] = (_np(logits), _cache_np(pool))
    c = steps["chunk"]
    pool = _kv(c["pool"], mesh)
    logits, pool = tl.prefill_chunk_paged(
        cfg, params, pool, torch.from_numpy(c["table"]),
        torch.from_numpy(c["tokens"]), c["start"], c["true_len"],
        c["logit_index"], c["scratch"], mesh=mesh)
    res["step_chunk"] = (_np(logits), _cache_np(pool))
    g = steps["generate"]
    prompt = torch.from_numpy(g["prompt"])
    res["generate"] = tl.generate(cfg, params, prompt, g["steps"],
                                  mesh=mesh).numpy()
    res["generate_chunked"] = tl.generate_chunked(
        cfg, params, prompt, g["steps"], chunk=4, mesh=mesh).numpy()
    return res


def _cache_np(kv):
    return {side: ((a.q.numpy(), _np(a.s)) if isinstance(a, tl.QTensor)
                   else _np(a)) for side, a in kv.items()}


def _checkpoint(inputs, mesh) -> dict:
    """Gang save / latest_step / restore on this rank's shards of the
    fp32 weights: step 1 on every rank, step 2 on rank 0 only (the gang
    must agree on 1), then a restore into the sharded template."""
    out_dir = inputs["ckpt_dir"]
    var = inputs["variants"][inputs["ckpt_variant"]]
    cfg = tl.LlamaConfig.tiny(**var["cfg"])
    params = tl.shard_params(var["params"], mesh, cfg)
    specs = tl.param_specs(cfg)
    tc.save_sharded(out_dir, 1, params, mesh=mesh, specs=specs)
    if mesh.rank == 0:
        tc.save_sharded(out_dir, 2, params, mesh=mesh, specs=specs)
    step = tc.latest_step(out_dir)
    got = tc.restore_sharded(out_dir, tl.param_template(
        cfg, "cpu", mesh=mesh), step, mesh=mesh, specs=specs)
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tc._flatten(params), tc._flatten(got)))
    with open(os.path.join(tc._step_dir(out_dir, 1, mesh.rank),
                           "manifest.json"), encoding="utf-8") as f:
        manifest = f.read()
    return {"latest": step, "bitwise": same, "manifest": manifest,
            "boot": _boot_sources(out_dir, cfg, mesh, specs)}


def _boot_sources(out_dir, cfg, mesh, specs) -> dict:
    """The worker's boot from the gang checkpoint, whole and then with
    one of the last rank's shards of the agreed step truncated: the
    source and the fallback events of each boot on this rank."""
    import contextlib
    import io
    import json

    from dcos_commons_tpu_torch.frameworks import worker

    args = worker.build_parser().parse_args(
        ["llama", "--serve", "--out", out_dir])
    out = {}
    for case in ("whole", "one_rank_corrupt"):
        if case == "one_rank_corrupt" and mesh.rank == mesh.size - 1:
            shard = os.path.join(tc._step_dir(out_dir, 1, mesh.rank),
                                 "norm.o0.bin")
            with open(shard, "rb") as f:
                raw = f.read()
            with open(shard, "wb") as f:
                f.write(raw[:-2])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, report = worker._boot_serving_weights(
                args, lambda: tl.param_template(cfg, "cpu", mesh=mesh),
                lambda: "init", mesh=mesh, specs=specs)
        out[case] = {"source": report["source"], "events": [
            json.loads(line)["event"]
            for line in buf.getvalue().splitlines()]}
    return out


def card_gang(requests) -> dict:
    """The card tests' gang member: a tiny Llama (head_dim 64) from seed
    0 on ``cuda:(rank % count)``, both engines in fp32 over the dense
    path and in bf16 through the decode and prefill kernels, with this
    rank's kernel launches in the bf16 runs."""
    import dataclasses

    import torch.distributed as dist
    from dcos_commons_tpu_torch.ops import flash_attention as fa
    from dcos_commons_tpu_torch.ops import flash_decode as fd

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = MeshSpec(tp=dist.get_world_size()).build("cuda")
    dev = mesh.device
    out = {"backend": mesh.backend, "device": str(dev)}
    base = tl.LlamaConfig.tiny(n_layers=2, dim=256, n_heads=4, n_kv_heads=2,
                               max_seq=256)
    for name, cfg in (("fp32", dataclasses.replace(
            base, dtype=torch.float32, decode_attn="dense")),
            ("bf16", base)):
        params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(
            0), device=dev, mesh=mesh)
        kernels = (fd.flash_decode_paged, fd.flash_decode,
                   fa.flash_attention_fwd)
        before = [k.launches for k in kernels]
        for engine, cls, kw in (
                ("paged", ts.PagedServer, dict(page_size=16,
                                               prefill_chunk=16)),
                ("slots", ts.SlotServer, {})):
            srv = cls(cfg, params, slots=2, device=dev, mesh=mesh, **kw)
            out[f"{name}_{engine}"] = srv.drain(
                [dict(r) for r in requests], decode_window=4)
        out[f"{name}_launches"] = [k.launches - b
                                   for k, b in zip(kernels, before)]
    return out
