"""The port's process mesh and Megatron shards, in one process (the
gangs are ``tests/test_torch_tp.py``'s and ``tests/
test_torch_serving_gang.py``'s):

* ``MeshSpec`` against the reference's (``axis_sizes``, ``size``,
  ``auto``), ``choose_backend`` from a given layout, the refusals of
  ``build`` (pp, sp and ep; a size the process group does not have) and
  the one-process mesh;
* a rank's coordinates and each axis's groups against the device grid of
  JAX's mesh, and on a gloo gang of 4 (started once for the module by
  ``launch_local``, running ``tests/_torch_dp_ranks.mesh_battery``):
  ``MeshSpec(dp=2, dcn=2)`` is one dp axis of 4 in rank order,
  ``MeshSpec(dp=2, tp=2)`` reduces over the right ranks on each axis,
  and the gradient through ``Mesh.all_reduce_mean`` is 4 times (the
  gradients are then averaged over dp) autograd's through the explicit
  mean in one process; on a gang of 2 (``tests/_torch_tp_train_ranks.
  megatron_pair``), Megatron's pair: ``copy_to``'s gradient is the
  explicit sum of the ranks' cotangents (also when autograd shares the
  cotangent with another branch), ``reduce_from``'s forward the sum and
  its gradient the rank's own, ``gather_from``'s gradient the rank's
  slice, and ``all_reduce_max`` the elementwise largest;
* ``shard_params`` leaf by leaf against JAX ``shard_params`` on
  ``MeshSpec(tp=N)`` over N of the 8 virtual CPU devices: each rank's
  slice equals JAX's shard on that device bitwise, fp32, bf16 and int8
  ``QTensor`` scales included (a rank here is a ``Mesh`` with that
  coordinate and no process group: slicing needs no collective);
* ``init_params(mesh=)`` is bitwise ``shard_params(init_params())``,
  ``param_template(mesh=)`` has the shard shapes, the divisibility
  checks, the sharded bridge, the sharded caches and pools;
* the gang checkpoint's file names and layouts against JAX's for every
  rank, and the tp routing of decode attention and its wrappers;
* what the engines refuse under tp > 1, and ``topology_key``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.parallel import checkpoint as jc
from dcos_commons_tpu.parallel import mesh as jmesh
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.ops import flash_attention as tfa
from dcos_commons_tpu_torch.ops import flash_decode as tfd
from dcos_commons_tpu_torch.ops.quant import QTensor
from dcos_commons_tpu_torch.parallel import aot
from dcos_commons_tpu_torch.parallel import checkpoint as tc
from dcos_commons_tpu_torch.parallel import mesh as tmesh


def _rank(tp, r, device="cpu", backend="gloo"):
    """Rank ``r`` of a tp mesh, without a process group."""
    coords = {a: 0 for a in tmesh.AXES}
    coords["tp"] = r
    shape = {a: 1 for a in tmesh.AXES}
    shape["tp"] = tp
    return tmesh.Mesh(shape, coords, torch.device(device), backend, rank=r)


@pytest.mark.parametrize("kw", [{}, {"tp": 2}, {"dp": 2, "tp": 4},
                                {"pp": 3, "ep": 2, "dcn": 2},
                                {"sp": 2, "tp": 2, "ep": 2}])
def test_mesh_spec_matches_the_reference(kw):
    t, j = tmesh.MeshSpec(**kw), jmesh.MeshSpec(**kw)
    assert tmesh.AXES == jmesh.AXES
    assert t.axis_sizes() == j.axis_sizes() and t.size == j.size


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 32, 64])
@pytest.mark.parametrize("prefer", [("tp", "pp", "ep", "sp"), ("tp",),
                                    ("ep", "tp")])
def test_mesh_spec_auto_matches_the_reference(n, prefer):
    assert dataclasses.asdict(tmesh.MeshSpec.auto(n, prefer)) == \
        dataclasses.asdict(jmesh.MeshSpec.auto(n, prefer))


@pytest.mark.parametrize("layout,want", [
    ([("h0", "GPU-a"), ("h0", "GPU-b")], "nccl"),
    ([("h0", "GPU-a"), ("h1", "GPU-a")], "nccl"),
    ([("h0", "GPU-a"), ("h0", "GPU-a")], "gloo"),
    ([("h0", "GPU-a"), ("h0", "GPU-b"), ("h0", "GPU-a"), ("h0", "GPU-c")],
     "gloo"),
    ([("h0", None), ("h0", None)], "gloo"),
    ([("h0", None), ("h1", None)], "gloo"),
    ([("h0", "GPU-a"), ("h1", None)], "gloo"),
])
def test_backend_follows_the_layout(layout, want):
    """NCCL only when every rank drives a card no other rank drives."""
    assert tmesh.choose_backend(layout) == want


@pytest.mark.parametrize("axis", ["dp", "pp", "sp", "ep"])
def test_build_refuses_axes_other_than_tp(axis):
    """Every axis is ported (dp with dcn folded into it, sp, and since
    the ep and pp axes pp and ep): one process is too few for any of
    them, alone or beside dp."""
    for kw in ({axis: 2}, {"dcn": 2}, {"dp": 2, axis: 2}):
        with pytest.raises(ValueError, match="processes"):
            tmesh.MeshSpec(**kw).build("cpu")


@pytest.mark.parametrize("kw", [{"dp": 2, "tp": 2}, {"dp": 2, "dcn": 2},
                                {"dp": 2, "pp": 2, "tp": 2},
                                {"dp": 2, "sp": 2, "ep": 2}])
def test_coords_and_groups_follow_the_reference_device_grid(kw):
    """Rank r is device r of JAX's mesh over the virtual CPU devices (in
    order): its coordinates are that device's place in the grid, and an
    axis's groups are the grid's lines along it."""
    jm = jmesh.MeshSpec(**kw).build(
        jax.devices()[:jmesh.MeshSpec(**kw).size])
    grid = np.vectorize(lambda d: d.id)(jm.devices)
    shape = dict(zip(tmesh.AXES, tmesh.MeshSpec(**kw).axis_sizes()))
    for idx, r in np.ndenumerate(grid):
        assert tmesh.mesh_coords(shape, int(r)) == dict(
            zip(tmesh.AXES, idx))
    for i, axis in enumerate(tmesh.AXES):
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[axis])
        assert tmesh.axis_groups(shape, axis) == lines.tolist()


@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    from dcos_commons_tpu_torch.parallel.distributed import launch_local
    from tests import _torch_dp_ranks
    rng = np.random.default_rng(3)
    inputs = {"x": rng.standard_normal((4, 5)).astype(np.float32),
              "w": rng.standard_normal((4, 5)).astype(np.float32)}
    path = str(tmp_path_factory.mktemp("mesh4") / "inputs.pt")
    torch.save(inputs, path)
    return inputs, launch_local(_torch_dp_ranks.mesh_battery, 4, path,
                                timeout_s=300, threads=1)


def test_dcn_folds_into_one_dp_axis_in_rank_order(gang4):
    _, ranks = gang4
    for r, got in enumerate(ranks):
        m = got["dcn"]
        assert m["shape"] == {"dp": 4, "pp": 1, "sp": 1, "tp": 1, "ep": 1}
        assert m["coords"] == {"dp": r, "pp": 0, "sp": 0, "tp": 0, "ep": 0}
        assert m["rank"] == r and m["dp_sum"] == 0 + 1 + 2 + 3


def test_dp_by_tp_reduces_over_each_axis_s_own_ranks(gang4):
    """dp=2 x tp=2: rank r sits at (r // 2, r % 2); tp groups {0, 1},
    {2, 3}; dp groups {0, 2}, {1, 3}."""
    _, ranks = gang4
    for r, got in enumerate(ranks):
        m = got["dp_tp"]
        assert (m["coords"]["dp"], m["coords"]["tp"]) == (r // 2, r % 2)
        assert m["rank"] == r
        tp_peers = [r - r % 2, r - r % 2 + 1]
        dp_peers = [r % 2, r % 2 + 2]
        assert m["tp_sum"] == sum(tp_peers)
        assert m["tp_gather"] == [float(p) for p in tp_peers]
        assert m["dp_sum"] == sum(dp_peers)


def test_all_reduce_mean_s_gradient_is_the_explicit_mean_s(gang4):
    """``y = all_reduce_mean(x_r)`` and each rank's loss ``sum(w_r *
    y**2)``: the forward is the mean on every rank, and each rank's
    gradient is n times autograd's of the mean loss through ``X.mean(0)``
    on one process (the step then averages the ranks' gradients)."""
    inputs, ranks = gang4
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    w = torch.from_numpy(inputs["w"])
    y = x.mean(0)
    loss = torch.stack([(w[r] * y.square()).sum() for r in range(4)]).mean()
    (gx,) = torch.autograd.grad(loss, x)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["mean"], y.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["grad"], 4 * gx[r].numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert got["collectives"] == 2
        # the input is the rank's own after the collective
        np.testing.assert_array_equal(got["x_after_forward"], got["own"])
        np.testing.assert_array_equal(got["own"], inputs["x"][r])


def test_all_reduce_mean_leaves_a_shared_cotangent_alone(gang4):
    """``sum(w_r * (all_reduce_mean(x_r) + x_r))``: the add hands one
    cotangent to both branches, and the collective's backward must not
    reduce it in place. Each rank's gradient is n times autograd's of the
    mean loss through the explicit ``X.mean(0) + X`` in one process."""
    inputs, ranks = gang4
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    w = torch.from_numpy(inputs["w"])
    z = x.mean(0) + x
    (gx,) = torch.autograd.grad((w * z).sum(1).mean(), x)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["grad_shared"], 4 * gx[r].numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def pair2(tmp_path_factory):
    from dcos_commons_tpu_torch.parallel.distributed import launch_local
    from tests import _torch_tp_train_ranks
    rng = np.random.default_rng(4)
    inputs = {"x": rng.standard_normal((2, 5)).astype(np.float32),
              "w": rng.standard_normal((2, 5)).astype(np.float32),
              "w_whole": rng.standard_normal(10).astype(np.float32)}
    path = str(tmp_path_factory.mktemp("pair2") / "inputs.pt")
    torch.save(inputs, path)
    return inputs, launch_local(_torch_tp_train_ranks.megatron_pair, 2, path,
                                timeout_s=300, threads=1)


def test_megatron_pair_s_gradients_are_the_explicit_sums(pair2):
    """``f`` (``copy_to``): the rank's own ``x`` forward, and the sum of
    every rank's ``w`` backward; ``g`` (``reduce_from``): the sum of the
    ranks' ``x`` forward, and the rank's own ``w`` backward; with the add
    ``copy_to(x) + x`` sharing the cotangent, the sum plus the own ``w``.
    No input is overwritten; outside autograd ``f`` is ``x`` itself."""
    inputs, ranks = pair2
    x, w = inputs["x"], inputs["w"]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["copy_to"]["y"], x[r])
        np.testing.assert_allclose(got["copy_to"]["grad"], w.sum(0),
                                   rtol=1e-6)
        assert got["copy_to_collectives"] == 1
        np.testing.assert_allclose(got["reduce_from"]["y"], x.sum(0),
                                   rtol=1e-6)
        np.testing.assert_array_equal(got["reduce_from"]["grad"], w[r])
        np.testing.assert_allclose(got["shared"]["grad"], w.sum(0) + w[r],
                                   rtol=1e-6)
        for case in ("copy_to", "reduce_from", "shared", "gather_from"):
            np.testing.assert_array_equal(got[case]["x_after"], x[r])
        assert got["no_grad_copy_is_x"]
    assert ranks[0]["reduce_from"]["y"].tobytes() == \
        ranks[1]["reduce_from"]["y"].tobytes()


def test_gather_from_s_gradient_is_the_rank_s_slice(pair2):
    inputs, ranks = pair2
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["gather_from"]["y"],
                                      inputs["x"].reshape(-1))
        np.testing.assert_array_equal(got["gather_from"]["grad"],
                                      inputs["w_whole"][5 * r:5 * r + 5])
        np.testing.assert_array_equal(got["max"], inputs["x"].max(0))
        # copy_to 1 (backward), reduce_from 1, the shared add 1, the
        # gather 1, the max 1
        assert got["collectives"] == 5


def test_one_process_mesh_needs_no_group():
    mesh = tmesh.MeshSpec().build("cpu")
    assert mesh.size == 1 and mesh.backend == "local"
    assert mesh.device == torch.device("cpu") and mesh.rank == 0
    x = torch.arange(6.0).reshape(2, 3)
    assert mesh.all_reduce(x) is x and mesh.all_gather(x) is x
    arr = np.arange(4, dtype=np.int32)
    assert mesh.broadcast_array(arr) is arr
    assert tmesh.host_all_gather(arr).tolist() == [[0, 1, 2, 3]]
    with pytest.raises(ValueError, match="2 processes"):
        tmesh.MeshSpec(tp=2).build("cpu")


def test_local_chunk_matches_the_reference():
    jm = jmesh.MeshSpec(tp=2).build(jax.devices()[:2])
    assert tmesh.local_chunk(64, _rank(2, 0), "tp") == \
        jmesh.local_chunk(64, jm, "tp") == 32
    with pytest.raises(ValueError, match="divisible"):
        tmesh.local_chunk(63, _rank(2, 1), "tp")


# ---------------------------------------------------------------------------
# the shards


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, QTensor) or hasattr(tree, "q"):
        yield prefix + "q", tree.q
        yield prefix + "s", tree.s
    else:
        yield prefix[:-1], tree


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_shard_params_matches_jax_leaf_by_leaf(tp, kind):
    jcfg = jl.LlamaConfig.tiny(n_layers=2, attn_impl="dense",
                               dtype=jax.numpy.bfloat16 if kind == "bf16"
                               else jax.numpy.float32)
    tcfg = tl.LlamaConfig.tiny(n_layers=2)
    jp = jl.init_params(jcfg, jax.random.key(0))
    if kind == "int8":
        jp = jl.quantize_params(jp)
    jm = jmesh.MeshSpec(tp=tp).build(jax.devices()[:tp])
    with jm:
        js = jl.shard_params(jp, jm, jcfg)
    full = params_from_jax(jax.device_get(jp), "cpu")
    want = dict(_leaves(js))
    for r in range(tp):
        got = dict(_leaves(tl.shard_params(full, _rank(tp, r), tcfg)))
        assert set(got) == set(want)
        dev = jm.devices.flat[r]
        for key, arr in want.items():
            shard = next(s.data for s in arr.addressable_shards
                         if s.device == dev)
            assert tuple(got[key].shape) == tuple(shard.shape), key
            np.testing.assert_array_equal(_np(got[key]), _np(shard),
                                          err_msg=key)


def test_sharded_init_and_template_are_the_shards():
    cfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    full = tl.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for r in range(2):
        mesh = _rank(2, r)
        want = tl.shard_params(full, mesh, cfg)
        got = tl.init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                             mesh=mesh)
        tmpl = tl.param_template(cfg, "cpu", mesh=mesh)
        for (k, a), (_, b), (_, t) in zip(_leaves(want), _leaves(got),
                                          _leaves(tmpl)):
            assert torch.equal(a, b), k
            assert a.shape == t.shape and a.dtype == t.dtype, k
            assert b.is_contiguous()
    assert tl.shard_params(full, _rank(1, 0), cfg) is full
    assert tl.shard_params(full, None, cfg) is full


@pytest.mark.parametrize("field,value,tp", [
    ("n_heads", 8, 3), ("n_kv_heads", 4, 8), ("ffn_dim", 122, 4),
    ("vocab_size", 242, 4)])
def test_tp_must_divide_every_sharded_dimension(field, value, tp):
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(
        n_layers=1, n_heads=8, n_kv_heads=4, ffn_dim=120, vocab_size=240),
        **{field: value})
    full = tl.param_template(cfg, "cpu")
    with pytest.raises(ValueError, match=field):
        tl.shard_params(full, _rank(tp, 0), cfg)


def test_moe_trees_are_not_sharded():
    """Not over tp: MoE under tensor parallelism is item 7b (a MoE tree
    shards its experts over ep, ``tests/test_torch_ep_pp.py``)."""
    cfg = tl.LlamaConfig.tiny(n_layers=1)
    tree = tl.param_template(cfg, "cpu", num_experts=4)
    with pytest.raises(NotImplementedError, match="item 7b"):
        tl.shard_params(tree, _rank(2, 0), cfg)


def test_bridge_shards_on_the_host():
    jcfg = jl.LlamaConfig.tiny(n_layers=1, attn_impl="dense")
    tcfg = tl.LlamaConfig.tiny(n_layers=1)
    jp = jax.device_get(jl.quantize_params(
        jl.init_params(jcfg, jax.random.key(1))))
    full = params_from_jax(jp, "cpu")
    got = params_from_jax(jp, "cpu", mesh=_rank(2, 1), cfg=tcfg)
    want = tl.shard_params(full, _rank(2, 1), tcfg)
    for (k, a), (_, b) in zip(_leaves(want), _leaves(got)):
        assert torch.equal(a, b), k


def test_sharded_caches_hold_the_rank_heads():
    cfg = tl.LlamaConfig.tiny(n_layers=2, kv_quant=True)
    pool = tl.init_page_pool(cfg, 5, 8, "cpu", mesh=_rank(4, 3))
    cache = tl.init_kv_cache(cfg, 3, 16, "cpu", mesh=_rank(2, 1))
    assert tuple(pool["k"].q.shape) == (2, 5, 8, 1, cfg.head_dim)
    assert tuple(pool["k"].s.shape) == (2, 5, 8, 1, 1)
    assert tuple(cache["v"].q.shape) == (2, 3, 16, 2, cfg.head_dim)
    with pytest.raises(ValueError, match="n_kv_heads"):
        tl.init_kv_cache(cfg, 1, 16, "cpu", mesh=_rank(8, 0))


@pytest.mark.parametrize("tp", [2, 4])
def test_gang_checkpoint_names_and_layouts_match_jax(tmp_path, tp):
    """Rank r's save of its shards holds exactly the shard entries
    (file, index, shape, digest) JAX's save of the sharded tree holds
    for device r, under the same global shapes."""
    jcfg = jl.LlamaConfig.tiny(n_layers=1, attn_impl="dense")
    tcfg = tl.LlamaConfig.tiny(n_layers=1)
    jp = jl.init_params(jcfg, jax.random.key(2))
    jm = jmesh.MeshSpec(tp=tp).build(jax.devices()[:tp])
    with jm:
        js = jl.shard_params(jp, jm, jcfg)
    jleaves, _ = jc.export_tree(js)
    full = params_from_jax(jax.device_get(jp), "cpu")
    union = {}
    for r in range(tp):
        mesh = _rank(tp, r)
        leaves, _ = tc.export_tree(tl.shard_params(full, mesh, tcfg))
        layouts = [pl.layout for pl in tc._places(
            tl.shard_params(full, mesh, tcfg), mesh, tl.param_specs(tcfg))]
        for (key, entry), layout in zip(leaves.items(), layouts):
            shape, starts = layout or (entry["global_shape"], None)
            ikey = tc._index_key(len(shape), starts)
            union.setdefault(key, set()).add(ikey)
            assert shape == jleaves[key]["global_shape"], key
    for key, entry in jleaves.items():
        assert union[key] == {s["index"] for s in entry["shards"]}, key


def test_decode_routing_takes_the_mesh_rule():
    cfg = tl.LlamaConfig.tiny(decode_attn="flash")
    cuda = torch.device("cuda")
    assert tl._use_flash_decode(cfg, torch.device("cpu"), _rank(2, 0))
    assert tl._use_flash_decode(cfg, torch.device("cpu"), _rank(4, 0))
    bad = _rank(8, 0)
    with pytest.raises(ValueError, match="tp-only mesh"):
        tl._use_flash_decode(cfg, torch.device("cpu"), bad)
    auto = dataclasses.replace(cfg, decode_attn="auto")
    assert tl._use_flash_decode(auto, cuda, _rank(2, 0))
    assert not tl._use_flash_decode(auto, cuda, bad)
    assert not tl._use_flash_decode(auto, torch.device("cpu"), _rank(2, 0))


def test_tp_wrappers_run_the_rank_heads():
    """Each rank's call is the kernel's on its head slice (here the plain
    versions), after the reference's divisibility check."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 8, 64, generator=g).bfloat16()
    k = torch.randn(2, 16, 4, 64, generator=g).bfloat16()
    v = torch.randn(2, 16, 4, 64, generator=g).bfloat16()
    kv_len = torch.tensor([5, 16], dtype=torch.int32)
    want = tfd.flash_decode(q, k, v, kv_len)
    for r in range(2):
        got = tfd.flash_decode_tp(q[:, :, 4 * r:4 * r + 4].contiguous(),
                                  k[:, :, 2 * r:2 * r + 2].contiguous(),
                                  v[:, :, 2 * r:2 * r + 2].contiguous(),
                                  kv_len, _rank(2, r), kv_heads=4)
        assert torch.equal(got, want[:, :, 4 * r:4 * r + 4])
    with pytest.raises(ValueError, match="do not divide"):
        tfd.flash_decode_tp(q, k, v, kv_len, _rank(3, 0), kv_heads=4)
    with pytest.raises(ValueError, match="rank's share"):
        tfd.flash_decode_tp(q, k, v, kv_len, _rank(2, 0), kv_heads=4)
    pool_k = k.reshape(4, 8, 4, 64)
    pool_v = v.reshape(4, 8, 4, 64)
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    want = tfd.flash_decode_paged(q, pool_k, pool_v, table, kv_len)
    got = tfd.flash_decode_paged_tp(
        q[:, :, 4:].contiguous(), pool_k[:, :, 2:].contiguous(),
        pool_v[:, :, 2:].contiguous(), table, kv_len, _rank(2, 1),
        kv_heads=4)
    assert torch.equal(got, want[:, :, 4:])
    qs = torch.randn(1, 9, 8, 64, generator=g).bfloat16()
    ks = torch.randn(1, 9, 4, 64, generator=g).bfloat16()
    vs = torch.randn(1, 9, 4, 64, generator=g).bfloat16()
    want = tfa.flash_attention(qs, ks, vs, causal=True)
    got = tfa.flash_attention_tp(qs[:, :, :4].contiguous(),
                                 ks[:, :, :2].contiguous(),
                                 vs[:, :, :2].contiguous(), _rank(2, 0),
                                 kv_heads=4)
    assert torch.equal(got, want[:, :, :4])
    with pytest.raises(ValueError, match="do not divide"):
        tfa.flash_attention_tp(qs, ks, vs, _rank(3, 0), kv_heads=4)


def _tp_engine(kind, **kw):
    cfg = tl.LlamaConfig.tiny(n_layers=1, max_seq=64, dtype=torch.float32)
    mesh = _rank(2, 0)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            mesh=mesh)
    cls = ts.PagedServer if kind == "paged" else ts.SlotServer
    return cls(cfg, params, slots=2, device="cpu", mesh=mesh, **kw)


@pytest.mark.parametrize("kw", [
    dict(tiers=object()), dict(directory=object()),
    dict(peer_fetch=lambda *a: None), dict(moe=object())])
def test_paged_engine_refuses_under_tp(kw):
    with pytest.raises(ValueError, match="item 7"):
        _tp_engine("paged", page_size=16, **kw)


@pytest.mark.parametrize("call", [
    lambda e: e.arm_draft(e.cfg, e.params),
    lambda e: e.prefill_span([1, 2, 3]),
    lambda e: e.adopt_pages({}),
    lambda e: e.export_stream(0),
    lambda e: e.import_stream({})],
    ids=["arm_draft", "prefill_span", "adopt_pages", "export_stream",
         "import_stream"])
def test_paged_entry_points_refuse_under_tp(call):
    eng = _tp_engine("paged", page_size=16)
    with pytest.raises(ValueError, match="item 7"):
        call(eng)
    stats = eng.page_stats()
    assert stats["tp"] == 2 and stats["graphs"] is False
    assert stats["graphs_off"] == "tp"


def test_engines_state_their_eager_windows_and_check_the_device():
    eng = _tp_engine("slots")
    g = eng.graph_stats()
    assert g["enabled"] is False and g["off_reason"] == "tp"
    assert eng.cache["k"].shape[3] == 2
    cfg = tl.LlamaConfig.tiny(n_layers=1)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="mesh rank drives"):
        ts.SlotServer(cfg, params, device="cpu",
                      mesh=_rank(2, 0, device="cuda"))
    # a mesh of one is no mesh
    one = ts.SlotServer(cfg, params, device="cpu", mesh=_rank(1, 0))
    assert one.mesh is None and one.graphs_off is None


def test_topology_key_holds_the_layout():
    cpu = torch.device("cpu")
    keys = {aot.topology_key(None, cpu),
            aot.topology_key(_rank(2, 0), cpu),
            aot.topology_key(_rank(2, 0, backend="nccl"), cpu),
            aot.topology_key(_rank(4, 0), cpu)}
    assert len(keys) == 4
    assert aot.topology_key(_rank(2, 1), cpu) == \
        "mesh[dp=1,pp=1,sp=1,tp=2,ep=1]:gloo:cpu:1"
