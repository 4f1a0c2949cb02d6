"""The port's sharded checkpoints (``dcos_commons_tpu_torch/parallel/
checkpoint.py``) against ``dcos_commons_tpu/parallel/checkpoint.py``: a
tree saved by either package restores in the other bitwise (bf16, fp32,
int8 ``QTensor`` leaves, 0-d leaves), ``manifest.json`` is byte-equal for
the same tree, truncated or bit-flipped shards raise
``CheckpointCorrupt``, keep-prune and dot-tmp litter behave as the
reference's, the ``reader``/``manifest`` byte source works, and
``export_tree`` is what ``save_sharded`` writes."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import train as jt
from dcos_commons_tpu.ops.quant import quantize as jquantize
from dcos_commons_tpu.parallel import checkpoint as jc
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import train as tt
from dcos_commons_tpu_torch.models.bridge import (opt_state_from_jax,
                                                  params_from_jax)
from dcos_commons_tpu_torch.ops.quant import QTensor
from dcos_commons_tpu_torch.parallel import checkpoint as tc


def _jax_tree():
    """Every leaf kind the serving path saves: bf16 and fp32 matrices,
    an int8 ``QTensor`` (payload + bf16 scales), an int32 vector and two
    0-d fp32 leaves, one of which sorts before the others."""
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((6, 8)), jnp.float32)
    return {"params": {
        "b": jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16),
        "wq": jquantize(w, axis=-2),
        "a": jnp.float32(2.5),
        "f": w,
        "n": jnp.arange(5, dtype=jnp.int32),
        "z": jnp.float32(-0.125)}}


def _port_tree():
    return params_from_jax(jax.device_get(_jax_tree()), device="cpu")


def _np_of(x):
    """Host bytes of a leaf of either package, as numpy."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _leaves_equal(jtree, ttree):
    jflat, _ = jax.tree_util.tree_flatten(jtree)
    tflat = [leaf for _, leaf in tc._flatten(ttree)]
    assert len(jflat) == len(tflat)
    for j, t in zip(jflat, tflat):
        a, b = _np_of(j), _np_of(t)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


def _manifest(step_dir):
    with open(os.path.join(step_dir, "manifest.json"), "rb") as f:
        return f.read()


def test_leaf_keys_and_order_are_jax_tree_util_s():
    paths, _ = jax.tree_util.tree_flatten_with_path(_jax_tree())
    assert [jc._leaf_key(p) for p, _ in paths] == [
        k for k, _ in tc._flatten(_port_tree())]
    keys = [k for k, _ in tc._flatten(_port_tree())]
    assert keys[:3] == ["params.a", "params.b", "params.f"]
    assert "params.wq.0" in keys and "params.wq.1" in keys


def test_manifest_is_byte_equal_for_the_same_tree(tmp_path):
    jdir = jc.save_sharded(str(tmp_path / "j"), 7, _jax_tree())
    tdir = tc.save_sharded(str(tmp_path / "t"), 7, _port_tree())
    assert _manifest(jdir) == _manifest(tdir)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in os.listdir(jdir):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    meta = json.loads(_manifest(tdir))
    leaf = meta["leaves"]["params.wq.0"]
    assert leaf["dtype"] == "int8" and leaf["shards"][0]["index"] == "o0_0"
    assert meta["leaves"]["params.a"]["shards"][0]["index"] == "o"
    assert meta["leaves"]["params.wq.1"]["dtype"] == "bfloat16"


def test_jax_saved_tree_restores_into_the_port_bitwise(tmp_path):
    jc.save_sharded(str(tmp_path), 3, _jax_tree())
    template = _port_tree()
    got = tc.restore_sharded(str(tmp_path), template)
    assert isinstance(got["params"]["wq"], QTensor)
    assert got["params"]["b"].dtype == torch.bfloat16
    assert list(got["params"]) == list(template["params"])
    _leaves_equal(_jax_tree(), got)


def test_port_saved_tree_restores_into_jax_bitwise(tmp_path):
    tc.save_sharded(str(tmp_path), 3, _port_tree())
    got = jc.restore_sharded(str(tmp_path), _jax_tree())
    _leaves_equal(got, _port_tree())


def test_llama_params_cross_both_ways(tmp_path):
    """The worker's restore: a JAX-initialised Llama tree (bf16, the
    reference's init) saved by JAX restores into a port template of
    uninitialised tensors bitwise, and back."""
    cfg = jl.LlamaConfig.tiny(n_layers=2, max_seq=64)
    jp = jl.init_params(cfg, jax.random.key(0))
    jc.save_sharded(str(tmp_path / "j"), 1, jp)
    tcfg = tl.LlamaConfig.tiny(n_layers=2, max_seq=64)
    template = tl.init_params(tcfg, torch.Generator().manual_seed(9),
                              device="cpu")
    got = tc.restore_sharded(str(tmp_path / "j"), template)
    _leaves_equal(jp, got)
    tc.save_sharded(str(tmp_path / "t"), 1, got)
    _leaves_equal(jc.restore_sharded(str(tmp_path / "t"), jp), got)


def test_a_checkpoint_saved_over_several_devices_assembles(tmp_path):
    """A leaf the reference saved in shards over a mesh of 8 CPU devices
    restores whole into the port's one-device template."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("a", "b"))
    x = jnp.arange(64 * 6, dtype=jnp.float32).reshape(64, 6)
    sharded = jax.device_put(x, NamedSharding(mesh, P("a", "b")))
    jc.save_sharded(str(tmp_path), 2, {"w": sharded})
    meta = json.loads(_manifest(str(tmp_path / "step-00000002-p0")))
    assert len(meta["leaves"]["w"]["shards"]) == 8
    got = tc.restore_sharded(str(tmp_path),
                             {"w": torch.empty((64, 6))})
    assert torch.equal(got["w"], torch.from_numpy(np.array(x)))


@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_damaged_shards_raise_checkpoint_corrupt(tmp_path, damage):
    step_dir = tc.save_sharded(str(tmp_path), 4, _port_tree())
    path = os.path.join(step_dir, "params.f.o0_0.bin")
    raw = bytearray(open(path, "rb").read())
    if damage == "truncate":
        raw = raw[:-4]
    else:
        raw[5] ^= 0x10
    with open(path, "wb") as f:
        f.write(raw)
    for restore in (tc.restore_sharded, jc.restore_sharded):
        template = _port_tree() if restore is tc.restore_sharded \
            else _jax_tree()
        with pytest.raises((tc.CheckpointCorrupt, jc.CheckpointCorrupt),
                           match="truncated" if damage == "truncate"
                           else "digest mismatch"):
            restore(str(tmp_path), template)


def test_keep_prune_and_tmp_litter_match_the_reference(tmp_path):
    for root, save in ((tmp_path / "t", tc.save_sharded),
                       (tmp_path / "j", jc.save_sharded)):
        os.makedirs(root / ".step-00000009-p0.tmp")
        os.makedirs(root / "step-00000011-p0")    # no manifest: not a step
        tree = _port_tree() if save is tc.save_sharded else _jax_tree()
        for step in (1, 2, 3, 4, 5):
            save(str(root), step, tree, keep=2)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    assert tc.latest_step(str(tmp_path / "t")) == 5
    assert tc._local_steps(str(tmp_path / "t"), 0) == [4, 5]
    assert tc.latest_step(str(tmp_path / "empty")) is None
    with pytest.raises(FileNotFoundError):
        tc.restore_sharded(str(tmp_path / "empty"), _port_tree())


def test_reader_and_manifest_byte_source(tmp_path):
    """Another byte source (a peer's, in the reference) through
    ``reader``: every shard still verifies against the manifest."""
    leaves, blobs = tc.export_tree(_port_tree())
    manifest = {"step": 5, "process": 0, "num_processes": 1,
                "leaves": leaves}
    seen = []

    def reader(fname):
        seen.append(fname)
        if fname == "manifest.json":
            return json.dumps(manifest).encode()
        return blobs[fname]

    for workers in (1, 4):
        got = tc.restore_sharded(None, _port_tree(), reader=reader,
                                 workers=workers)
        _leaves_equal(_jax_tree(), got)
    assert "manifest.json" in seen
    got = tc.restore_sharded(None, _port_tree(), reader=reader,
                             manifest=manifest)
    _leaves_equal(_jax_tree(), got)
    blobs["params.n.o0.bin"] = b"\0" * 20
    with pytest.raises(tc.CheckpointCorrupt, match="peer"):
        tc.restore_sharded(None, _port_tree(), reader=reader)


def test_export_tree_is_what_save_sharded_writes(tmp_path):
    leaves, blobs = tc.export_tree(_port_tree())
    step_dir = tc.save_sharded(str(tmp_path), 6, _port_tree())
    manifest = json.loads(_manifest(step_dir))
    assert manifest["leaves"] == leaves
    for name, raw in blobs.items():
        with open(os.path.join(step_dir, name), "rb") as f:
            assert f.read() == raw
    jleaves, jblobs = jc.export_tree(_jax_tree())
    assert jleaves == leaves and jblobs == blobs


def test_template_mismatch_and_gangs_are_refused(tmp_path, monkeypatch):
    tc.save_sharded(str(tmp_path), 1, {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="template"):
        tc.restore_sharded(str(tmp_path), {"w": torch.zeros(4, 3)})
    with pytest.raises(ValueError, match="template"):
        tc.restore_sharded(str(tmp_path),
                           {"w": torch.zeros(3, 4, dtype=torch.bfloat16)})
    with pytest.raises(KeyError, match="no leaf"):
        tc.restore_sharded(str(tmp_path), {"v": torch.zeros(3, 4)})
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "pod-0:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(NotImplementedError, match="item 7"):
        tc.save_sharded(str(tmp_path), 2, {"w": torch.zeros(3, 4)})
    with pytest.raises(NotImplementedError, match="item 7"):
        tc.latest_step(str(tmp_path))


def test_host_leaves_restore_as_numpy_values(tmp_path):
    """Non-tensor leaves take ``jnp.asarray``'s dtypes (a Python int is
    int32) and come back as numpy values, as in the reference."""
    tree = {"step": 12, "lr": 0.5, "w": torch.ones(2)}
    tdir = tc.save_sharded(str(tmp_path / "t"), 1, tree)
    jdir = jc.save_sharded(str(tmp_path / "j"), 1,
                           {"step": 12, "lr": 0.5, "w": jnp.ones(2)})
    assert _manifest(tdir) == _manifest(jdir)
    got = tc.restore_sharded(str(tmp_path / "t"), tree)
    assert got["step"] == 12 and got["step"].dtype == np.int32
    assert got["lr"] == np.float32(0.5)


# ---------------------------------------------------------------------------
# train checkpoints: params + the optimizer state


def _jax_train_tree():
    """A tiny bf16 Llama and the reference optimizer's state after one
    update (counts 1, moments non-zero)."""
    cfg = jl.LlamaConfig.tiny(n_layers=2, max_seq=64)
    params = jl.init_params(cfg, jax.random.key(0))
    opt = jt.make_optimizer(lr=1e-3, warmup=5, decay_steps=10)
    grads = jax.tree.map(lambda p: p * 0.5, params)
    _, state = opt.update(grads, opt.init(params), params)
    return {"params": params, "opt_state": state}


def _port_train_tree(jtree):
    host = jax.device_get(jtree)
    return {"params": params_from_jax(host["params"], device="cpu"),
            "opt_state": tt.opt_state_tree(
                opt_state_from_jax(host["opt_state"], device="cpu"))}


def test_train_checkpoint_keys_and_manifest_are_the_reference_s(tmp_path):
    jtree = _jax_train_tree()
    jdir = jc.save_sharded(str(tmp_path / "j"), 4, jtree)
    tdir = tc.save_sharded(str(tmp_path / "t"), 4, _port_train_tree(jtree))
    assert _manifest(jdir) == _manifest(tdir)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in os.listdir(jdir):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    leaves = json.loads(_manifest(tdir))["leaves"]
    opt_keys = [k for k in leaves if k.startswith("opt_state")]
    assert opt_keys[0] == "opt_state.1.0.count"
    assert opt_keys[-1] == "opt_state.1.2.count"
    for k in ("opt_state.1.0.count", "opt_state.1.2.count"):
        assert leaves[k]["dtype"] == "int32"
        assert leaves[k]["global_shape"] == []
    assert leaves["opt_state.1.0.mu.layers.wq"]["dtype"] == "bfloat16"
    assert "opt_state.1.0.nu.lm_head" in leaves
    assert len(opt_keys) == 2 + 2 * sum(k.startswith("params.")
                                        for k in leaves)


def test_jax_train_checkpoint_restores_into_the_port_bitwise(tmp_path):
    jtree = _jax_train_tree()
    jc.save_sharded(str(tmp_path), 4, jtree)
    cfg = tl.LlamaConfig.tiny(n_layers=2, max_seq=64)
    params = tl.param_template(cfg, "cpu")
    template = {"params": params, "opt_state": tt.opt_state_tree(
        tt.init_opt_state(tt.make_optimizer(), params))}
    got = tc.restore_sharded(str(tmp_path), template)
    state = tt.opt_state_from_tree(got["opt_state"])
    want = opt_state_from_jax(jax.device_get(jtree["opt_state"]),
                              device="cpu")
    assert (state.count, state.sched_count) == (want.count,
                                                want.sched_count) == (1, 1)
    assert got["opt_state"][1][0].count.dtype == torch.int32
    _leaves_equal(jtree, got)
    _leaves_equal({"mu": jtree["opt_state"][1][0].mu},
                  {"mu": state.mu})


def test_port_train_checkpoint_restores_into_the_reference_bitwise(
        tmp_path):
    jtree = _jax_train_tree()
    ttree = _port_train_tree(jtree)
    tc.save_sharded(str(tmp_path), 4, ttree)
    template = jax.tree.map(jnp.zeros_like, jtree)
    got = jc.restore_sharded(str(tmp_path), template)
    _leaves_equal(got, ttree)
    assert int(got["opt_state"][1][0].count) == 1
    assert int(got["opt_state"][1][2].count) == 1
