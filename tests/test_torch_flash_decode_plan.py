"""The work sizing of the two flash-decode kernels (``decode_plan``,
``stream_split`` and ``decode_items`` in ``dcos_commons_tpu_torch/ops/
flash_decode.py``), which the kernels' device-side walk
(``csrc/flash_decode_common.cuh``) follows: every live position of a
(stream, KV head) falls in exactly one item, no item reaches past
min(kv_len, span), no (stream, KV head) has more partials than the plan
gives it room for, and the grid and the workspace cover the items. Pure
integer arithmetic: no card, no JAX."""

import re

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dcos_commons_tpu_torch.kernels import build
from dcos_commons_tpu_torch.ops import flash_decode as fd


def _check(lens, span, kv_heads, group=4, head_dim=128, n_sm=132):
    items = fd.decode_items(lens, span, kv_heads)
    plan = fd.decode_plan(len(lens), kv_heads, group, head_dim, span, n_sm)
    assert 1 <= plan.grid <= max(1, fd.BLOCKS_PER_SM * n_sm)
    assert plan.counters == len(lens) * kv_heads
    # partial slots: acc [pairs, max_partials, group, D], then m and l
    assert plan.workspace_floats == (plan.counters * plan.max_partials
                                     * group * (head_dim + 2))
    seen = {}
    for b, kh, j, chunks, p0, p1 in items:
        live = max(0, min(lens[b], span))
        assert 0 <= p0 <= p1 <= live
        assert (p1 > p0) == (chunks > 0)
        assert j < max(chunks, 1) and chunks <= plan.max_partials
        seen.setdefault((b, kh), []).append((j, p0, p1))
    assert sorted(seen) == [(b, kh) for b in range(len(lens))
                            for kh in range(kv_heads)]
    for (b, _), runs in seen.items():
        live = max(0, min(lens[b], span))
        length, chunks = fd.stream_split(live)
        assert length % fd.STAGE_ROWS == 0
        assert [j for j, _, _ in runs] == list(range(max(chunks, 1)))
        covered = [pos for _, p0, p1 in runs for pos in range(p0, p1)]
        assert covered == list(range(live))        # each once, in order
        assert all(p1 - p0 <= length for _, p0, p1 in runs)
    # the persistent grid deals item i to block i % grid: all taken once
    dealt = sorted(i for blk in range(plan.grid)
                   for i in range(blk, len(items), plan.grid))
    assert dealt == list(range(len(items)))
    return items, plan


@settings(max_examples=150, deadline=None)
@given(st.data())
def test_slot_cache_items_cover_each_live_position_once(data):
    span = data.draw(st.integers(1, 8192), label="S")
    b = data.draw(st.integers(1, 64), label="B")
    lens = data.draw(st.lists(
        st.one_of(st.integers(-3, span + 100), st.sampled_from([0, 1, span])),
        min_size=b, max_size=b), label="kv_len")
    kv_heads = data.draw(st.integers(1, 8), label="KV")
    _check(lens, span, kv_heads)


@settings(max_examples=150, deadline=None)
@given(st.data())
def test_paged_items_cover_each_live_position_once(data):
    ps = data.draw(st.integers(1, 256), label="ps")
    mp = data.draw(st.integers(1, max(1, 8192 // ps)), label="MP")
    span = ps * mp
    b = data.draw(st.integers(1, 64), label="B")
    lens = data.draw(st.lists(st.integers(-3, span + 3 * ps), min_size=b,
                              max_size=b), label="kv_len")
    group = data.draw(st.sampled_from([1, 2, 4, 8]), label="group")
    d = data.draw(st.sampled_from([64, 128, 256]), label="D")
    _check(lens, span, data.draw(st.integers(1, 8), label="KV"), group, d,
           n_sm=data.draw(st.integers(1, 132), label="SMs"))


def test_the_main_path_shapes():
    """chip_smoke's lengths at S=2048: 64-position chunks up to 512 live
    positions, longer ones for longer streams (8 partials at most: 128
    positions at 700, 192 at 1,500, 256 at 2,047), so 33 items a KV head
    against 78 stages."""
    lens = (1, 63, 64, 65, 700, 2047, 1500, 333)
    items, plan = _check(lens, 2048, 8, group=4, head_dim=128)
    per_stream = [sum(1 for it in items if it[0] == b and it[1] == 0)
                  for b in range(8)]
    assert per_stream == [1, 1, 1, 2, 6, 8, 8, 6]
    assert len(items) == 264
    assert fd.stream_split(2047) == (256, 8)
    assert fd.stream_split(512) == (64, 8)
    assert fd.stream_split(513) == (128, 5)
    assert plan.grid == 132 and plan.max_partials == 8
    # a short cache needs fewer partial slots
    assert fd.decode_plan(8, 8, 4, 128, 100, 132).max_partials == 2


def test_empty_streams_get_one_item_a_head_that_reads_nothing():
    items = fd.decode_items([0, -5, 3], 16, 2)
    assert items == [(0, 0, 0, 0, 0, 0), (0, 1, 0, 0, 0, 0),
                     (1, 0, 0, 0, 0, 0), (1, 1, 0, 0, 0, 0),
                     (2, 0, 0, 1, 0, 3), (2, 1, 0, 1, 0, 3)]


def test_kernel_constants_follow_the_plan():
    """The header's stage length and partial cap are the plan's, and the
    header names the plan as the formula its walk follows."""
    text = (build.CSRC / "flash_decode_common.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const("kStageRows") == fd.STAGE_ROWS
    assert const("kMaxPartials") == fd.MAX_PARTIALS
    assert "decode_plan" in text and "decode_items" in text


@pytest.mark.parametrize("kv_len,want", [
    (700, (None, 0, 700)),
    (2 ** 40, (None, 0, 2 ** 31 - 1)),
    (torch.tensor([9], dtype=torch.int32), ("ptr", 0, 0)),
    (torch.tensor([1, 2, 3], dtype=torch.int32), ("ptr", 1, 0)),
])
def test_lengths_go_in_without_a_copy(kv_len, want):
    """An int goes to the kernel by value, a [1] or [B] tensor by pointer
    with stride 0 or 1: no broadcast kernel before the launch."""
    keep, ptr, stride, value = fd._length_args(kv_len, 3)
    assert (None if ptr is None else "ptr", stride, value) == want
    if isinstance(kv_len, torch.Tensor):
        assert ptr == kv_len.data_ptr() and keep is not None
