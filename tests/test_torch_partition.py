"""The port's copy of the partition and halo geometry
(``repro_torch/core/partition.py``) against the JAX package's, on every
case of tests/test_partition.py: the same answers, and the same paper
Appendix B structures."""

import dataclasses

import numpy as np
from hypothesis_compat import given, settings, strategies as st

from repro.core import partition as ref
from repro_torch.core import partition as port
from repro_torch.core.partition import (
    TensorPartition,
    balanced_split,
    compute_halos,
    conv_output_size,
    is_sensible_decomposition,
    max_halo_widths,
)


def _halos(*args, **kw):
    """The port's halo specs, checked field by field against the
    reference's."""
    mine = compute_halos(*args, **kw)
    theirs = ref.compute_halos(*args, **kw)
    assert ([dataclasses.astuple(s) for s in mine]
            == [dataclasses.astuple(s) for s in theirs])
    assert [s.local_in_size for s in mine] == [s.local_in_size
                                               for s in theirs]
    return mine


def test_balanced_split_matches_numpy_array_split():
    for n in [1, 5, 11, 20, 37, 128]:
        for p in [1, 2, 3, 5, 7]:
            if p > n:
                continue
            ours = balanced_split(n, p)
            assert ours == [len(a) for a in np.array_split(np.arange(n), p)]
            assert ours == ref.balanced_split(n, p)
            assert port.shard_offsets(n, p) == ref.shard_offsets(n, p)


def test_conv_output_size():
    for args, want in [((11, 5), {"padding": 2}), ((11, 5), {}),
                       ((11, 2), {"stride": 2}), ((20, 2), {"stride": 2}),
                       ((10, 3), {"dilation": 2})]:
        assert conv_output_size(*args, **want) == ref.conv_output_size(
            *args, **want)
    assert conv_output_size(11, 5, padding=2) == 11
    assert conv_output_size(11, 5) == 7
    assert conv_output_size(11, 2, stride=2) == 5
    assert conv_output_size(20, 2, stride=2) == 10
    assert conv_output_size(10, 3, dilation=2) == 6


class TestAppendixB:
    """The paper's Appendix B halo structures, as the reference pins them."""

    def test_B2_normal_convolution_uniform_halos(self):
        specs = _halos(11, 3, 5, padding=2)
        assert [s.left_halo for s in specs] == [0, 2, 2]
        assert [s.right_halo for s in specs] == [2, 2, 0]
        assert all(s.left_unused == 0 and s.right_unused == 0 for s in specs)

    def test_B3_unbalanced_convolution(self):
        specs = _halos(11, 3, 5)
        assert (specs[0].left_halo, specs[0].right_halo) == (0, 3)
        assert (specs[1].left_halo, specs[1].right_halo) == (1, 1)
        assert (specs[2].left_halo, specs[2].right_halo) == (3, 0)

    def test_B4_simple_unbalanced_pooling(self):
        specs = _halos(11, 3, 2, stride=2)
        for i in range(3):
            assert (specs[i].left_halo, specs[i].right_halo) == (0, 0)
        assert (specs[0].left_unused, specs[0].right_unused) == (0, 0)
        assert specs[2].right_unused == 1

    def test_B5_complex_unbalanced_pooling(self):
        specs = _halos(20, 6, 2, stride=2)
        for i in (0, 1):
            assert (specs[i].left_halo, specs[i].right_halo) == (0, 0)
            assert (specs[i].left_unused, specs[i].right_unused) == (0, 0)
        assert (specs[2].left_halo, specs[2].right_halo) == (0, 1)
        assert specs[3].left_unused == 1
        assert (specs[3].left_halo, specs[3].right_halo) == (0, 2)
        assert specs[4].left_unused == 2
        assert (specs[4].left_halo, specs[4].right_halo) == (0, 1)
        assert (specs[5].left_halo, specs[5].right_halo) == (0, 0)
        assert specs[5].left_unused == 1

    def test_causal_conv1d_one_sided_halo(self):
        specs = _halos(4096, 16, 4, padding=3)
        assert all(s.left_halo <= 3 for s in specs)


@settings(max_examples=50, deadline=None)
@given(
    n=st.integers(8, 256),
    p=st.integers(1, 8),
    k=st.integers(1, 7),
    stride=st.integers(1, 3),
    dilation=st.integers(1, 2),
    pad=st.integers(0, 3),
)
def test_halo_coverage_property(n, p, k, stride, dilation, pad):
    """Property: the port's geometry equals the reference's, every worker's
    bulk + halos minus unused trims covers exactly the input range its
    outputs need, and the output ranges tile the full output."""
    m = conv_output_size(n, k, stride, dilation, pad)
    if m < p or n < p:
        return
    specs = _halos(n, p, k, stride, dilation, pad)
    assert specs[0].out[0] == 0 and specs[-1].out[1] == m
    for a, b in zip(specs, specs[1:]):
        assert a.out[1] == b.out[0]
    for s in specs:
        lo = s.bulk[0] - s.left_halo + s.left_unused
        hi = s.bulk[1] + s.right_halo - s.right_unused
        assert (lo, hi) == s.needed
    sensible = is_sensible_decomposition(specs)
    assert sensible == ref.is_sensible_decomposition(
        ref.compute_halos(n, p, k, stride, dilation, pad))
    if sensible:
        for s in specs:
            if s.index > 0:
                prev = specs[s.index - 1]
                assert s.left_halo <= prev.bulk[1] - prev.bulk[0]
            if s.index < p - 1:
                nxt = specs[s.index + 1]
                assert s.right_halo <= nxt.bulk[1] - nxt.bulk[0]


def test_tensor_partition_ranges():
    for shape, pv in [((8, 11), (2, 3)), ((8, 12), (2, 3)), ((7,), (3,))]:
        mine, theirs = TensorPartition(shape, pv), ref.TensorPartition(shape,
                                                                       pv)
        assert mine.num_workers == theirs.num_workers
        assert mine.is_uniform() == theirs.is_uniform()
        for r in range(mine.num_workers):
            assert mine.coords(r) == theirs.coords(r)
            assert mine.rank(mine.coords(r)) == r
            assert mine.subtensor_range(r) == theirs.subtensor_range(r)
            assert mine.local_shape(r) == theirs.local_shape(r)
    tp = TensorPartition((8, 11), (2, 3))
    assert tp.num_workers == 6
    assert tp.coords(4) == (1, 1)
    assert tp.rank((1, 1)) == 4
    assert tp.subtensor_range(0) == [(0, 4), (0, 4)]
    assert tp.subtensor_range(5) == [(4, 8), (8, 11)]
    assert tp.local_shape(0) == (4, 4)
    assert not tp.is_uniform()
    assert TensorPartition((8, 12), (2, 3)).is_uniform()


def test_max_halo_widths():
    specs = _halos(11, 3, 5)
    assert max_halo_widths(specs) == (3, 3)
    assert max_halo_widths(specs) == ref.max_halo_widths(
        ref.compute_halos(11, 3, 5))
