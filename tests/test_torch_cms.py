"""Count-min sketch states of the port against the JAX package.

``metrics_tpu_torch/parallel/cms.py`` keeps its own copy of the key hash of
record and the bucket family: the FNV-1a hashes must equal the pinned corpus
of ``tests/parallel/test_cms.py`` (fleet routing depends on it) and the JAX
package's functions, bit for bit; ``cms_buckets`` must equal the JAX package's.
The scatter drops the hot-tier sentinel bucket and wraps a negative one as the
JAX package's ``mode="drop"`` scatter does, and a count-min state declared
through ``add_state`` merges, checkpoints (a JAX checkpoint loads) and resets.

Tolerances: every hash, bucket and count is an integer and must be equal; the
error bound is one float32 product, equal to the JAX package's to rtol 1e-6.
"""
import copy
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.parallel.cms as jcms
from metrics_tpu.core.metric import Metric as JaxMetric
from metrics_tpu_torch.core.metric import Metric, _fingerprint_value
from metrics_tpu_torch.parallel import sync as psync
from metrics_tpu_torch.parallel.cms import (
    CMSSpec,
    CMSTail,
    CountMinSketch,
    cms_buckets,
    cms_error_bound,
    cms_init,
    cms_merge,
    cms_nbytes,
    cms_row_state,
    cms_scatter,
    cms_total,
    is_cms,
    make_cms_spec,
    stable_key_hash,
    stable_key_hash_array,
    stable_key_hashes,
)
from metrics_tpu_torch.parallel.sketch import is_sketch

torch.set_num_threads(1)

_CORPORA = (
    np.array(["", "a", "1", "tenant/0", "пример-ключа", "雪字キー", "a\x00b", "x" * 40]),
    np.array([b"", b"a", b"tenant-0", b"a\x00b", b"\xff\xfe\x01"], dtype="S"),
    np.array([0, 1, -1, 7, 12345, -(2**62), 2**63 - 1], dtype=np.int64),
    np.array([0, 1, 2**63, 2**64 - 1], dtype=np.uint64),
    np.array([-128, -1, 0, 127], dtype=np.int8),
    np.array(["a", b"a", 1, "1"], dtype=object),
)


def test_stable_key_hash_equals_the_pinned_corpus():
    assert stable_key_hash("tenant-0") == 0x1CE48A04A2FF1955
    assert stable_key_hash("tenant-1") == 0x1CE48904A2FF17A2
    assert stable_key_hash(b"tenant-0") == 0x3D82925F040C1B10
    assert stable_key_hash(0) == 0x2B0A3B192B55573E
    assert stable_key_hash(12345) == 0xDBD8F4A96E701FD1
    assert stable_key_hash(1) != stable_key_hash("1")
    assert stable_key_hash(7) == stable_key_hash(np.int64(7))
    for bad in (1.5, ("a", 1), True):
        with pytest.raises(TypeError, match="str, bytes or int"):
            stable_key_hash(bad)
    np.testing.assert_array_equal(stable_key_hash_array(np.array(["tenant-1"])),
                                  np.array([0x1CE48904A2FF17A2], dtype=np.uint64))
    np.testing.assert_array_equal(stable_key_hash_array(np.array([b"tenant-0"], dtype="S")),
                                  np.array([0x3D82925F040C1B10], dtype=np.uint64))
    np.testing.assert_array_equal(stable_key_hash_array(np.array([0, 12345], dtype=np.int64)),
                                  np.array([0x2B0A3B192B55573E, 0xDBD8F4A96E701FD1], dtype=np.uint64))


@pytest.mark.parametrize("corpus", range(len(_CORPORA)))
def test_hash_array_bit_equals_the_scalar_hash_and_jax(corpus):
    arr = _CORPORA[corpus]
    got = stable_key_hash_array(arr)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, np.array([stable_key_hash(k) for k in arr], dtype=np.uint64))
    np.testing.assert_array_equal(got, stable_key_hashes(arr))
    np.testing.assert_array_equal(got, jcms.stable_key_hash_array(arr))
    np.testing.assert_array_equal(got, jcms.stable_key_hashes(arr))


def test_hash_array_shapes_and_rejections():
    np.testing.assert_array_equal(stable_key_hash_array(["u", "v"]), stable_key_hashes(["u", "v"]))
    grid = np.arange(6, dtype=np.int32).reshape(2, 3)
    np.testing.assert_array_equal(stable_key_hash_array(grid), stable_key_hashes(grid.reshape(-1)))
    assert stable_key_hash_array(np.array([], dtype=np.int64)).shape == (0,)
    for bad in (np.array([1.5, 2.5]), np.array([True, False])):
        with pytest.raises(TypeError, match="str, bytes or int"):
            stable_key_hash_array(bad)


@pytest.mark.parametrize("depth,width,seed", [(4, 4096, 29), (2, 16, 1), (5, 1000, 7)])
def test_cms_buckets_equal_jax(depth, width, seed):
    keys = np.random.default_rng(seed).zipf(1.1, 5_000) % 1_000_000
    hashes = stable_key_hash_array(keys)
    got = cms_buckets(hashes, depth, width, seed)
    assert got.dtype == np.int32 and got.shape == (5_000, depth)
    np.testing.assert_array_equal(got, jcms.cms_buckets(hashes, depth, width, seed))
    assert got.min() >= 0 and got.max() < width


def test_scatter_equals_jax_and_drops_the_sentinel():
    rng = np.random.default_rng(3)
    depth, width = 3, 16
    buckets = rng.integers(-width - 2, width + 3, (200, depth)).astype(np.int32)  # sentinels and negatives
    deltas = rng.integers(0, 5, 200).astype(np.int32)
    want = np.asarray(jcms.cms_scatter(jnp.zeros((depth, width), jnp.int32), jnp.asarray(buckets),
                                       jnp.asarray(deltas)))
    got = cms_scatter(torch.zeros(depth, width, dtype=torch.int64), torch.from_numpy(buckets),
                      torch.from_numpy(deltas))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    sentinel = cms_scatter(torch.zeros(2, 8, dtype=torch.int64), torch.tensor([[8, 8], [1, 2]]),
                           torch.ones(2, dtype=torch.int64))
    assert int(sentinel.sum()) == 2 and int(sentinel[0, 1]) == 1 and int(sentinel[1, 2]) == 1


def test_item_cells_merge_bit_exact_and_equal_jax():
    spec = CMSSpec(3, 16, (2,), torch.int64, seed=5)
    buckets = cms_buckets(stable_key_hashes(["x", "y"]), 3, 16, 5)
    da, db = np.array([[1, 2], [3, 4]], np.int32), np.array([[5, 6], [7, 8]], np.int32)
    a = CountMinSketch(cms_scatter(cms_init(spec).counts, torch.from_numpy(buckets), torch.from_numpy(da)))
    b = CountMinSketch(cms_scatter(cms_init(spec).counts, torch.from_numpy(buckets), torch.from_numpy(db)))
    merged = cms_merge(a, b)
    ref = jcms.cms_scatter(jcms.cms_scatter(jnp.zeros((3, 16, 2), jnp.int32), jnp.asarray(buckets),
                                            jnp.asarray(da)), jnp.asarray(buckets), jnp.asarray(db))
    np.testing.assert_array_equal(merged.counts.numpy(), np.asarray(ref))
    assert cms_nbytes(merged) == 3 * 16 * 2 * 8
    assert is_cms(merged) and is_sketch(merged)


def test_query_is_exact_without_collisions_and_never_undercounts():
    spec = CMSSpec(4, 64, (), torch.int64, seed=3)
    counts = cms_init(spec).counts
    true = {"a": 5, "b": 2, "c": 9}
    per_key = torch.from_numpy(cms_buckets(stable_key_hashes(list(true)), 4, 64, 3))
    for i, n in enumerate(true.values()):
        counts = cms_scatter(counts, per_key[i].expand(n, 4), torch.ones(n, dtype=torch.int64))
    assert int(cms_total(counts)) == 16
    for i, n in enumerate(true.values()):
        assert int(cms_row_state(counts, per_key[i]).min()) == n
    np.testing.assert_allclose(float(cms_error_bound(counts)), float(jcms.cms_error_bound(jnp.asarray(counts.numpy()))),
                               rtol=1e-6)
    assert cms_error_bound(counts).dtype == torch.float32
    # a tiny grid: collisions only ever add
    small = cms_init(CMSSpec(2, 4, (), torch.int64, seed=0)).counts
    keys = [f"k{i}" for i in range(40)]
    b = torch.from_numpy(cms_buckets(stable_key_hashes(keys), 2, 4, 0))
    small = cms_scatter(small, b, torch.ones(40, dtype=torch.int64))
    assert all(int(cms_row_state(small, b[i]).min()) >= 1 for i in range(40))


def test_make_cms_spec_forms_and_validation():
    assert make_cms_spec(CMSTail(2, 32, 1), (), torch.int64).shape == (2, 32)
    assert make_cms_spec((3, 64), (5,), torch.int64).shape == (3, 64, 5)
    assert make_cms_spec(128, (), torch.int64).width == 128
    assert CMSTail() == (4, 4096, 29)
    with pytest.raises(ValueError):
        make_cms_spec((0, 64), (), torch.int64)
    with pytest.raises(ValueError):
        make_cms_spec("wide", (), torch.int64)
    with pytest.raises(ValueError):
        CMSTail(width=1).validate()


class _CMSMetric(Metric):
    def __init__(self, seed=1, **kw):
        super().__init__(device="cpu", **kw)
        self.add_state("tail", default=CMSSpec(2, 16, (), torch.int64, seed=seed), dist_reduce_fx="sum",
                       persistent=True)

    def update(self, buckets, values):
        self.tail = CountMinSketch(cms_scatter(self.tail.counts, buckets, values))

    def compute(self):
        return cms_total(self.tail.counts)


class _JaxCMSMetric(JaxMetric):
    def __init__(self):
        super().__init__()
        self.add_state("tail", default=jcms.CMSSpec(2, 16, (), np.int32, seed=1), dist_reduce_fx="sum",
                       persistent=True)

    def update(self, buckets, values):
        self.tail = jcms.CountMinSketch(jcms.cms_scatter(self.tail.counts, buckets, values))

    def compute(self):
        return jcms.cms_total(self.tail.counts)


def test_add_state_materializes_and_requires_sum():
    metric = _CMSMetric()
    assert is_cms(metric.tail) and tuple(metric.tail.counts.shape) == (2, 16)
    assert metric.tail.counts.dtype == torch.int64
    assert psync.is_mergeable("sum", metric.tail)

    class Bad(Metric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("t", default=CMSSpec(2, 16, (), torch.int64, seed=1), dist_reduce_fx="max")

        def update(self):
            pass

        def compute(self):
            return 0

    with pytest.raises(ValueError, match="sum-mergeable by construction; declare them with dist_reduce_fx='sum'"):
        Bad()


def test_jax_checkpoint_loads_and_forward_reset_copies():
    keys = np.array([3, 3, 9, 12, 3, 40])
    buckets = cms_buckets(stable_key_hash_array(keys), 2, 16, 1)
    ref = _JaxCMSMetric()
    ref.update(jnp.asarray(buckets), jnp.ones((6,), jnp.int32))
    port = _CMSMetric()
    port.load_state_dict(ref.state_dict())
    assert is_cms(port.tail) and port.tail.counts.dtype == torch.int64
    np.testing.assert_array_equal(port.tail.counts.numpy(), np.asarray(ref.tail.counts))
    assert int(port.compute()) == int(ref.compute()) == 6
    # the forward merges the batch delta by addition; copies keep the counts
    value = port(torch.from_numpy(buckets[:2]), torch.ones(2, dtype=torch.int64))
    assert int(value) == 2 and int(port.compute()) == 8
    for other in (copy.deepcopy(port), pickle.loads(pickle.dumps(port))):
        assert torch.equal(other.tail.counts, port.tail.counts)
    state = port.state_dict()
    assert set(state["tail"]) == {"sketch_counts"}
    back = _JaxCMSMetric()
    back.load_state_dict(state)
    np.testing.assert_array_equal(np.asarray(back.tail.counts), port.tail.counts.numpy())
    port.reset()
    assert int(port.tail.counts.sum()) == 0 and is_cms(port.tail)


def test_fingerprint_includes_seed():
    a = _fingerprint_value(CMSSpec(2, 16, (), torch.int64, seed=1))
    b = _fingerprint_value(CMSSpec(2, 16, (), torch.int64, seed=2))
    assert a != b and a[0] == "cmsspec"
