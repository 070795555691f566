"""Count-Min sketch states: the constant-memory tail of an open-world key space.

Counterpart of ``metrics_tpu/parallel/cms.py``. A :class:`CountMinSketch` is
one ``(depth, width, *item_shape)`` tensor; every key folds into ``depth``
cells through seeded multiply-shift row buckets over its 64-bit FNV-1a hash,
and a query reads the min over its rows: an overcount bounded by
``(e / width) * N`` with probability ``1 - e^-depth``.

* ``merge`` is elementwise addition (associative, commutative, bit-exact), so
  the sync rides the int64 sum bucket of ``parallel/sync.py``: one
  ``all_reduce`` per state dtype of a group, no new collective kind.
* The key hash of record (:func:`stable_key_hash` and its vectorized forms)
  and the bucket family (:func:`cms_buckets`) are host numpy, copied from the
  JAX package: fleet routing and every shard's cells depend on them, so they
  must stay bit-equal to it.
* :func:`cms_scatter` folds per-sample deltas with one ``index_add_`` into a
  flat view. The JAX package scatters with ``mode="drop"``: a bucket equal to
  ``width`` (the hot-tier sentinel) is dropped and a negative one wraps once.
  ``index_add_`` raises on an out-of-range index instead, so such rows add a
  zero increment at a valid cell.
"""
import math
from typing import Any, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

__all__ = [
    "CMSSpec",
    "CMSTail",
    "CountMinSketch",
    "cms_buckets",
    "cms_error_bound",
    "cms_init",
    "cms_merge",
    "cms_nbytes",
    "cms_row_state",
    "cms_scatter",
    "cms_total",
    "is_cms",
    "is_cms_spec",
    "make_cms_spec",
    "stable_key_hash",
    "stable_key_hash_array",
    "stable_key_hashes",
]

# 64-bit FNV-1a: the key hash of record, shared by the fleet router and the
# CMS bucket family below
_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3
_FNV64_MASK = 0xFFFFFFFFFFFFFFFF


def stable_key_hash(key: Any) -> int:
    """The stable 64-bit key hash of record: FNV-1a over the key's canonical
    bytes (``b"s:" + utf-8`` for str, ``b"b:" + bytes`` for bytes, ``b"i:" +
    decimal`` for ints, numpy integers included). Any other key type raises:
    routing and CMS cells must survive restarts and library versions."""
    if isinstance(key, bytes):
        data = b"b:" + key
    elif isinstance(key, str):
        data = b"s:" + key.encode("utf-8")
    elif isinstance(key, (int, np.integer)) and not isinstance(key, bool):
        data = b"i:" + str(int(key)).encode("ascii")
    else:
        raise TypeError(
            f"keys must be str, bytes or int (stable canonical bytes);"
            f" got {type(key).__name__}"
        )
    h = _FNV64_OFFSET
    for byte in data:
        h = ((h ^ byte) * _FNV64_PRIME) & _FNV64_MASK
    return h


def stable_key_hashes(keys) -> np.ndarray:
    """Vectorized :func:`stable_key_hash`: one ``uint64`` per key."""
    return np.array([stable_key_hash(k) for k in keys], dtype=np.uint64)


def stable_key_hash_array(keys: Any) -> np.ndarray:
    """:func:`stable_key_hash` over a whole numpy key array in one vectorized
    pass, bit-equal to the scalar hash of every element.

    The canonical type tag is prepended with ``np.char`` ops, the tagged
    fixed-width ``'S'`` array is viewed as an ``(N, itemsize)`` byte matrix,
    and FNV-1a folds one byte position at a time across all keys with
    ``uint64`` arithmetic wrapping mod 2**64. Rows shorter than the widest key
    stop at their own length. Integer, bytes and str dtypes vectorize; object
    arrays fall back to the scalar loop; bool and float keys raise.
    """
    arr = np.asarray(keys)
    if arr.ndim != 1:
        arr = arr.reshape(-1)
    if arr.size == 0:
        return np.empty((0,), dtype=np.uint64)
    kind = arr.dtype.kind
    if kind == "O":
        return stable_key_hashes(arr)
    if kind in "iu":
        tagged = np.char.add(b"i:", arr.astype("S"))
    elif kind == "S":
        tagged = np.char.add(b"b:", arr)
    elif kind == "U":
        tagged = np.char.add(b"s:", np.char.encode(arr, "utf-8"))
    else:
        raise TypeError(
            f"keys must be str, bytes or int (stable canonical bytes);"
            f" got array dtype {arr.dtype}"
        )
    tagged = np.ascontiguousarray(tagged)
    width = tagged.dtype.itemsize
    flat = tagged.view(np.uint8).reshape(tagged.size, width)
    nonzero = flat != 0
    # per-row byte length: the 2-byte type tag is never zero
    lengths = width - np.argmax(nonzero[:, ::-1], axis=1)
    h = np.full(tagged.size, _FNV64_OFFSET, dtype=np.uint64)
    prime = np.uint64(_FNV64_PRIME)
    for pos in range(width):
        live = pos < lengths
        if not live.any():
            break
        h = np.where(live, (h ^ flat[:, pos].astype(np.uint64)) * prime, h)
    return h


class CountMinSketch(NamedTuple):
    """Count-Min sketch state: one ``(depth, width, *item_shape)`` tensor.
    ``counts[d, w]`` accumulates the deltas of every key whose row-``d`` bucket
    is ``w``; merge is elementwise add, sync the sum bucket."""

    counts: Tensor


def is_cms(value: Any) -> bool:
    return isinstance(value, CountMinSketch)


class CMSSpec(NamedTuple):
    """CMS state declaration (what ``Metric.add_state`` records): the
    ``(depth, width)`` hash-row grid, the per-cell ``item_shape`` / ``dtype``,
    and the bucket-family ``seed`` (two states merge soundly only on equal
    seeds, so it is part of the compute-group key)."""

    depth: int
    width: int
    item_shape: Tuple[int, ...]
    dtype: Any
    seed: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.depth, self.width, *self.item_shape)


def is_cms_spec(value: Any) -> bool:
    return isinstance(value, CMSSpec)


class CMSTail(NamedTuple):
    """Tail configuration: the ``(depth, width)`` grid plus the bucket-family
    seed. The defaults (4 rows x 4,096 buckets) certify overcounts at
    ``e / 4096 ~ 0.07%`` of the tail mass with probability ``1 - e^-4 ~ 0.98``
    per query."""

    depth: int = 4
    width: int = 4096
    seed: int = 29

    def validate(self) -> "CMSTail":
        if not (isinstance(self.depth, int) and self.depth >= 1):
            raise ValueError(f"CMS depth must be a positive int, got {self.depth!r}")
        if not (isinstance(self.width, int) and self.width >= 2):
            raise ValueError(f"CMS width must be an int >= 2, got {self.width!r}")
        if not isinstance(self.seed, int):
            raise ValueError(f"CMS seed must be an int, got {self.seed!r}")
        return self


def make_cms_spec(tail: Union[CMSTail, Tuple[int, int], int], item_shape: Tuple[int, ...], dtype: Any) -> CMSSpec:
    """Normalize a ``tail=`` argument (a :class:`CMSTail`, a ``(depth, width)``
    pair, or a bare width) into one :class:`CMSSpec`."""
    if isinstance(tail, CMSTail):
        cfg = tail
    elif isinstance(tail, int):
        cfg = CMSTail(width=tail)
    elif isinstance(tail, tuple) and len(tail) == 2:
        cfg = CMSTail(depth=tail[0], width=tail[1])
    else:
        raise ValueError(
            f"`tail` must be a CMSTail, a (depth, width) pair, or a width int;"
            f" got {tail!r}"
        )
    cfg.validate()
    return CMSSpec(cfg.depth, cfg.width, tuple(item_shape), dtype, cfg.seed)


def cms_init(spec: CMSSpec, device: Optional[Union[str, torch.device]] = None) -> CountMinSketch:
    """Fresh zero-count CMS for ``spec`` on ``device``."""
    return CountMinSketch(torch.zeros(spec.shape, dtype=spec.dtype, device=device))


def cms_merge(a: CountMinSketch, b: CountMinSketch) -> CountMinSketch:
    """Pairwise merge: elementwise addition, bit-exact."""
    return CountMinSketch(a.counts + b.counts)


def cms_nbytes(value: CountMinSketch) -> int:
    """State bytes of one CMS (constant in the live-key count)."""
    return value.counts.numel() * value.counts.element_size()


def _bucket_params(depth: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The seeded multiply-shift family's per-row ``(a, b)``: ``depth`` odd
    64-bit multipliers and additive offsets, deterministic in ``seed``."""
    rng = np.random.RandomState(seed)
    halves = rng.randint(0, 2**32, size=(2, depth, 2)).astype(np.uint64)
    a = (halves[0, :, 0] << np.uint64(32)) | halves[0, :, 1] | np.uint64(1)  # odd
    b = (halves[1, :, 0] << np.uint64(32)) | halves[1, :, 1]
    return a, b


def cms_buckets(hashes: np.ndarray, depth: int, width: int, seed: int) -> np.ndarray:
    """``(N, depth)`` int32 row buckets for ``(N,)`` uint64 key hashes: per row
    ``d``, ``((a_d * h + b_d) mod 2^64) >> 32 mod width``. Host numpy (keys are
    resolved on the host); uint64 arithmetic wraps mod 2^64, which is the
    family's definition."""
    a, b = _bucket_params(depth, seed)
    h = np.asarray(hashes, dtype=np.uint64).reshape(-1, 1)  # (N, 1)
    mixed = (a[None, :] * h + b[None, :]) >> np.uint64(32)
    return (mixed % np.uint64(width)).astype(np.int32)


def cms_scatter(counts: Tensor, buckets: Tensor, deltas: Tensor) -> Tensor:
    """Fold ``(N, *item)`` per-sample deltas into ``(depth, width, *item)``
    counts at each sample's ``(N, depth)`` row buckets: every sample lands in
    all ``depth`` rows. Out-of-range buckets (the hot-tier sentinel ``width``)
    are dropped, as the JAX package's ``mode="drop"`` scatter drops them; a
    negative bucket wraps once, as there. One ``index_add`` into a flat view
    (a new tensor), no host read."""
    depth, width = counts.shape[0], counts.shape[1]
    item = tuple(counts.shape[2:])
    b = buckets.to(device=counts.device, dtype=torch.int64)
    b = torch.where(b < 0, b + width, b)
    keep = (b >= 0) & (b < width)
    rows = torch.arange(depth, device=counts.device, dtype=torch.int64)
    flat = torch.where(keep, rows * width + b, 0).reshape(-1)
    vals = deltas.to(counts.dtype).unsqueeze(1).expand(deltas.shape[0], depth, *item)
    vals = vals * keep.view(*keep.shape, *(1,) * len(item)).to(counts.dtype)
    return counts.reshape(depth * width, *item).index_add(0, flat, vals.reshape(-1, *item)).view(counts.shape)


def cms_total(row_counts: Tensor) -> Tensor:
    """Total mass inserted into a counter CMS (``item_shape = ()``): every
    sample increments every row once, so one row's sum is the total."""
    return torch.sum(row_counts[0])


def cms_row_state(counts: Tensor, buckets_one: Tensor) -> Tensor:
    """One key's ``(depth, *item)`` per-row cells (``buckets_one`` is its
    ``(depth,)`` bucket vector); the min over rows is the caller's query."""
    rows = torch.arange(counts.shape[0], device=counts.device)
    return counts[rows, buckets_one.to(device=counts.device, dtype=torch.int64)]


def cms_error_bound(row_counts: Tensor) -> Tensor:
    """Data-dependent overcount certificate of a counter CMS: any query's
    estimate exceeds the truth by at most ``(e / width) * N`` with probability
    ``>= 1 - e^-depth``, ``N`` the current total mass (float32)."""
    width = row_counts.shape[1]
    return cms_total(row_counts).to(torch.float32) * (math.e / width)
