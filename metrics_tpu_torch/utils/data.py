"""Tensor/data transforms shared by the functional kernels.

Counterpart of ``metrics_tpu/utils/data.py``. One-hot encodings are built by
comparing against ``arange`` (out-of-range labels give an all-zero row, as
``jax.nn.one_hot`` does), and ties in ``select_topk`` go to the lowest index,
as ``jax.lax.top_k`` breaks them.
"""
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utils.prints import rank_zero_warn


def dim_zero_cat(x: Union[Tensor, List[Tensor]]) -> Tensor:
    """Concatenate a (list of) tensor(s) along dim 0."""
    x = x if isinstance(x, (list, tuple)) else [x]
    return torch.cat([torch.atleast_1d(v) for v in x], dim=0)


class ClassScores(list):
    """Per-class results: a list of 0-d tensors (the shape the JAX package's
    ``ClassScores`` gives), with the ``(C,)`` tensor they are views of kept as
    ``.array`` so the caller can read every class back in one transfer."""

    __slots__ = ("array",)

    def __init__(self, values: Tensor):
        super().__init__(values.unbind(0))
        self.array = values


def scatter_rows_drop(out: Tensor, dest: Tensor, rows: Tensor) -> Tensor:
    """``out`` with ``rows[i]`` written at row ``dest[i]``; rows whose ``dest``
    lies outside ``[0, len(out))`` are dropped (the ``mode="drop"`` scatter of
    the JAX package). ``out`` is not modified. Destinations inside the range
    must be unique. A dropped row goes to a spare row of its own past the end,
    so no two writes share a row."""
    n, k = out.shape[0], rows.shape[0]
    ext = torch.cat([out, out.new_empty((k, *out.shape[1:]))])
    spare = n + torch.arange(k, device=dest.device)
    dest = torch.where((dest >= 0) & (dest < n), dest, spare)
    ext.index_copy_(0, dest, rows.to(out.dtype))
    return ext[:n]


def upcast_accum(x: Tensor) -> Tensor:
    """Upcast bfloat16 / float16 to float32 before accumulation, so epoch-scale
    sums of errors and moments do not lose precision."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.to(torch.float32)
    return x


def host_copy(x: Tensor) -> np.ndarray:
    """``x`` as a host numpy array that owns its memory: ``.cpu()`` already
    copies a card tensor, while a CPU tensor's ``.numpy()`` is a view of the
    live storage that later in-place updates would change, so it is copied.
    One transfer a tensor."""
    x = x.detach()
    return x.cpu().numpy() if x.device.type != "cpu" else x.numpy().copy()


def host_tree(tree: Any) -> Any:
    """A tree as host numpy (publication values, merged partial states):
    every tensor of a (nested, named) tuple, list or dict copied to the host
    with ``host_copy``, every other leaf ``np.asarray``'d; a named tuple,
    such as a sketch, keeps its type."""
    if isinstance(tree, Tensor):
        return host_copy(tree)
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(host_tree(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(host_tree(v) for v in tree)
    if isinstance(tree, list):
        return [host_tree(v) for v in tree]
    return np.asarray(tree)


def is_batched(x: Any) -> bool:
    """Whether ``x`` is a tensor seen inside ``torch.func.vmap`` (a batched
    view whose values cannot be read back to the host). The counterpart of the
    JAX package's ``is_concrete`` test, inverted: value checks run only on
    tensors that are not batched, as the JAX package's run only on concrete
    arrays (never under ``jax.vmap`` / ``jit``)."""
    return isinstance(x, Tensor) and torch._C._functorch.is_functorch_wrapped_tensor(x)


def tree_stack(values: Sequence[Any]) -> Any:
    """Stack equally structured values along a new leading axis: tensors
    (and Python numbers) with ``torch.stack``, dicts per key, (named) tuples
    and lists per position. The ``jax.tree_util.tree_map(jnp.stack)`` of the
    JAX package's batched forwards."""
    first = values[0]
    if isinstance(first, dict):
        return {k: tree_stack([v[k] for v in values]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_stack([v[i] for v in values]) for i in range(len(first))))
    if isinstance(first, (list, tuple)):
        stacked = [tree_stack([v[i] for v in values]) for i in range(len(first))]
        return tuple(stacked) if isinstance(first, tuple) else stacked
    return torch.stack([torch.as_tensor(v) for v in values])


def accum_int_dtype() -> torch.dtype:
    """Dtype of count-accumulator states: int64, always (the JAX package's
    counterpart picks int32 unless ``jax_enable_x64`` is set)."""
    return torch.int64


# (what, config, device) -> a constant made on the host once and kept on that
# device: copying it from the host on every call would be a synchronizing call
_DEVICE_CONSTANTS: Dict[tuple, Tensor] = {}


def device_constant(key: tuple, device: torch.device, make: Callable[[], Any], dtype: torch.dtype) -> Tensor:
    """The tensor ``make()`` (host numpy) of ``dtype`` on ``device``, built once per ``key`` and device."""
    full = (*key, str(device))
    value = _DEVICE_CONSTANTS.get(full)
    if value is None:
        value = _DEVICE_CONSTANTS[full] = torch.tensor(np.asarray(make()), dtype=dtype).to(device)
    return value


@contextmanager
def full_fp32_matmul() -> Iterator[None]:
    """Run the float32 products inside in full float32, then restore the caller's setting.

    The JAX package pins ``precision="highest"`` on the products of its
    pairwise, embedding and intrinsic-clustering functions. On the card a
    float32 ``torch.matmul`` runs in TF32 when the caller's
    ``torch.backends.cuda.matmul.allow_tf32`` is on (``float32_matmul_precision``
    ``"high"``); inside this context it is ``"highest"``, so the result does not
    depend on that flag."""
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)


def scatter_count(counts: Tensor, flat_index: Tensor, keep: Tensor) -> Tensor:
    """``counts`` plus one at ``flat_index`` (into its row-major flat view) for
    every sample whose ``keep`` is set, a new tensor: the update of the sketch
    states. One ``scatter_add`` with the kept flags as the increments, so a
    dropped sample adds zero at a valid cell and the shapes never depend on the
    data (no host read). Integer atomics are exact in any order, so the card's
    counts equal the CPU's. ``scatter_add`` rather than ``index_add``:
    ``torch.func.vmap`` (the keyed wrappers' per-sample deltas) batches it into
    one kernel, where its rule for ``index_add`` launches one a sample."""
    flat = counts.reshape(-1).scatter_add(0, flat_index.reshape(-1), keep.reshape(-1).to(counts.dtype))
    return flat.view(counts.shape)


def dim_zero_sum(x: Tensor) -> Tensor:
    return torch.sum(x, dim=0)


def dim_zero_mean(x: Tensor) -> Tensor:
    return torch.mean(x.float() if not x.is_floating_point() else x, dim=0)


def dim_zero_min(x: Tensor) -> Tensor:
    return torch.min(x, dim=0).values


def dim_zero_max(x: Tensor) -> Tensor:
    return torch.max(x, dim=0).values


def to_onehot(label_tensor: Tensor, num_classes: Optional[int] = None) -> Tensor:
    """Convert an ``(N, ...)`` integer label tensor to a one-hot ``(N, C, ...)`` int32 tensor.

    Example:
        >>> import torch
        >>> to_onehot(torch.tensor([0, 1, 2]), num_classes=3)
        tensor([[1, 0, 0],
                [0, 1, 0],
                [0, 0, 1]], dtype=torch.int32)
    """
    if num_classes is None:
        num_classes = int(label_tensor.max()) + 1
    classes = torch.arange(num_classes, device=label_tensor.device, dtype=torch.int64)
    classes = classes.view(1, num_classes, *([1] * (label_tensor.ndim - 1)))
    return (label_tensor.to(torch.int64).unsqueeze(1) == classes).to(torch.int32)


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """Int32 tensor with 1s at the ``topk`` largest entries along ``dim``.

    Example:
        >>> import torch
        >>> select_topk(torch.tensor([[1.1, 2.0, 3.0], [2.0, 1.0, 0.5]]), topk=2)
        tensor([[0, 1, 1],
                [1, 1, 0]], dtype=torch.int32)
    """
    if topk == 1:
        # argmax returns the first maximal index
        idx = torch.argmax(prob_tensor, dim=dim, keepdim=True)
    else:
        # a stable descending sort keeps the lower index first among ties
        idx = torch.sort(prob_tensor, dim=dim, descending=True, stable=True).indices.narrow(dim, 0, topk)
    # the out-of-place scatter: ``torch.func.vmap`` batches it (the keyed
    # wrappers' per-sample deltas), where the in-place form loops per sample
    return torch.zeros_like(prob_tensor, dtype=torch.int32).scatter(dim, idx, 1)


def to_categorical(tensor: Tensor, argmax_dim: int = 1) -> Tensor:
    """Argmax along ``argmax_dim``.

    Example:
        >>> import torch
        >>> to_categorical(torch.tensor([[0.2, 0.5], [0.9, 0.1]]))
        tensor([1, 0], dtype=torch.int32)
    """
    return torch.argmax(tensor, dim=argmax_dim).to(torch.int32)


def get_num_classes(preds: Tensor, target: Tensor, num_classes: Optional[int] = None) -> int:
    """Infer/validate the number of classes from the data values."""
    num_target_classes = int(target.max()) + 1
    num_pred_classes = int(preds.max()) + 1 if not preds.is_floating_point() or num_classes is None else num_classes
    if num_classes is None:
        return max(num_pred_classes, num_target_classes)
    if num_classes != max(num_pred_classes, num_target_classes):
        rank_zero_warn(
            f"You have set {num_classes} number of classes which is"
            f" different from predicted ({num_pred_classes}) and"
            f" target ({num_target_classes}) number of classes",
            RuntimeWarning,
        )
    return num_classes


def apply_to_collection(
    data: Any,
    dtype: Union[type, tuple],
    function: Callable,
    *args: Any,
    **kwargs: Any,
) -> Any:
    """Recursively apply ``function`` to all elements of type ``dtype`` in a collection.

    Example:
        >>> apply_to_collection({"a": 2, "b": [1, 2]}, int, lambda x: x * 2)
        {'a': 4, 'b': [2, 4]}
    """
    elem_type = type(data)

    if isinstance(data, dtype):
        return function(data, *args, **kwargs)

    if isinstance(data, Mapping):
        return elem_type({k: apply_to_collection(v, dtype, function, *args, **kwargs) for k, v in data.items()})

    if isinstance(data, tuple) and hasattr(data, "_fields"):  # namedtuple
        return elem_type(*(apply_to_collection(d, dtype, function, *args, **kwargs) for d in data))

    if isinstance(data, Sequence) and not isinstance(data, str):
        return elem_type([apply_to_collection(d, dtype, function, *args, **kwargs) for d in data])

    return data


def get_group_indexes(idx: Tensor) -> List[Tensor]:
    """Row positions grouped by the value of ``idx``, groups in order of first appearance.

    Host-side (one read of ``idx``), as in the JAX package; the retrieval
    metrics never call it: they group with sorted segment operations
    (``metrics_tpu_torch/functional/retrieval/segments.py``).

    Example:
        >>> import torch
        >>> [g.tolist() for g in get_group_indexes(torch.tensor([0, 0, 1, 1, 1]))]
        [[0, 1], [2, 3, 4]]
    """
    res: dict = {}
    for i, v in enumerate(idx.tolist()):
        res.setdefault(v, []).append(i)
    return [torch.tensor(g, dtype=torch.int32, device=idx.device) for g in res.values()]
