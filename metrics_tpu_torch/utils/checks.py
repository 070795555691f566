"""Classification input normalization and validation.

Counterpart of ``metrics_tpu/utils/checks.py``. The input case
(:func:`_resolve_case`) depends only on ndim/dtype; the value checks
(:func:`_validate_values`) are evaluated on the device as boolean flags and
read back to the host ONCE per call, so an update costs one device-to-host
read for validation however many checks apply. Inside ``torch.func.vmap`` (the
per-sample deltas of the keyed wrappers) the value checks are skipped, as the
JAX package skips them on arrays that are not concrete. Inside a
:func:`shared_input_format` window (opened by ``MetricCollection`` around one
step) the formatted result is memoized, so a collection formats and
validates each batch once across all its compute groups. Inside a
:func:`deferred_value_checks` window the value checks are postponed to the
window's end: their flags go into flight as non-blocking copies and one wait
reads them all.
"""
import math
import threading
from contextlib import contextmanager
from typing import Callable, List, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import is_batched, select_topk, to_onehot
from metrics_tpu_torch.utils.enums import DataType


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    if preds.shape != target.shape:
        raise RuntimeError("Predictions and targets are expected to have the same shape")


def _is_float(x: Tensor) -> bool:
    return x.is_floating_point()


def _squeeze_excess_dims(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Drop all size-1 dims except a size-1 leading batch dim."""
    if preds.ndim and preds.shape[0] == 1:
        return torch.squeeze(preds).unsqueeze(0), torch.squeeze(target).unsqueeze(0)
    return torch.squeeze(preds), torch.squeeze(target)


def _resolve_case(preds: Tensor, target: Tensor) -> Tuple[DataType, int]:
    """Shape/dtype-only resolution of the input case and the implied class count."""
    preds_float = _is_float(preds)
    if _is_float(target):
        raise ValueError("The `target` has to be an integer tensor.")

    if preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        if preds.ndim == 1 and preds_float:
            case = DataType.BINARY
        elif preds.ndim == 1 and not preds_float:
            case = DataType.MULTICLASS
        elif preds.ndim > 1 and preds_float:
            case = DataType.MULTILABEL
        else:
            case = DataType.MULTIDIM_MULTICLASS
        implied_classes = math.prod(preds.shape[1:]) if preds.ndim > 1 else 1
    elif preds.ndim == target.ndim + 1:
        if not preds_float:
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
        implied_classes = preds.shape[1]
        case = DataType.MULTICLASS if preds.ndim == 2 else DataType.MULTIDIM_MULTICLASS
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )
    return case, implied_classes


def _validate_values(
    preds: Tensor,
    target: Tensor,
    case: DataType,
    implied_classes: int,
    threshold: float,
    num_classes: Optional[int],
    is_multiclass: Optional[bool],
    sum_atol: float = 1e-8,
) -> None:
    """Value-dependent validation, in the reference's check order.

    Every applicable check becomes a 0-d boolean on the inputs' device; the
    flags are stacked and read back in ONE device-to-host transfer, then the
    first one set raises.
    """
    preds_float = _is_float(preds)
    multiclass_case = case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS)
    t_min, t_max = torch.aminmax(target)
    p_min, p_max = torch.aminmax(preds)

    checks = [(t_min < 0, "The `target` has to be a non-negative tensor.")]
    if not preds_float:
        checks.append((p_min < 0, "If `preds` are integers, they have to be non-negative."))
    if preds_float:
        checks.append((
            (p_min < 0) | (p_max > 1),
            "The `preds` should be probabilities, but values were detected outside of [0,1] range.",
        ))
    if is_multiclass is False:
        checks.append((t_max > 1, "If you set `is_multiclass=False`, then `target` should not exceed 1."))
        if not preds_float:
            checks.append((
                p_max > 1,
                "If you set `is_multiclass=False` and `preds` are integers, then `preds` should not exceed 1.",
            ))
    if preds.ndim == target.ndim and preds_float:
        checks.append((
            t_max > 1,
            "If `preds` and `target` are of shape (N, ...) and `preds` are floats, `target` should be binary.",
        ))
    if multiclass_case and preds_float:
        sums = torch.sum(preds, dim=1)
        checks.append((
            ~torch.all(torch.isclose(sums, torch.ones_like(sums), atol=sum_atol)),
            "Probabilities in `preds` must sum up to 1 across the `C` dimension.",
        ))
    if preds.shape != target.shape:
        checks.append((
            t_max >= implied_classes,
            "The highest label in `target` should be smaller than the size of the `C` dimension of `preds`.",
        ))
    if num_classes and num_classes > 1 and multiclass_case:
        checks.append((t_max >= num_classes, "The highest label in `target` should be smaller than `num_classes`."))
        if not preds_float:
            checks.append((p_max >= num_classes, "The highest label in `preds` should be smaller than `num_classes`."))

    read = flags_when_checked(torch.stack([c for c, _ in checks]))  # ONE readback

    def finalize() -> None:
        for flag, (_, message) in zip(read(), checks):
            if flag:
                raise ValueError(message)

    defer_or_run_value_check(finalize)


# ------------------------------------------------- deferred value-check window
# A value check needs a device-to-host read before it can raise. Inside a
# ``deferred_value_checks()`` window the raise is postponed: the finalizers are
# collected, their flags copied to the host without waiting, and one wait at
# the window's end covers every copy (and the work enqueued before it). Checks
# still raise in their order, and only when the window exits cleanly: an
# exception inside it skips the pending checks, as in the JAX package.
# Thread-local: concurrent threads do not share windows.
_DEFERRED_CHECKS = threading.local()


class _Window:
    __slots__ = ("pending", "devices")

    def __init__(self) -> None:
        self.pending: List[Callable[[], None]] = []
        self.devices: set = set()  # CUDA devices with flag copies in flight


@contextmanager
def deferred_value_checks():
    """Open a window that postpones value checks to its end (see above)."""
    prev = getattr(_DEFERRED_CHECKS, "window", None)
    _DEFERRED_CHECKS.window = window = _Window()
    try:
        yield
    finally:
        _DEFERRED_CHECKS.window = prev
    for device in window.devices:  # the window's one wait for its copies
        torch.cuda.current_stream(device).synchronize()
    for finalize in window.pending:  # raises propagate only on a clean exit
        finalize()


def defer_or_run_value_check(finalize: Callable[[], None]) -> None:
    """Run ``finalize`` now, or at the end of the open window."""
    window = getattr(_DEFERRED_CHECKS, "window", None)
    if window is None:
        finalize()
    else:
        window.pending.append(finalize)


def flags_when_checked(flags: Tensor) -> Callable[[], list]:
    """A reader of ``flags`` as host values for a check's finalizer. In an open
    window a CUDA tensor is copied to pinned host memory now, without waiting,
    and the window's end waits for it; otherwise the reader reads it then."""
    window = getattr(_DEFERRED_CHECKS, "window", None)
    if window is None or not flags.is_cuda:
        return flags.tolist
    host = torch.empty(flags.shape, dtype=flags.dtype, pin_memory=True)
    host.copy_(flags, non_blocking=True)
    window.devices.add(flags.device)
    return host.tolist


# ---------------------------------------------- shared canonicalization memo
# A MetricCollection step formats the SAME (preds, target) pair once per
# compute group (e.g. the Accuracy group and the StatScores group). Inside a
# ``shared_input_format()`` window the first call's result is memoized by
# argument identity and equivalent-config key, so further groups reuse it.
# Thread-local, nestable, and never active unless a collection opens it.
_CANON_MEMO = threading.local()


@contextmanager
def shared_input_format():
    """Open a memoization window for :func:`_input_format_classification`."""
    prev = getattr(_CANON_MEMO, "table", None)
    _CANON_MEMO.table = {}
    try:
        yield
    finally:
        _CANON_MEMO.table = prev


def _canon_memo_key(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    top_k: Optional[int],
    num_classes: Optional[int],
    is_multiclass: Optional[bool],
    validate: bool,
) -> tuple:
    # float multiclass inputs resolve num_classes to the C dim whether or not
    # the caller passed it: fold None and the matching value into one key
    effective = num_classes
    if preds.ndim == target.ndim + 1 and num_classes in (None, preds.shape[1]):
        effective = preds.shape[1]
    return (id(preds), id(target), float(threshold), top_k, effective, is_multiclass, bool(validate))


def _validate_static(
    case: DataType,
    implied_classes: int,
    preds_float: bool,
    threshold: float,
    num_classes: Optional[int],
    is_multiclass: Optional[bool],
    top_k: Optional[int],
) -> None:
    """Shape/argument consistency checks that need no data values."""
    if not 0 < threshold < 1:
        raise ValueError(f"The `threshold` should be a float in the (0,1) interval, got {threshold}")

    if num_classes:
        if case == DataType.BINARY:
            if num_classes > 2:
                raise ValueError("Your data is binary, but `num_classes` is larger than 2.")
            if num_classes == 2 and not is_multiclass:
                raise ValueError(
                    "Your data is binary and `num_classes=2`, but `is_multiclass` is not True."
                    " Set it to True if you want to transform binary data to multi-class format."
                )
            if num_classes == 1 and is_multiclass:
                raise ValueError(
                    "You have binary data and have set `is_multiclass=True`, but `num_classes` is 1."
                    " Either set `is_multiclass=None`(default) or set `num_classes=2`"
                    " to transform binary data to multi-class format."
                )
        elif case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
            if num_classes == 1 and is_multiclass is not False:
                raise ValueError(
                    "You have set `num_classes=1`, but predictions are integers."
                    " If you want to convert (multi-dimensional) multi-class data with 2 classes"
                    " to binary/multi-label, set `is_multiclass=False`."
                )
            if num_classes > 1:
                if is_multiclass is False and implied_classes != num_classes:
                    raise ValueError(
                        "You have set `is_multiclass=False`, but the implied number of classes "
                        " (from shape of inputs) does not match `num_classes`."
                    )
                if preds_float and implied_classes > 1 and num_classes != implied_classes:
                    raise ValueError("The size of C dimension of `preds` does not match `num_classes`.")
        elif case == DataType.MULTILABEL:
            if is_multiclass and num_classes != 2:
                raise ValueError(
                    "Your have set `is_multiclass=True`, but `num_classes` is not equal to 2."
                    " If you are trying to transform multi-label data to 2 class multi-dimensional"
                    " multi-class, you should set `num_classes` to either 2 or None."
                )
            if not is_multiclass and num_classes != implied_classes:
                raise ValueError("The implied number of classes (from shape of inputs) does not match num_classes.")

    if top_k is not None:
        if case == DataType.BINARY:
            raise ValueError("You can not use `top_k` parameter with binary data.")
        if not isinstance(top_k, int) or top_k <= 0:
            raise ValueError("The `top_k` has to be an integer larger than 0.")
        if not preds_float:
            raise ValueError("You have set `top_k`, but you do not have probability predictions.")
        if is_multiclass is False:
            raise ValueError("If you set `is_multiclass=False`, you can not set `top_k`.")
        if case == DataType.MULTILABEL and is_multiclass:
            raise ValueError(
                "If you want to transform multi-label data to 2 class multi-dimensional"
                "multi-class data using `is_multiclass=True`, you can not use `top_k`."
            )
        if top_k >= implied_classes:
            raise ValueError("The `top_k` has to be strictly smaller than the `C` dimension of `preds`.")


def _check_classification_inputs(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    num_classes: Optional[int],
    is_multiclass: Optional[bool],
    top_k: Optional[int],
    sum_atol: float = 1e-8,
) -> DataType:
    """Full validation; returns the resolved case."""
    if preds.shape[:1] != target.shape[:1]:
        raise ValueError("The `preds` and `target` should have the same first dimension.")
    case, implied_classes = _resolve_case(preds, target)
    if preds.ndim == target.ndim + 1 and is_multiclass is False and implied_classes != 2:
        raise ValueError(
            "You have set `is_multiclass=False`, but have more than 2 classes in your data,"
            " based on the C dimension of `preds`."
        )
    _validate_static(case, implied_classes, _is_float(preds), threshold, num_classes, is_multiclass, top_k)
    if not (is_batched(preds) or is_batched(target)):  # a batched view cannot be read back to the host
        _validate_values(preds, target, case, implied_classes, threshold, num_classes, is_multiclass,
                         sum_atol=sum_atol)
    return case


def _input_format_classification(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    is_multiclass: Optional[bool] = None,
    validate: bool = True,
) -> Tuple[Tensor, Tensor, DataType]:
    """Normalize any (preds, target) pair into binary int32 tensors ``(N, C)`` or
    ``(N, C, X)`` plus the resolved :class:`DataType` case (same contract as
    ``metrics_tpu.utils.checks._input_format_classification``)."""
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    table = getattr(_CANON_MEMO, "table", None)
    key = None
    if table is not None:
        key = _canon_memo_key(preds, target, threshold, top_k, num_classes, is_multiclass, validate)
        hit = table.get(key)
        if hit is not None:
            return hit[2]
        # pin the key tensors in the entry so their id() stays unique for the window
        memo_pin = (preds, target)
    preds, target = _squeeze_excess_dims(preds, target)

    # compare in fp32; the probability-sum tolerance scales with the original precision
    sum_atol = 1e-8
    if preds.dtype in (torch.float16, torch.bfloat16):
        sum_atol = float(torch.finfo(preds.dtype).eps) * max(preds.shape[1] if preds.ndim > 1 else 2, 2)
        preds = preds.to(torch.float32)

    if validate:
        case = _check_classification_inputs(
            preds, target, threshold=threshold, num_classes=num_classes, is_multiclass=is_multiclass,
            top_k=top_k, sum_atol=sum_atol,
        )
    else:
        case, _ = _resolve_case(preds, target)

    preds_float = _is_float(preds)

    if case in (DataType.BINARY, DataType.MULTILABEL) and not top_k:
        preds = (preds >= threshold).to(torch.int32) if preds_float else preds.to(torch.int32)
        num_classes = num_classes if not is_multiclass else 2

    if case == DataType.MULTILABEL and top_k:
        preds = select_topk(preds, top_k)

    if case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) or is_multiclass:
        if _is_float(preds):
            num_classes = preds.shape[1]
            preds = select_topk(preds, top_k or 1)
        else:
            if num_classes is None:
                num_classes = max(int(preds.max()), int(target.max())) + 1
            preds = to_onehot(preds, max(2, num_classes))

        target = to_onehot(target, max(2, num_classes))

        if is_multiclass is False:
            preds, target = preds[:, 1, ...], target[:, 1, ...]

    if (case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and is_multiclass is not False) or is_multiclass:
        target = target.reshape(target.shape[0], target.shape[1], -1)
        preds = preds.reshape(preds.shape[0], preds.shape[1], -1)
    else:
        target = target.reshape(target.shape[0], -1)
        preds = preds.reshape(preds.shape[0], -1)

    # undo the trailing singleton the (N, C, -1) reshape adds for non-multidim data
    if preds.ndim > 2 and preds.shape[-1] == 1:
        preds, target = preds.squeeze(-1), target.squeeze(-1)

    result = preds.to(torch.int32), target.to(torch.int32), case
    if table is not None:
        table[key] = (*memo_pin, result)
    return result


def _input_format_classification_one_hot(
    num_classes: int,
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multilabel: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Convert inputs to the one-hot ``(C, N*...)`` layout."""
    if not (preds.ndim == target.ndim or preds.ndim == target.ndim + 1):
        raise ValueError("preds and target must have same number of dimensions, or one additional dimension for preds")

    if preds.ndim == target.ndim + 1:
        preds = torch.argmax(preds, dim=1)

    if preds.ndim == target.ndim and not _is_float(preds) and num_classes > 1 and not multilabel:
        preds = to_onehot(preds, num_classes=num_classes)
        target = to_onehot(target, num_classes=num_classes)
    elif preds.ndim == target.ndim and _is_float(preds):
        preds = (preds >= threshold).to(torch.int32)

    if preds.ndim > 1:
        preds = torch.swapaxes(preds, 1, 0)
        target = torch.swapaxes(target, 1, 0)

    return preds.reshape(num_classes, -1), target.reshape(num_classes, -1)
