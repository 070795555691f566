"""Binned-curve threshold counting: kernel K1 and its plain PyTorch version.

Counterpart of ``metrics_tpu/ops/binned.py``. Every batch of the binned
curve family reduces to per-threshold TP/FP counts:

    tp[c, t] = sum_n pos[n, c] * (preds[n, c] >= thr[t])
    fp[c, t] = sum_n neg[n, c] * (preds[n, c] >= thr[t])

* :func:`binned_counts_cuda` wraps the hand-written CUDA kernel
  (``csrc/binned_counts.cu``, bucketize + histogram + suffix sum) that takes
  the place of the Pallas kernel ``_binned_counts_pallas_binary``. It takes
  CUDA tensors only, launches on the current stream, never synchronises, and
  counts its launches in ``binned_counts_cuda.launches``.
* :func:`_binned_counts_torch` is the plain version: the comparison matrix
  contracted against the weights, chunked over N so the ``(T, chunk, C)``
  intermediate stays bounded. It accumulates in float64, so 0/1 weights
  count exactly and float weights lose nothing to the contraction order.

Dispatch (``binned_stat_counts(impl="auto")``): a CUDA tensor with ``C == 1``
and ``N > 0`` runs the kernel; a CPU tensor runs the plain version; ``C > 1``
and ``N == 0`` take the plain version on either device, as the JAX package
sends them to XLA outside its kernel.
"""
import ctypes
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops.build import KERNELS

# elements of the (T, chunk, C) comparison matrix the plain version holds at once
_PLAIN_CHUNK_ELEMENTS = 1 << 26

_WEIGHT_KINDS = {torch.bool: (0, torch.int32), torch.float32: (1, torch.float64)}


def _library() -> ctypes.CDLL:
    lib = KERNELS.load("binned_counts")
    fn = lib.mtt_binned_counts
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_longlong, p, ctypes.c_int, ctypes.c_int, p, p, p, p, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def binned_counts_cuda(preds: Tensor, pos: Tensor, neg: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor]:
    """Kernel K1: ``(N,)`` scores, ``(N,)`` weights and ``(T,)`` thresholds (any
    order, duplicates allowed) -> float32 ``(T,)`` TP and FP counts.

    ``preds`` and ``thresholds`` are contiguous float32; ``pos`` and ``neg``
    are both contiguous bool (exact integer counts) or both float32. All lie
    on one CUDA device. Raises on anything else, and when the launch fails.
    """
    tensors = (preds, pos, neg, thresholds)
    if not all(x.is_cuda for x in tensors) or len({x.device for x in tensors}) != 1:
        raise ValueError("binned_counts_cuda takes CUDA tensors on one device")
    if not all(x.ndim == 1 and x.is_contiguous() for x in tensors):
        raise ValueError("binned_counts_cuda takes contiguous 1-d tensors")
    if preds.dtype != torch.float32 or thresholds.dtype != torch.float32:
        raise ValueError("binned_counts_cuda takes float32 scores and thresholds")
    if pos.dtype != neg.dtype or pos.dtype not in _WEIGHT_KINDS:
        raise ValueError(f"binned_counts_cuda takes bool or float32 weights of one dtype, got {pos.dtype}/{neg.dtype}")
    n, t = preds.shape[0], thresholds.shape[0]
    if pos.shape[0] != n or neg.shape[0] != n:
        raise ValueError("scores and weights must have the same length")
    out = torch.zeros((2, t), dtype=torch.float32, device=preds.device)
    if n == 0 or t == 0:
        return out[0], out[1]

    kind, acc_dtype = _WEIGHT_KINDS[pos.dtype]
    sorted_thr = torch.empty(t, dtype=torch.float32, device=preds.device)
    perm = torch.empty(t, dtype=torch.int32, device=preds.device)
    hist = torch.zeros(2 * (t + 1), dtype=acc_dtype, device=preds.device)
    lib = _library()
    stream = torch.cuda.current_stream(preds.device).cuda_stream
    err = lib.mtt_binned_counts(
        preds.data_ptr(), pos.data_ptr(), neg.data_ptr(), n, thresholds.data_ptr(), t, kind,
        sorted_thr.data_ptr(), perm.data_ptr(), hist.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        preds.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"binned_counts kernel launch failed with CUDA error {err}")
    binned_counts_cuda.launches += 1
    return out[0], out[1]


binned_counts_cuda.launches = 0


def _binned_counts_torch(preds_c: Tensor, pos: Tensor, neg: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain version: ``(preds >= thr)`` contracted against the weights, in
    float64, N chunked. ``(N, C)`` inputs -> ``(C, T)`` counts in ``preds_c.dtype``."""
    n, c = preds_c.shape
    thr = thresholds.to(device=preds_c.device, dtype=preds_c.dtype)
    t = thr.shape[0]
    w = torch.stack([pos, neg], dim=-1).to(torch.float64)  # (N, C, 2)
    counts = torch.zeros((2, c, t), dtype=torch.float64, device=preds_c.device)
    rows = max(1, _PLAIN_CHUNK_ELEMENTS // max(1, t * c))
    for start in range(0, n, rows):
        ge = (preds_c[None, start:start + rows, :] >= thr[:, None, None]).to(torch.float64)  # (T, rows, C)
        counts += torch.einsum("tnc,nck->kct", ge, w[start:start + rows])
    counts = counts.to(preds_c.dtype)
    return counts[0], counts[1]


def binned_stat_counts(
    preds_c: Tensor, pos: Tensor, neg: Tensor, thresholds: Tensor, impl: str = "auto"
) -> Tuple[Tensor, Tensor]:
    """Per-threshold TP/FP counts: ``tp[c, t] = sum_n pos[n, c] * (preds[n, c] >= thr[t])``.

    Args:
        preds_c: ``(N, C)`` float32 scores.
        pos / neg: ``(N, C)`` weights of positive / negative samples: bool
            0/1 masks (exact integer counts) or float32 weights.
        thresholds: ``(T,)`` thresholds, in any order.
        impl: ``"auto"`` (the kernel for a CUDA tensor with ``C == 1`` and
            ``N > 0``, else the plain version), ``"torch"`` (the plain
            version), or ``"cuda"`` (the kernel; raises for a CPU tensor).

    Returns:
        ``(tp, fp)`` of shape ``(C, T)``, in ``preds_c.dtype``.
    """
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"impl must be 'auto', 'torch' or 'cuda', got {impl!r}")
    if impl == "cuda" and not preds_c.is_cuda:
        raise ValueError("impl='cuda' runs the CUDA kernel and takes CUDA tensors; this input is on the CPU")
    n, c = preds_c.shape
    if impl == "torch" or not preds_c.is_cuda or n == 0 or c > 1:
        return _binned_counts_torch(preds_c, pos, neg, thresholds)

    if pos.dtype == torch.bool and neg.dtype == torch.bool:
        p, q = pos[:, 0].contiguous(), neg[:, 0].contiguous()
    else:
        p, q = pos[:, 0].to(torch.float32).contiguous(), neg[:, 0].to(torch.float32).contiguous()
    thr = thresholds.to(device=preds_c.device, dtype=torch.float32).contiguous()
    tp, fp = binned_counts_cuda(preds_c[:, 0].to(torch.float32).contiguous(), p, q, thr)
    return tp[None, :].to(preds_c.dtype), fp[None, :].to(preds_c.dtype)
