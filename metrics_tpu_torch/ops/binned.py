"""Binned-curve threshold counting: kernel K1 and its plain PyTorch version.

Counterpart of ``metrics_tpu/ops/binned.py``. Every batch of the binned
curve family reduces to per-threshold TP/FP counts:

    tp[c, t] = sum_n pos[n, c] * (preds[n, c] >= thr[t])
    fp[c, t] = sum_n neg[n, c] * (preds[n, c] >= thr[t])

* :func:`binned_counts_cuda` wraps the hand-written CUDA kernel
  (``csrc/binned_counts.cu``, bucketize + histogram + suffix sum) that takes
  the place of the Pallas kernel ``_binned_counts_pallas_binary``. It takes
  CUDA tensors only, launches on the current stream, never synchronises, and
  counts its launches in ``binned_counts_cuda.launches``. It takes the grid
  ranked by :func:`rank_thresholds` (the binned metrics rank theirs once, and
  a call without it ranks first); a call is then one kernel launch and
  allocates only its output.
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
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops.build import KERNELS

# elements of the (T, chunk, C) comparison matrix the plain version holds at once
_PLAIN_CHUNK_ELEMENTS = 1 << 26

_WEIGHT_KINDS = {torch.bool: 0, torch.float32: 1}

# zeroed kernel workspaces, one per (device index, stream): the kernel leaves its workspace
# zeroed, so calls queued on one stream reuse it in order, and calls on two streams at once never
# share one. Layout: the accumulators (two uint32 per bin for bool weights, two float64 for float
# weights; T + 1 bins), then a 16-byte ticket.
_WORKSPACES: Dict[Tuple[int, int], Tensor] = {}


def _library() -> ctypes.CDLL:
    lib = KERNELS.load("binned_counts")
    if lib.mtt_binned_counts.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mtt_binned_counts.argtypes = [p, p, p, ctypes.c_longlong, p, p, i, i, p, p, i, p]
        lib.mtt_binned_counts.restype = i
        lib.mtt_binned_counts_plan.argtypes = [i, i, i, p]
        lib.mtt_binned_counts_plan.restype = i
    return lib


def _workspace(device: int, stream: int, t: int, kind: int) -> Tensor:
    nbytes = (1 + kind) * (t + 1) * 8 + 16
    ws = _WORKSPACES.get((device, stream))
    if ws is None or ws.numel() < nbytes:
        ws = torch.zeros(nbytes, dtype=torch.uint8, device=torch.device("cuda", device))  # once per stream and size
        _WORKSPACES[(device, stream)] = ws
    return ws


def launch_plan(t: int, kind: int = 0, device: int = 0) -> Dict[str, int]:
    """The kernel's launch plan for ``t`` thresholds (kind 0: bool weights, 1: float32)
    on a CUDA device: route, buckets, shared memory per block and resident blocks."""
    out = (ctypes.c_longlong * 4)()
    err = _library().mtt_binned_counts_plan(t, kind, device, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"binned_counts launch plan failed with CUDA error {err}")
    return {"shared_memory_route": out[0], "buckets": out[1], "smem_bytes": out[2], "resident_blocks": out[3]}


def binned_counts_cuda(
    preds: Tensor, pos: Tensor, neg: Tensor, thresholds: Tensor, ranked: Optional[Tuple[Tensor, Tensor]] = None
) -> Tuple[Tensor, Tensor]:
    """Kernel K1: ``(N,)`` scores, ``(N,)`` weights and ``(T,)`` thresholds (any
    order, duplicates allowed) -> float32 ``(T,)`` TP and FP counts.

    ``preds`` and ``thresholds`` are contiguous float32; ``pos`` and ``neg``
    are both contiguous bool (exact integer counts, ``N < 2**32``) or both
    float32. ``ranked`` is ``rank_thresholds(thresholds)``, computed once per
    grid; a call without it ranks the grid first (``torch.sort`` on the card).
    All lie on one CUDA device. Raises on anything else, and when the launch
    fails.
    """
    tensors = (preds, pos, neg, thresholds) if ranked is None else (preds, pos, neg, thresholds, *ranked)
    devices = {x.get_device() for x in tensors}  # -1 for a CPU tensor
    if len(devices) != 1 or -1 in devices or not preds.is_cuda:
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
    if ranked is not None and (
        ranked[0].dtype != torch.float32 or ranked[1].dtype != torch.int32
        or ranked[0].shape[0] != t or ranked[1].shape[0] != t
    ):
        raise ValueError("ranked must be rank_thresholds(thresholds): float32 and int32 of the grid's length")
    kind = _WEIGHT_KINDS[pos.dtype]
    if kind == 0 and n >= 1 << 32:
        raise ValueError("bool weights count in 32 bits: at most 2**32 - 1 samples a call")
    device = devices.pop()
    if n == 0 or t == 0:
        return torch.zeros((2, t), dtype=torch.float32, device=preds.device).unbind(0)

    sorted_thr, perm = rank_thresholds(thresholds) if ranked is None else ranked
    out = torch.empty((2, t), dtype=torch.float32, device=preds.device)  # the kernel writes every element
    lib = _library()
    stream = torch._C._cuda_getCurrentRawStream(device)  # the raw handle, without a Stream object
    ws = _workspace(device, stream, t, kind)
    err = lib.mtt_binned_counts(
        preds.data_ptr(), pos.data_ptr(), neg.data_ptr(), n, sorted_thr.data_ptr(), perm.data_ptr(), t, kind,
        ws.data_ptr(), out.data_ptr(), device, stream,
    )
    if err != 0:
        raise RuntimeError(f"binned_counts kernel launch failed with CUDA error {err}")
    binned_counts_cuda.launches += 1
    return out.unbind(0)


binned_counts_cuda.launches = 0


def rank_thresholds(thresholds: Tensor) -> Tuple[Tensor, Tensor]:
    """The grid ranked for the kernel: float32 ``sorted`` ascending with NaN last
    and ties in index order, and int32 ``perm`` with ``sorted == thresholds[perm]``."""
    sorted_thr, perm = torch.sort(thresholds.to(torch.float32), stable=True)
    return sorted_thr, perm.to(torch.int32)


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
    preds_c: Tensor,
    pos: Tensor,
    neg: Tensor,
    thresholds: Tensor,
    impl: str = "auto",
    ranked: Optional[Tuple[Tensor, Tensor]] = None,
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
        ranked: ``rank_thresholds(thresholds)`` where the caller keeps it per
            grid; the kernel's wrapper then does not rank the grid. The
            plain version does not need it.

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
    tp, fp = binned_counts_cuda(preds_c[:, 0].to(torch.float32).contiguous(), p, q, thr, ranked=ranked)
    return tp[None, :].to(preds_c.dtype), fp[None, :].to(preds_c.dtype)
