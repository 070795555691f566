"""BootStrapper: bootstrap-resampled uncertainty for any metric.

Counterpart of ``metrics_tpu/wrappers/bootstrapper.py``. Each of
``num_bootstraps`` copies of the base metric sees a with-replacement resample
of every batch. The resample indices come from a host-side
``np.random.RandomState(seed)``, drawn ``(K, n)`` at once a batch, as the JAX
package draws them, so the same seed gives the same resamples in both
packages.

The copies are one stacked state dict with a leading bootstrap axis: a step
runs the base update on the K resamples under ``torch.func.vmap``, merges the
stacked delta into the stacked accumulator, and (for a batch value) computes
the K values under ``vmap`` too, a fixed number of device operations whatever
K is. The per-copy loop of child metrics is taken instead where the world size
of an initialized process group is above 1 or a ``dist_sync_fn`` is given
(every copy's ``compute()`` then syncs on its own), or where the base metric
has list or buffer states (no bootstrap axis). The JAX package also falls
back to the loop when tracing the update fails; here the mode is decided by
these rules alone, so the stacked mode needs a base update that
``torch.func.vmap`` batches.
"""
from copy import deepcopy
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor, nn
from torch.func import vmap

from metrics_tpu_torch.core.metric import Metric, State, _BufferSpec
from metrics_tpu_torch.parallel.sync import dist_active
from metrics_tpu_torch.wrappers.keyed import _tree_map

__all__ = ["BootStrapper"]


class BootStrapper(Metric):
    r"""Bootstrap-resampled uncertainty for any metric.

    ``compute()`` returns ``{"mean": ..., "std": ...}`` over the copies'
    values (plus ``"raw"`` of shape ``(num_bootstraps,)`` when ``raw=True``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> m = BootStrapper(Accuracy(device="cpu"), num_bootstraps=4, seed=7)
        >>> m.update(torch.tensor([0.9, 0.8, 0.1, 0.2]), torch.tensor([1, 0, 0, 0]))
        >>> sorted(m.compute())
        ['mean', 'std']
    """

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        raw: bool = False,
        seed: int = 0,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
    ):
        if not isinstance(base_metric, Metric):
            raise ValueError(f"`base_metric` must be a Metric, got {type(base_metric).__name__}")
        if not isinstance(num_bootstraps, int) or num_bootstraps < 2:
            raise ValueError(
                f"`num_bootstraps` must be an integer >= 2 (the std needs two samples), got {num_bootstraps!r}"
            )
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=base_metric.device,
        )
        self._template = deepcopy(base_metric)  # a detached config carrier
        self._template.reset()
        self.num_bootstraps = num_bootstraps
        self.raw = raw
        self._resample_rng = np.random.RandomState(seed)
        self._stacked: Optional[State] = None  # (K, ...) state dict, made at the first update
        self.metrics: Optional[nn.ModuleList] = None  # per-copy children, on the loop path only
        self._mode: Optional[str] = None  # 'stacked' | 'loop', decided at the first update

    # ------------------------------------------------------------ resampling
    @staticmethod
    def _resample_plan(args: tuple, kwargs: dict) -> Tuple[Optional[int], tuple, tuple]:
        """``(n, per-arg flags, per-kwarg flags)``: the tensors whose leading
        axis matches the first tensor's are resampled."""
        arrays = [a for a in (*args, *kwargs.values()) if isinstance(a, Tensor) and a.ndim >= 1]
        n = arrays[0].shape[0] if arrays else None

        def flag(v: Any) -> bool:
            return isinstance(v, Tensor) and v.ndim >= 1 and v.shape[0] == n

        return n, tuple(flag(a) for a in args), tuple((k, flag(v)) for k, v in sorted(kwargs.items()))

    def _draw(self, n: Optional[int]) -> Optional[Tensor]:
        if n is None:
            return None
        # one (K, n) draw equals K sequential (n,) draws from the same stream:
        # the loop and the stacked path see the same resamples
        return torch.from_numpy(self._resample_rng.randint(0, n, (self.num_bootstraps, n))).to(self.device)

    def _decide_mode(self) -> None:
        if self._mode is not None:
            return
        multi_rank = dist_active() and dist.get_world_size(self.process_group) > 1
        cat_states = any(isinstance(d, (list, _BufferSpec)) for d in self._template._defaults.values())
        self._mode = "loop" if multi_rank or self.dist_sync_fn is not None or cat_states else "stacked"

    # ---------------------------------------------------------- stacked path
    def _init_stacked(self) -> State:
        return _tree_map(lambda x: x.unsqueeze(0).expand(self.num_bootstraps, *x.shape).clone(),
                         self._template.init_state())

    def _copy_values(self, stacked: State) -> Tensor:
        """The K copies' values, one vmapped compute (float32)."""
        template = self._template
        return vmap(lambda s: torch.as_tensor(template.compute_from_state(s)).to(torch.float32))(stacked)

    def _stacked_step(self, args: tuple, kwargs: dict, idx_mat: Tensor, with_values: bool) -> Optional[Tensor]:
        """Resample, update and merge all K copies; the K batch values when asked."""
        _, aflags, kwflags = self._resample_plan(args, kwargs)
        template = self._template

        def one(idx: Tensor) -> State:
            rs_args = tuple(a[idx] if f else a for a, f in zip(args, aflags))
            rs_kw = {k: (kwargs[k][idx] if f else kwargs[k]) for k, f in kwflags}
            return template.update_state(template.init_state(), *rs_args, **rs_kw)

        deltas = vmap(one)(idx_mat)
        if self._stacked is None:
            self._stacked = self._init_stacked()
        self._stacked = vmap(template.merge_states)(self._stacked, deltas)
        return self._copy_values(deltas) if with_values else None

    # ------------------------------------------------------------- loop path
    def _ensure_children(self) -> None:
        if self.metrics is None:
            self.metrics = nn.ModuleList([deepcopy(self._template) for _ in range(self.num_bootstraps)])

    def _loop_update(self, args: tuple, kwargs: dict, idx_mat: Optional[Tensor]) -> None:
        self._ensure_children()
        _, aflags, kwflags = self._resample_plan(args, kwargs)
        kwflag_map = dict(kwflags)
        for k, metric in enumerate(self.metrics):
            if idx_mat is None:
                metric.update(*args, **kwargs)
                continue
            idx = idx_mat[k]
            metric.update(*(a[idx] if f else a for a, f in zip(args, aflags)),
                          **{key: (v[idx] if kwflag_map[key] else v) for key, v in kwargs.items()})

    def _loop_batch_value(self, args: tuple, kwargs: dict, idx_mat: Optional[Tensor]) -> Tensor:
        """Batch values under the double-update forward: the children's
        accumulators are kept and restored around a batch-only pass."""
        caches = [(m._current_state(), m._count_bound, m._epoch_watermark) for m in self.metrics]
        saved_sync = [(m._to_sync, m._in_forward) for m in self.metrics]
        for m in self.metrics:
            m._to_sync, m._in_forward = self.dist_sync_on_step, True
            m.reset()
        try:
            self._loop_update(args, kwargs, idx_mat)
            values = torch.stack([torch.as_tensor(m.compute()).to(torch.float32) for m in self.metrics])
        finally:
            for m, (cache, bound, watermark), (to_sync, in_fwd) in zip(self.metrics, caches, saved_sync):
                m._set_state(cache)
                m._count_bound, m._epoch_watermark = bound, watermark
                m._computed = None
                m._to_sync, m._in_forward = to_sync, in_fwd
        return values

    # -------------------------------------------------------------- dispatch
    def _stats(self, values: Tensor) -> Dict[str, Tensor]:
        out = {"mean": torch.mean(values, dim=0), "std": torch.std(values, dim=0, correction=1)}
        if self.raw:
            out["raw"] = values
        return out

    def _accumulate(self, args: tuple, kwargs: dict, with_compute: bool) -> Optional[Dict[str, Tensor]]:
        self._decide_mode()
        n, _, _ = self._resample_plan(args, kwargs)
        idx_mat = self._draw(n)
        if self._mode == "stacked":
            if idx_mat is None:
                idx_mat = torch.zeros((self.num_bootstraps, 0), dtype=torch.int64, device=self.device)
            values = self._stacked_step(args, kwargs, idx_mat, with_compute)
        else:
            self._loop_update(args, kwargs, idx_mat)
            values = self._loop_batch_value(args, kwargs, idx_mat) if with_compute else None
        return None if values is None else self._stats(values)

    # ------------------------------------------------------------ public API
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Accumulate an independent with-replacement resample per copy."""
        self._accumulate(args, kwargs, with_compute=False)

    def forward(self, *args: Any, **kwargs: Any) -> Optional[Dict[str, Tensor]]:
        """Accumulate the batch into every copy; with ``compute_on_step`` return
        the batch's mean / std over the copies."""
        self._computed = None
        stats = self._accumulate(args, kwargs, with_compute=self.compute_on_step)
        if not self.compute_on_step:
            return None
        self._forward_cache = stats
        return stats

    def compute(self) -> Dict[str, Tensor]:
        self._decide_mode()  # a rank with no update takes the same path as the others
        if self._mode == "loop":
            self._ensure_children()
            return self._stats(torch.stack([torch.as_tensor(m.compute()).to(torch.float32) for m in self.metrics]))
        return self._stats(self._copy_values(self._stacked if self._stacked is not None else self._init_stacked()))

    def reset(self) -> None:
        super().reset()
        self._stacked = None
        if self.metrics is not None:
            for metric in self.metrics:
                metric.reset()
