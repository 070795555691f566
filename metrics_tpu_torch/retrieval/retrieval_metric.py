"""Retrieval metric base class.

Counterpart of ``metrics_tpu/retrieval/retrieval_metric.py``: cat states
``idx`` / ``preds`` / ``target`` (int32 / float32 / int32), the flatten-append
update, the ``query_without_relevant_docs`` policy and the ``IGNORE_IDX = -100``
exclude sentinel. Subclasses provide ``_grouped_metric``, which scores every
query of the epoch at once with the sort and segment operations of
``functional/retrieval/segments.py``.

The policy keeps the reference's quirk: a query is empty when its *raw* target
sum is 0, so ``-100`` sentinels make a query count as non-empty.

Row-sharded epoch states (``parallel.placement.row_sharded``) compute through
the ``all_to_all`` regroup of ``parallel/sharded_dispatch.retrieval_sharded``,
which scores each rank's queries with ``_device_sums`` (its ``pad`` argument
masks the regroup's ghost rows); ``regroup_capacity`` sets its bucket size.
Left out here: the JAX package's jitted compute cache, which an eager port has
no use for.
"""
from abc import ABC, abstractmethod
from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.retrieval.segments import segment_sum
from metrics_tpu_torch.functional.retrieval.utils import check_topk
from metrics_tpu_torch.parallel.buffer import as_values

IGNORE_IDX = -100


def _validate_k(k: Optional[int]) -> Optional[int]:
    """Shared constructor check for the top-k retrieval modules."""
    check_topk(k)
    return k


class RetrievalMetric(Metric, ABC):
    r"""Accumulate (indexes, preds, target) rows; compute the mean of a
    per-query metric over all queries.

    Args:
        query_without_relevant_docs: policy for queries with no positive
            target: 'skip' (default) | 'error' | 'pos' (count 1.0) | 'neg' (0.0).
        exclude: target value marking rows to ignore (default -100).
        capacity: fixed row capacity for the epoch cat states (PaddedBuffers).
        device: where the states live (``cuda`` unless ``"cpu"`` is passed).

    Under the 'skip', 'pos' and 'neg' policies the epoch compute reads nothing
    back to the host; 'error' reads one flag.
    """

    def __init__(
        self,
        query_without_relevant_docs: str = "skip",
        exclude: int = IGNORE_IDX,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        capacity: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
            capacity=capacity,
        )
        query_without_relevant_docs_options = ("error", "skip", "pos", "neg")
        if query_without_relevant_docs not in query_without_relevant_docs_options:
            raise ValueError(
                f"`query_without_relevant_docs` received a wrong value {query_without_relevant_docs}. "
                f"Allowed values are {query_without_relevant_docs_options}"
            )

        self.query_without_relevant_docs = query_without_relevant_docs
        self.exclude = exclude
        # rows a destination bucket of the sharded regroup holds (None: four times the balanced load)
        self.regroup_capacity: Optional[int] = None

        self.add_state("idx", default=[], dist_reduce_fx=None, item_shape=(), item_dtype=torch.int32)
        self.add_state("preds", default=[], dist_reduce_fx=None, item_shape=(), item_dtype=torch.float32)
        self.add_state("target", default=[], dist_reduce_fx=None, item_shape=(), item_dtype=torch.int32)

    # Every member of the family shares this flatten-append update and every
    # family knob is compute-only, so in a ``MetricCollection`` the retrieval
    # members with the same ``capacity`` form ONE compute group: one append a
    # step, one gather at the epoch. A subclass that adds update config joins
    # the group key by itself (the exclusion form of ``Metric``).
    _GROUP_COMPUTE_ONLY_ATTRS = ("k", "query_without_relevant_docs", "exclude", "regroup_capacity")

    def update(self, idx: Tensor, preds: Tensor, target: Tensor) -> None:
        if not (idx.shape == target.shape == preds.shape):
            raise ValueError("`idx`, `preds` and `target` must be of the same shape")

        self._append("idx", idx.to(torch.int32).reshape(-1))
        self._append("preds", preds.to(torch.float32).reshape(-1))
        self._append("target", target.to(torch.int32).reshape(-1))

    def _states_own_sync(self) -> bool:
        from metrics_tpu_torch.parallel.sharded_dispatch import retrieval_applicable

        return retrieval_applicable(self) is not None

    def compute(self) -> Tensor:
        from metrics_tpu_torch.parallel.sharded_dispatch import retrieval_sharded

        sharded = retrieval_sharded(self)  # row-sharded epoch states: the all_to_all regroup
        if sharded is not None:
            return sharded
        idx = as_values(self.idx)
        preds = as_values(self.preds)
        target = as_values(self.target)

        if idx.shape[0] == 0:
            return torch.tensor(0.0, device=self.device)

        result, flag = self._device_compute(idx, preds, target)
        if self.query_without_relevant_docs == "error" and bool(flag):
            raise ValueError(
                f"`{self.__class__.__name__}.compute()` was provided with a query {self._EMPTY_QUERY_ERROR}"
            )
        return result

    def _device_compute(self, idx: Tensor, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
        """(result, empty-query flag), both on the device."""
        total, n_kept, flag = self._device_sums(idx, preds, target)
        return torch.where(n_kept == 0, 0.0, total / torch.clamp(n_kept, min=1)), flag

    def _device_sums(
        self, idx: Tensor, preds: Tensor, target: Tensor, pad: Optional[Tensor] = None
    ) -> Tuple[Tensor, Tensor, Tensor]:
        """(score total, query count, empty-query flag): the epoch sums before the
        final mean, so that a sharded caller can add partials across ranks first.

        Query ids are densified by a stable sort, a flag at each new id, a
        ``cumsum`` and a scatter back to row order: no ``torch.unique`` and no host
        read. The segment count is the row count N, an upper bound; absent
        segments are masked. ``pad`` marks ghost rows (sharded padding): unlike
        ``exclude`` sentinels, which keep their query visible as in the
        reference, pad rows must not make a query exist at all.
        """
        n = idx.shape[0]
        order = torch.argsort(idx, stable=True)
        sorted_ids = idx[order]
        new_segment = torch.cat([sorted_ids.new_zeros(1, dtype=torch.int64), (sorted_ids[1:] != sorted_ids[:-1]).to(torch.int64)])
        dense = torch.empty(n, dtype=torch.int64, device=idx.device)
        dense[order] = torch.cumsum(new_segment, 0)

        real = torch.ones(n, dtype=torch.int64, device=idx.device) if pad is None else ~pad
        exists = segment_sum(real, dense, n) > 0

        if pad is not None:
            target = torch.where(pad, 0, target)
        empty = self._empty_query_mask(dense, target, exists, n)
        flag = torch.any(empty)

        # sentinel rows must not rank, hit or grade: -inf scores sink them below
        # every real row of their query, zero targets null their gain
        excluded = target == self.exclude
        if pad is not None:
            excluded = excluded | pad
        preds_m = torch.where(excluded, float("-inf"), preds)
        target_m = torch.where(excluded, 0, target)
        scores = self._grouped_metric(dense, preds_m, target_m, n, valid=~excluded)

        if self.query_without_relevant_docs == "pos":
            scores = torch.where(empty, 1.0, scores)
        elif self.query_without_relevant_docs == "neg":
            scores = torch.where(empty, 0.0, scores)
        elif self.query_without_relevant_docs == "skip":
            kept = exists & ~empty
            return torch.sum(torch.where(kept, scores, 0.0)), torch.sum(kept), flag

        return torch.sum(torch.where(exists, scores, 0.0)), torch.sum(exists), flag

    # what the 'error' policy reports; subclasses overriding _empty_query_mask
    # override this to match their condition
    _EMPTY_QUERY_ERROR = "without positive targets"

    def _empty_query_mask(self, dense_idx: Tensor, target: Tensor, exists: Tensor, num_queries: int) -> Tensor:
        """Queries the ``query_without_relevant_docs`` policy applies to.

        Default: no positive rows, judged on the RAW target sums (the
        reference's quirk: exclude sentinels make a query count as non-empty),
        summed exactly in int64. Metrics whose per-query score is undefined for
        another reason (fall-out needs non-relevant rows) override this.
        """
        return (segment_sum(target, dense_idx, num_queries) == 0) & exists

    @abstractmethod
    def _grouped_metric(
        self,
        dense_idx: Tensor,
        preds: Tensor,
        target: Tensor,
        num_queries: int,
        valid: Optional[Tensor] = None,
    ) -> Tensor:
        """Per-query float32 scores, shape (num_queries,).

        ``valid`` marks rows that are real documents (False: exclude sentinel
        rows, already neutralized to score -inf and target 0).
        """


class _RetrievalAtK(RetrievalMetric, ABC):
    """A retrieval metric cut at the top ``k`` rows of each query (``k=None``: the whole query)."""

    def __init__(
        self,
        query_without_relevant_docs: str = "skip",
        exclude: int = IGNORE_IDX,
        k: Optional[int] = None,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        capacity: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(
            query_without_relevant_docs=query_without_relevant_docs,
            exclude=exclude,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            capacity=capacity,
            device=device,
        )
        self.k = _validate_k(k)
