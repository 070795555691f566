#!/usr/bin/env python3
"""Drive metrics_tpu_torch's main path on one CUDA card and hold every kernel to its plain version.

Run from the repository root, with one GPU:

    python3 chip_smoke.py

Phases, in order; each raises on failure and none is caught:

1. Device line: the card's name and ``nvidia-smi`` name and power limit.
2. Build kernel K1 (``metrics_tpu_torch/csrc/binned_counts.cu``) with nvcc
   from the checkout and print the build seconds.
3. K1 against its plain PyTorch version and an independent numpy oracle
   (sorted scores + ``searchsorted``) at N = 4,194,304, T = 2,048 and at
   N = 4,194,303, T = 2,047 with shuffled, duplicate and infinite thresholds
   and NaN / +-inf scores, with the grid ranked once (one launch a call) and
   unranked (the wrapper ranks it on the card with ``torch.sort``). Bool
   weights must match exactly, float weights to rtol 1e-5. Times the kernel
   and the plain version with CUDA events, the host enqueue per call with the
   card held busy, and the yardstick ``torch_ops_ms`` (``searchsorted`` +
   weighted ``bincount`` + reverse ``cumsum``, which the port never calls);
   ``torch.profiler`` must show one device operation per call and no fill (three sessions, each after a warm-up
   step: the profiler can drop a kernel's record, never add one, so the most complete session is held to one a
   call and no session may show another operation).
4. Path A, the main path: ``MetricCollection([Accuracy, F1, Precision,
   Recall])`` (macro, C = 1,000, ``dist_sync_on_step``) inside a one-rank NCCL
   process group, 20 steps of 4,096 x 1,000 probabilities. Per-step values
   and the epoch compute are checked against the port on the CPU and against
   a numpy ``bincount`` confusion oracle.
5. Path B: ``MetricCollection([BinnedAUROC, BinnedAveragePrecision])`` with
   2,048 thresholds and ``dist_sync_on_step`` in the same group, 10 steps of
   4,194,304 binary scores. K1's launch count must rise by exactly 2 per step,
   and a profiled extra step must show 2 K1 kernels and no sort (the
   thresholds are ranked once per grid, not per step; the most of three sessions).
   Counts are checked exactly against the numpy oracle and the plain version
   on the card; AUROC / AP to rtol 1e-5.
   Path A's epoch ``compute()`` is one ``all_reduce`` per compute group
   (2: Accuracy alone, F1 / Precision / Recall together), and a
   ``CompositionalMetric`` ``(F1 + Precision) / 2`` fed path A's batches
   equals the arithmetic of its parts on the card.
6. Path C, the exact curves: ``MetricCollection([AUROC, AveragePrecision])``
   (binary, ``pos_label=1``, no ``dist_sync_on_step``) in the same group,
   3 steps of 4,194,304 float32 scores (about 10% positives, tied scores,
   made by a seeded numpy generator), once with list states and once with
   ``capacity=16,777,216`` (PaddedBuffer states). The epoch syncs at
   ``compute()`` through the cat-state gather. Per-step and epoch values of
   both modes are held against a numpy float64 oracle (rank-based AUROC with
   ties counted half, AP as the step integral over the distinct thresholds)
   to rtol 1e-5, and the two modes against each other to the same tolerance.
   A ``ROC`` of the first batch gives exactly the oracle's distinct
   thresholds, fpr / tpr to rtol 1e-6. Prints forward ms per step, epoch
   ``compute()`` ms, the collective calls of the epoch sync and the sort's
   share of a profiled epoch compute. Path C runs no hand-written kernel.
7. Path D, the rest of classification, in the same group with
   ``dist_sync_on_step`` and ``device="cuda"`` (no CPU fallback, nothing
   caught). D1 at path A's batch and ImageNet-1k's classes:
   ``MetricCollection([ConfusionMatrix, IoU, CohenKappa, MatthewsCorrcoef,
   Specificity (macro), HammingDistance, ExactMatch, CalibrationError (15
   bins), HingeLoss])``, 20 steps of 4,096 x 1,000 float32 probabilities
   (seeded numpy logits, 2 x N(0, 1) with the true class raised by 8: top-1
   about 77%, confidence spread over every bin). D2 at MS-COCO's 80
   categories: ``MetricCollection([CoverageError, LabelRankingAveragePrecision,
   LabelRankingLoss, CriticalSuccessIndex(0.5)])``, 10 steps of 4,096 x 80
   multilabel scores (about 2.9 true labels a row, scores on a 2**-8 grid, so
   tied). The epoch confusion matrix equals a numpy ``bincount`` oracle
   exactly, every count state equals the CPU run's, and every per-step and
   epoch value equals the CPU run and a float64 numpy oracle to the stated
   tolerances. Each step makes one update per compute group of the CPU run,
   and the epoch ``compute()`` one sync per group: one ``all_reduce`` per
   state dtype of the group (a group holding float32 sums and int64 counts
   makes two). Prints ms per step and epoch ``compute()`` ms, and a profiled step:
   its device time and operations (``torch.profiler``) and its synchronizing CUDA
   calls (``torch.cuda.set_sync_debug_mode``). Path D runs no
   hand-written kernel: its counting is torch ops (``bincount``,
   ``index_add_``, elementwise compares, an einsum), as the JAX package's is
   XLA, so it adds nothing to the ``kernels`` line.
8. Path E, regression, in the same group with ``device="cuda"`` (nothing caught). E1: the error,
   moment and correlation collection (MSE, MAE, MSLE, MAPE, SMAPE, WMAPE, ExplainedVariance,
   R2Score, RelativeSquaredError, PearsonCorrcoef, ConcordanceCorrCoef, MinkowskiDistance(p=3),
   LogCoshError, TweedieDevianceScore(power=1.5)) with ``dist_sync_on_step``, 10 steps of
   4,194,304 float32 pairs (lognormal targets, predictions within exp(0.1 N(0, 1)) of them): an
   epoch of 41,943,040 samples, past 2**24, so Pearson's float32-count warning fires and the int64
   counts are checked. E2: ``MetricCollection([KLDivergence, CosineSimilarity])``, 10 steps of
   4,096 x 1,000 softmax rows. E3, synced at ``compute()``: ``SpearmanCorrcoef`` over 2 steps of
   4,194,304 scores (an epoch of 2**23) and ``KendallRankCorrCoef`` over 4 steps of 4,096 (an epoch
   of 16,384), scores on a 2**-12 grid (tied), each with list states and with ``capacity``. E4, with
   TF32 allowed for convolutions and matmuls (the user's default), the image collection (SSIM,
   MultiScaleSSIM and PSNR at ``data_range=1.0``, UQI, TotalVariation of the prediction,
   SpectralAngleMapper, ERGAS) with ``dist_sync_on_step``, 10 steps of 16 x 3 x 512 x 512 images
   (a smooth seeded field and the same plus N(0, 0.05^2) noise, clipped to [0, 1]), then 2 steps of
   ``SSIM()`` whose stored 4-D images are gathered at ``compute()``. Every count state equals the
   CPU run of the port exactly; every value equals the CPU run and a float64 numpy / scipy oracle
   (``np`` sums, ``scipy.stats.spearmanr`` / ``kendalltau``, SSIM by ``scipy.ndimage.correlate1d``
   with ``mode="mirror"``) to the tolerances stated below. E4's CPU run repeats the first 2 steps
   (the full 10 take minutes on the host); the oracle holds every step and the epoch. Each step makes
   one update per compute group, and the epoch ``compute()`` one sync per group. Prints ms per step,
   epoch ``compute()`` ms and a profiled E1 and E4 step. E4's SSIM, MS-SSIM and UQI run kernel K2
   (``csrc/ssim_filter.cu``, 7 launches a step, no plain filter on the card); K2 alone is then held to
   the plain version on the card at E4's shapes (maps bit for bit at every MS-SSIM scale) and timed
   beside its float32 bound and the plain version. K2 replaces no Pallas kernel: the JAX package
   computes SSIM in XLA. The ``kernels`` line lists K1 and K2.
9. Path F, retrieval, in the same group with ``device="cuda"`` (nothing caught), at MS MARCO passage
   ranking's size (its dev re-ranking task: 6,980 queries x a first-stage retriever's top 1,000, rounded
   to 7,168 x 1,000): ``MetricCollection([RetrievalMAP, RetrievalMRR("neg"), RetrievalPrecision(k=10),
   RetrievalRecall(k=100), RetrievalHitRate(k=10), RetrievalFallOut(k=10), RetrievalRPrecision,
   RetrievalNormalizedDCG(k=10)])``, one compute group, over 28 steps of 256,000 rows (sparse int32 query
   ids, ~15% of the queries with no relevant candidate, grades 1-3, tied scores on a 2**-12 grid, 16 NaN
   scores, 0.5% exclude sentinels; the query-ordered epoch rotated by 500 rows, so a query straddles every
   step boundary), once with list states and once with ``capacity=8,388,608``, gathered at ``compute()``.
   Per-step values of both modes equal the CPU run (steps 0-1) and a float64 numpy oracle (every step),
   the epoch values both, and the per-query integer quantities (relevant rows, hits in the top 10 and 100,
   first-hit ranks) equal the CPU run and the oracle exactly. One update a step, one gather for the group
   at the epoch (a layout, an int32 and a float32 ``all_gather``), and the profiled list-mode epoch
   compute makes no synchronizing call but the gather's two. Prints ms per step, epoch ``compute()`` ms,
   each mode's profiled epoch (device ms, the sort kernels' share, operations, synchronizing calls) and
   peak device memory. Path F runs no hand-written kernel: the JAX package computes retrieval in XLA.
10. Path G, the mergeable sketch states, in the same group with ``device="cuda"`` and ``dist_sync_on_step``
   (nothing caught). G1: ``MetricCollection([AUROC, AveragePrecision, ROC, PrecisionRecallCurve])`` with
   ``approx="sketch"`` and 2,048 bins (one compute group) over path B's 10 batches of 4,194,304 scores, then
   AUROC and AveragePrecision with ``approx="qsketch"`` on their logits. G2: AUROC (macro) and AveragePrecision
   with ``approx="sketch"`` and ``num_classes=1000`` over path A's 20 batches: a ``(1000, 2, 2048)`` int64 state
   (32.8 MB) reduced every step. G3: Spearman and Kendall with ``approx="sketch"`` (512 bins, the range-free
   grid) and with ``approx="qsketch"``, over E1's 10 steps of 4,194,304 lognormal pairs. G4: ``Quantile(q=(0.5,
   0.9, 0.99, 0.999))`` and ``Percentile(p=(50, 99, 99.9))`` (one group) over 10 steps of 4,194,304 request
   latencies in seconds (lognormal, 20 ms median, sigma 1, 0.1% outliers at 50x, exact zeros, 16 NaN and 4
   +inf a step), and ``MedianAbsoluteError`` over E1's pairs. G5: a count-min state of ``CMSTail``'s default
   grid (4 x 4,096, seed 29) declared through ``add_state`` in a metric of this script, fed 10 steps of
   1,048,576 int keys drawn Zipf(1.1) over 1,000,000 distinct keys, hashed and bucketed on the host and
   scattered on the card. Every count state equals the port's CPU run and a numpy ``bincount`` oracle bit for
   bit (the qsketch grids against their float64-exact buckets); AUROC / AP / ROC / PR equal float64 numpy over
   the oracle counts to rtol 1e-6 and Spearman / Kendall to rtol 1e-5, per step and at the epoch; the exact
   AUROC of G1's epoch (path C's rank oracle) lies within each sketch's ``error_bound()``; each quantile lies
   within its ``error_bound()`` of the sample the sketch's rank selects (``np.quantile(..., method="lower")`` of
   the non-NaN samples) and within relative alpha of ``np.quantile`` of the finite samples; each key's min-row count-min estimate is at least its true count. Each step makes one
   update per compute group and one ``all_reduce`` per (dtype, op) bucket of its packed sync, the epoch one
   ``all_reduce`` per group, and a profiled step
   of G1-G4 makes no synchronizing CUDA call. Prints ms per step, epoch ``compute()`` ms, a profiled step's
   device ms, operations and scatter ms, and each state's bytes beside the exact mode's for the
   same epoch. Path G runs no hand-written kernel: the JAX package updates its sketches with XLA scatter-adds.
11. Path H, in the same group with ``device="cuda"`` (nothing caught), the families the JAX package computes
   in XLA at their users' sizes, data from seeded numpy generators (nothing downloaded). H1, COCO val2017's
   evaluation: ``MeanAveragePrecision(num_classes=80, max_detections=100, class_metrics=True)`` over 5,000
   images in updates of 8 (ground truths 7.3 an image, geometric, one image of 64; about 1% crowd; areas
   log-uniform over small, medium and large; 100 detections an image: jittered copies and duplicates of the
   ground truths and background false positives, scores on a 2**-12 grid), synced at ``compute()``: every
   key equals the port's CPU run (rtol 1e-6) and the match flags equal it bit for bit; over the first 500
   images every key equals a loop-wise numpy pycocotools replica (rtol 1e-5); the epoch compute's peak
   device memory stays under 8 GiB. H2, WSJ0-2mix's test set: ``MetricCollection({SNR, SI_SDR, SI_SNR,
   PIT(si_snr, "max")})`` with ``dist_sync_on_step`` over 3,000 mixtures of 2 sources x 32,000 samples in
   47 batches of 64, estimates the sources swapped for half the batch plus noise at 0-20 dB; H2b ``PIT``
   over 10 batches of 64 x 3 sources: every value equals the CPU run and a float64 numpy oracle (rtol 1e-5,
   atol 1e-4 dB), PIT's permutation the oracle's wherever its best two scores differ by more than 1e-3 dB.
   H3, k-means of ImageNet-1k scored against its 1,281,167 train labels: the nine extrinsic and four
   nominal scores at 1,000 x 1,000 with ``dist_sync_on_step`` (78 steps of 16,384 and one of 3,215; no
   compute group, as in the JAX package): every contingency equals a numpy ``bincount`` bit for bit, the
   closed forms numpy float64 (rtol 1e-6), the epoch AMI the port's CPU float64 run, and the AMI of the first
   131,072 labels a ``scipy.special.gammaln`` EMI oracle. H4, ResNet-50 features of ImageNet val:
   ``CalinskiHarabaszScore`` and ``DaviesBouldinScore`` (list and ``capacity=``) over 50,000 x 2,048 float32
   Gaussian blobs around 1,000 centres: equal to the CPU run (rtol 1e-5) and sklearn's formulas in float64
   (rtol 1e-4), the same bits with TF32 allowed and not. H5: the four pairwise matrices (8,192 x 4,096 x
   2,048) and ``embedding_similarity`` with each reduction and ``zero_diagonal``, held on 128 rows to the CPU
   run and numpy float64, the same bits with TF32 allowed and not; ``image_gradients`` of E4's images equal
   bit for bit. Prints ms per step, epoch ms, a profiled step's device share and peak device memory. Path H
   runs no hand-written kernel: the JAX package computes these families in XLA, never Pallas.
12. Path I, the text family, in the same group with ``device="cuda"`` (nothing caught), data from seeded numpy and
   ``torch.Generator`` sources (nothing downloaded; the datasets give the sizes). I1, LM evaluation at Llama 3's
   vocabulary: ``Perplexity(ignore_index=-100)`` with ``dist_sync_on_step`` over 30 steps of bf16 logits (4, 2,048,
   128,256) made on the card, each target's logit raised (perplexity ~20), ~3% of the targets -100: 245,760 tokens,
   about WikiText-103's test set. Every step and the epoch equal a float64 ``logsumexp`` oracle on the card (rtol
   1e-5), step 0 the port's CPU run; one update and two ``all_reduce`` a step; the peak device memory of a step stays
   under 2 GiB above the logits. I2, ASR evaluation at LibriSpeech test-clean's size (2,620 utterances, 52,576
   reference words over a Zipf vocabulary, ~5% word errors): WER, CharErrorRate, MatchErrorRate, WordInfoLost,
   WordInfoPreserved and EditDistance with ``dist_sync_on_step`` in batches of 64, and the same utterances as padded
   ids through ``edit_distance_padded`` and ``WER.update_counts``: every distance equals a plain Python DP, the word
   states its (distance, hits) DP, every value the CPU run. I3, MT evaluation at WMT14 En-De newstest2014's size
   (3,003 sentences, one reference, punctuation, numbers and ``&quot;`` entities): SacreBLEU (13a), BLEU, chrF and
   TER in batches of 64, synced at ``compute()``: BLEU's counts equal ``Counter`` n-grams, chrF's statistics
   ``Counter`` character n-grams, the states the CPU run (TER's after its first 8 batches: the host shift search is
   cut there and the cut is printed). I4: ROUGE-1/2/L over CNN/DailyMail test's 11,490 pairs (~56-word references;
   every batch's LCS runs on the card), the LCS equal to a plain Python DP on 640 pairs and to the CPU run on all,
   and SQuAD over v1.1 dev's 10,570 questions, both against a float64 oracle (rtol 1e-5) and the CPU run. Prints
   ms per step, epoch ms, profiled steps of I1 and I2 and I1's peak memory. Path I runs no hand-written kernel: the
   JAX package computes its DPs, BLEU counts and log-softmax in XLA, never Pallas.
13. Path J, the pure view, the keyed slab and the wrappers, in the same group with ``device="cuda"`` (nothing
   caught), at a multi-tenant deployment's size (per-tenant metrics over 10,000 tenants, the JAX package's
   ``bench.py`` keyed scenario), data from seeded numpy: 20 steps of 65,536 samples whose tenant ids follow
   Zipf(1.1) over the tenants through a seeded permutation (16 tenants never drawn) plus 32 ids out of range a
   step. J1 ``Keyed(AUROC(approx="sketch"), 10,000)`` with ``dist_sync_on_step`` (a 327.7 MB slab): counts equal a
   numpy ``bincount`` over (tenant, label, bin) and the CPU run (first 2 steps) bit for bit, per-tenant AUROC float64
   from the oracle counts (rtol 1e-5), empty tenants NaN, 640 dropped samples counted, each step's collective
   calls the unkeyed metric's. J2 ``Keyed(Quantile(q=0.99), 10,000)`` over request latencies: counts equal a
   float64 ``searchsorted`` oracle and the CPU run, 8 tenants' p99 an unkeyed Quantile fed only their values. J3
   ``Keyed(Accuracy(), 1,000)`` over path A's batches: per-cohort correct / total equal numpy. J4
   ``HeavyHitters(AUROC(approx="sketch"), 256 hot, (4, 1,024) tail)`` over Zipf(1.1) keys from 1,000,000: hot +
   tail mass conserved bit for bit, exact keys equal the oracle, tail reads within their certificate, the card equal
   to the CPU run. J5 ``BootStrapper(AUROC(approx="sketch"), 100 copies)`` over 10 steps: per-copy counts equal
   numpy on the same ``RandomState`` draws, mean / std float64 (rtol 1e-5). J6 Running, MetricTracker,
   ClasswiseWrapper, MinMaxMetric and MultioutputWrapper equal the arithmetic of their unwrapped parts. J7
   ``AUROC(approx="sketch").pure()`` (init, update, ``sync(state, group)``, compute) equals the stateful metric
   bit for bit. Prints each part's ms per step, device share, synchronizing calls of a profiled step, collective
   calls a step and peak bytes above the state (J1 and J2 within 1 GiB). Path J runs no hand-written kernel: the
   JAX package's slab scatter is ``jax.ops.segment_sum``, its per-sample deltas ``jax.vmap``, never Pallas.
14. Path K, the windowed plane and the rest of ``MetricCollection``, in the same group with ``device="cuda"``
   (nothing caught), at a serving deployment's size (the JAX package's ``bench.py`` windowed scenarios), event times
   from seeded numpy. W1 ``Windowed(AUROC(approx="sketch"), window_s=60, num_windows=4, allowed_lateness_s=180)`` with
   ``dist_sync_on_step``: 24 steps of 65,536 events, the clock 20 s a step (8 windows, 5 rolls), 5% of the events late
   by U(0, 150) s, 0.5% by U(250, 400) s (always dropped). W2 sliding windows (``window_s=6, slide_s=2,
   num_windows=6, allowed_lateness_s=4``) over ``Accuracy``: 20 steps, the clock 1 s a step, 3% late within 4 s, 0.5%
   10-30 s late; every event scatters into 3 ring rows. W3 ``Windowed(MeanSquaredError(), decay_half_life_s=30)``: 20
   steps, 2% out of order. W4 ``Windowed(Keyed(Accuracy(), 1,000))`` over path A's batches, Zipf cohorts, 16 ids out
   of range a step. Every resident window's counts (W4: per cohort) equal a numpy oracle router written here from
   the open rule, bit for bit, and so do the drop, late and ``slab_dropped_samples`` counts; each window's
   ``compute_window`` equals an unwindowed metric fed exactly that window's events on the card; the first 2 steps
   equal the port's CPU run; W1 makes one ``all_reduce`` a step, as the unwindowed metric. W3 is within rtol 1e-5 of
   a float64 closed form. W5: two ranks of one ``WatermarkAgreement(deadline_s=0.5)``, one 90 s behind: windows stay
   open for it, late verdicts follow the agreed clock, a silent rank is excluded past the deadline (``wm_stragglers``
   + 1) and rejoins. W6: the main collection's pure view (2 entries; one ``all_reduce`` a step, one a (dtype, op)
   bucket, as the stateful step's packed sync), ``forward_batched`` over path A's 20 stacked batches (path A's per-step values bit for bit) and
   ``clone(prefix="b_")``. Prints each part's ms per step, a profiled step's device ms, share, operations and
   synchronizing calls, collective calls and peak bytes above the state. Path K runs no hand-written kernel: the
   JAX package's routing is host numpy and its scatters ``segment_sum``, never Pallas.
15. Path L, the guarded and deferred sync plane, in the same group with ``device="cuda"`` (nothing caught), at path
   A's size and W1's. L1: path A's collection with ``sync_lag`` 1 and 2 (every member): each step's values equal the
   synchronous run's ``k`` steps back bit for bit, the epoch after the drain equals the synchronous epoch; ms/step,
   collectives a step and a profiled step's synchronizing calls beside the synchronous run's, and
   ``sync_lag="auto"`` with the lags its controllers chose. L2: the same collection under chaos schedules: a
   transient drop x2 (``sync_retries`` 2, values bit-equal), a corrupt payload under ``check_finite=True`` (retried,
   bit-equal), a persistent drop under ``policy="degrade"`` (local values, ``degraded_computes``) and ``"raise"``
   (``SyncTimeoutError``), and a deadline (async NCCL work, polled). L3: ``Windowed(MeanSquaredError())`` over W1's
   stream and ``Keyed(MeanSquaredError(), 10,000)`` over J1's tenants, one NaN-poisoned batch each: under
   ``check_finite="quarantine"`` the slabs equal a run without it bit for bit (``quarantined_updates`` + 1), under
   ``"raise"`` it raises ``StateCorruptionError``, and ``state_integrity_counts`` of a corrupted state equals the
   CPU's; J1 itself (``Keyed(AUROC(approx="sketch"))``) takes NaN scores with clean counts (its binning drops them).
   L4: path A checkpointed at step 10 through ``state_dict``, restored and replayed with ``guarded_update`` from
   step 7: equal to the unbroken run bit for bit; a straddling span raises ``ValueError``. L5: the collection's
   pure view, ``sync_state(deferred=True)`` against the synchronous sync while the live state is written in place.
   L6: two Gloo processes of this script (``--l6-worker``), one 90 s behind, one ``WatermarkAgreement`` each: the
   exchange agrees on the minimum, holds the fast rank's windows open, excludes the silent rank past its deadline and
   lets it rejoin. Path L runs no hand-written kernel: the JAX package's guard, deferred and lag planes are host
   logic and collectives.
16. Path M, the topology-aware and sparse sync planes, in the same group (nothing caught). M1: J1's
   ``Keyed(AUROC(approx="sketch"), 10,000)`` (327.7 MB of state) through its ``sparse_plane(capacity=64)``, built at
   reset: 20 steps of 65,536 events over 64 hot tenants drawn anew each step (the JAX package's ``bench.py`` sparse
   scenario, touch = capacity = 64), one hinted round a step, then a 1,000-tenant step that must fall back and an
   empty step that must skip; every merged view bit-equal to the dense bucketed ``all_reduce`` of the same state, the
   first 2 to the CPU run; ms, bytes (bitmap, header and rows against the dense plane's), collectives and
   synchronizing calls a round, and the plane's memory above the slab. M2: J4's ``HeavyHitters(AUROC sketch, 256,
   (4, 1,024))`` over 1,000,000 Zipf keys (10 steps), capacity the hot tier: the tails ride the bitmap collective,
   hot and tail counts bit-equal to the dense sync. M3: W1's ``Windowed(AUROC sketch)`` ring (12 steps): windows
   bit-equal to the dense sync, at most 4 rows a round. M4: ``deferred_sparse_sync`` over M1's state equals the
   synchronous round. M5: path A's collection with a one-rank ``MeshHierarchy``: the flat plane over ``ici``, the
   flat step's ``all_reduce`` count (its packed sync), values bit-equal. M6: four Gloo processes of this script (``--m6-worker``), 2
   slices of 2, on the host: the two-stage sum and gather against the flat plane, the counters' bytes by crossing
   against the JAX package's formula, ``slice_leader_gather``, ``buffer_all_gather``, and 5 sparse rounds a plane
   over ``Keyed(AUROC sketch, 1,000)`` with each rank's own slots, flat (2 collectives a round) and two-level (4).
   M7: ``auroc`` over path C's first batch inside and outside the deferred-check window: synchronizing calls of
   each, equal values, equal errors on an all-positive and an all-negative target. Path M runs no hand-written
   kernel: the JAX package's hierarchy, bitmap, row exchange and fold are XLA collectives and elementwise work.
17. Path N, the sharded epoch, in the same group (nothing caught; no gather where a placement asked for the
   ring: every row-sharded compute runs with the port's ``buffer_values``, ``buffer_all_gather`` and ``host_gather``
   raising, and no gather fallback may warn). N1: path C's epoch (3 x 4,194,304 tied scores) in
   ``MetricCollection([AUROC, AveragePrecision])`` with ``capacity=16,777,216`` placed with ``row_sharded()``: the
   ring's values equal path C's gathered compute and its float64 oracle (rtol 1e-5), with 0 gather collectives;
   epoch ms, peak bytes, collectives and synchronizing calls of both. N2: 1,000-class AUROC (macro) and AP over path
   A's 20 steps (``capacity=81,920``: a (3, 1,000, 81,920) pack of ~1 GB): the gathered compute and a per-class numpy
   oracle (rtol 1e-5); an absent class gives ``nan``. N3: ``ROC`` / ``PrecisionRecallCurve`` of path C's first
   batch through ``sharded_clf_curve_matrix``: the oracle's distinct thresholds exactly, rates within rtol 1e-6. N4:
   E3's Spearman and Kendall epochs on the ring against E3's gathered values and scipy (E3's tolerances). N5: path
   F's eight retrieval metrics (``capacity=8,388,608``) through the regroup: path F's gathered epoch values (rtol
   1e-6), 4 ``all_to_all`` a member (one a payload), no row dropped; a skewed run with ``regroup_capacity=1,024``
   raises. N6: four Gloo processes of this script (``--n6-worker``, started first, read last, CPU): the ring (3
   hops) for binary and 16-class AUROC / AP, the curve, Spearman and Kendall, the regroup over 4 destinations for
   RetrievalMAP / MRR, their 2 x 2 hierarchical forms, and ``class_sharded`` over 2 x 2 for path A's collection,
   every rank against one process's unsharded port (int64 bit for bit, floats to 1e-6) and the collectives against
   the port's formula. N7: ``device_put(cuda)`` of a CPU-built collection, ``batch_sharded`` on one rank, the
   placement after ``reset()``, ``class_sharded`` on a one-rank hierarchy (counts bit-equal). Path N runs no
   hand-written kernel: the JAX package's engines are XLA (``ppermute``, ``all_to_all``, ``searchsorted``,
   ``argsort``, ``segment_sum``), not Pallas; on one card the ring makes no hop.
18. Path O, observability (``metrics_tpu_torch/observability/``), in the same group over paths A and B. O1: path
   A's collection over its 20 batches with observability off, with spans and counters (``enable()``) and fenced
   (``enable(device_time=True)``), each leg twice, in turns forward and back: per-step values and the epoch equal
   path A's bit for bit in every run; the span counts a step are one ``collection.group_update`` a shared compute
   group, one ``collection.step_sync`` (the members' packed sync), one ``metric.forward`` a singleton, one
   ``metric.compute`` a member and no ``metric.sync_state`` (at the epoch one ``collection.host_sync`` a shared
   group and one ``metric.sync_state`` a singleton);
   ``summarize()`` has ``state_bytes`` and, fenced, ``device_ms`` on every phase; ``device_time_table()`` has a row
   a compute group (``update`` and ``sync`` for a shared group, ``forward`` and ``sync`` for a singleton);
   ``counters_snapshot()`` has the JAX schema's keys and one ``psum`` a (dtype, op) bucket of the packed sync a
   step; ``write_chrome_trace`` loads
   with one ``X`` event a span. Prints each leg's ms/step, the overheads, and whether the off leg's median lies
   within path A's per-step spread in this call (host-bound: printed, not held). O2: path B's first 4 steps,
   fenced, under ``start_trace`` / ``stop_trace``: K1 launched 2 times a step, counts bit-equal to path B's,
   ``from_profiler_trace`` gives the ``metric.forward`` phase (the binned members update inside their fused
   forward) nonzero device ms, and every K1 ``count_kernel`` the trace records lies inside an update scope on the
   device timeline; prints the fenced forward device ms beside K1's phase-3
   ms. O3: a child process of this script (``--o3-worker``, K1 already built) enables compile telemetry and runs
   one path-B step twice: one cache hit and no miss, ``compiled=yes`` on the first update span and ``no`` on the
   later ones. O4: W1's ``Windowed(AUROC sketch)`` ring over its first 6 steps with ``lifecycle_label`` set: the
   ledger stamps ``first_event`` / ``last_event`` for exactly the windows a numpy router says the batches touch;
   the closed windows are stamped through ``published`` as a serving loop would, and the ``lifecycle`` and
   ``selfmeter`` gauges appear in ``counters_snapshot()``; path A's collection with ``deferred_epoch_sync=True``
   computes the synchronous epoch with the same ``all_reduce`` count. Path O runs no hand-written kernel but K1:
   the JAX observability planes are host Python and ``jax.profiler`` / ``jax.monitoring`` hooks, not Pallas.
19. Path P, the serving plane, in the one-rank NCCL group after path O. P1: a ``MetricService`` over W1's
   stream (24 batches of 65,536 events) into ``Windowed(AUROC sketch, 60 s, 4 windows, 180 s lateness)`` without
   ``dist_sync_on_step``, the deferred publish stage on (every publish's merged view an ``all_reduce`` on the host
   plane's worker) and a ``RetentionStore`` attached: every published window's (label, bin) counts equal a numpy
   router's ``bincount`` bit for bit and its value AUROC over those counts, the final merged value equals path K's
   W1 epoch, the synchronous stage is bit-equal, and the first 2 batches publish the CPU run's partials; prints
   batches/s, events/s, the lifecycle e2e ms a window and the queue and publish-pipeline high-water marks. P2:
   W1's first 4 steps in batches of 512 events behind the processing lock: coalescing on bit-equal to off, spans
   printed. P3: a seeded late burst, ingest stall and persistent sync drop (every publish degraded), then a preempt
   at ingest call 9, ``restore`` and a replay with 2 batches of overlap: bit-equal to the run not interrupted. P4:
   an 8-shard ``MetricFleet`` of ``Windowed(Accuracy)`` over 96 tenant batches of 8,192 (``bench.py``'s fleet
   topology): merged records bit-equal to one service over the union with no shard recovered, and again with a
   shard killed and recovered (only that run catches the preempt it injected);
   a ``HeavyHitterFleet`` over G5's first 2 steps of Zipf(1.1) keys against ``np.bincount``. P5: the store's
   queries on ``bench.py``'s ladder shape at W1's stride bit-equal to hand merges of P1's raw partials, and one
   ``GET /metrics`` of an ``ExpositionServer`` parsed back. Every service, fleet and server is stopped and the host
   plane drained before the group is destroyed. No kernel but K1: the JAX serving plane is host Python.
20. The ``kernels`` JSON line, then the device JSON as the last line.

Exits non-zero, printing no result, when CUDA is unavailable or the package
is not beside this script.
"""
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM non-tensor float32 peak, NVIDIA data sheet
K1_N, K1_T = 4_194_304, 2_048
K1_PROFILE_SESSIONS = 3  # profiled sessions of K1's device operations (phase 3) and of path B's step
A_STEPS, A_BATCH, A_CLASSES = 20, 4_096, 1_000
B_STEPS, B_N, B_T = 10, 4_194_304, 2_048
C_STEPS, C_N, C_CAPACITY = 3, 4_194_304, 16_777_216
D1_STEPS, D_BINS = 20, 15  # D1 runs at path A's batch and class count
D2_STEPS, D2_BATCH, D2_LABELS = 10, 4_096, 80
RTOL_CURVE = 1e-6  # ROC points against the float64 oracle: one float32 division each
RTOL_FLOAT = 1e-5  # float-weight counts and binned AUROC / AP: sums in another order
RTOL_CLASS = 1e-6  # classification values, card against CPU: a mean in another order
RTOL_ORACLE = 1e-5  # float32 values against the float64 numpy oracle
# Path D, card against CPU and both against the float64 oracle: float32 sums over up to
# 10^6 terms in another order (kappa's C*C products, per-bin confidence sums added with
# atomics on the card, hinge and ranking totals) stay within a few ulps times log2(terms)
RTOL_D = 1e-5
# Hamming is 1 - correct / (N * C) with both counts rounded to float32 (the epoch's
# 8.2e7 exceeds 2**24): a few ulps of 1.0 absolute, not relative to a value near 6e-4
ATOL_HAMMING = 4 * 2.0**-24
E_STEPS = 10
E1_N = 4_194_304  # path B's batch; a power of two keeps the float32 counts the reference carries exact (2**22 k)
E2_BATCH, E2_DIM = 4_096, 1_000  # path A's batch
E3_SPEARMAN = (2, 4_194_304)  # steps, batch: an epoch of 2**23, where every rank and half-rank is exact in float32
E3_KENDALL = (4, 4_096)  # an epoch of 16,384 samples: 134 million pairs
E4_SHAPE = (16, 3, 512, 512)  # 512 x 512 RGB crops, as restoration and super-resolution evals score them
E4_STORED_STEPS = 2  # SSIM() without data_range: the stored-image mode
E4_CPU_STEPS = 2  # E4 steps the CPU run repeats; the float64 oracle holds every step
# Path E, card against CPU and both against the float64 oracle: float32 sums over up to 4M terms a step
# in another order, and R2 / ExplainedVariance / RSE from float32 raw moments (lognormal targets:
# E[t^2] / Var t = 1.6, so the cancellation costs one bit)
RTOL_E = 1e-5
RTOL_KENDALL = 1e-6  # tau from exact int64 pair counts, rounded once to float32
RTOL_E4 = 1e-5  # PSNR, TV, SAM, ERGAS: float32 sums over 12.6M terms a step in another order
# SSIM, MS-SSIM and UQI keep the reference's float32 moment maps, var = E[x^2] - mu^2: second moments of
# ~0.3 carry absolute errors of ~1e-7, against a denominator var_p + var_t + C2 that may be as small as
# C2 = 9e-4 on the smooth target, so a value in [0, 1] is held to 1e-4 absolute
ATOL_SSIM = 1e-4
# Path F: MS MARCO passage ranking's dev re-ranking task (6,980 queries x the top-1,000 candidates of a
# first-stage retriever), rounded to 7,168 queries; the epoch in 28 steps of 256,000 rows
F_QUERIES, F_CANDIDATES = 7_168, 1_000
F_STEPS, F_BATCH = 28, 256_000
F_ROTATE = 500  # rows the query-ordered epoch is rotated by, so that a query straddles every step boundary
F_CAPACITY = 8_388_608
F_NAN = 16
F_CPU_STEPS = 2  # steps the CPU run repeats per step; it holds the epoch too
# Path F, card against CPU: the same int64 counts, float32 divisions of them, per-query float64 scans
# rounded to float32 and a float32 mean over 7,168 queries in another order
RTOL_F = 1e-6
# against the float64 numpy oracle: the float32 roundings of the above, a few ulps
RTOL_F_ORACLE = 1e-5
# Path G: the sketch states at path A's, path B's and E1's sizes, latency quantiles and a count-min tail
G_STEPS = 10  # G1 runs on path B's batches (B_STEPS of them), G2 on path A's
G2_STEPS = A_STEPS
G_BINS, G_RANK_BINS = 2_048, 512
G4_N = 4_194_304
G4_Q, G4_P = (0.5, 0.9, 0.99, 0.999), (50, 99, 99.9)
G5_N, G5_KEYS = 1_048_576, 1_000_000
# curve values from equal counts by float64 math rounded once to float32, against float64 numpy over the same counts
RTOL_G_CURVE = 1e-6
RTOL_G_RANK = 1e-5  # Spearman / Kendall from equal joint counts, the tolerance path E holds the exact modes to


def _check(ok, what):
    if not ok:
        raise AssertionError(what)
    print(f"  ok: {what}")


def _oracle_counts(scores, positive, thresholds):
    """Exact (tp, fp) per threshold: count of positive / negative scores >= each threshold."""
    keep = ~np.isnan(scores)
    pos, neg = np.sort(scores[keep & positive]), np.sort(scores[keep & ~positive])
    tp = len(pos) - np.searchsorted(pos, thresholds, side="left")
    fp = len(neg) - np.searchsorted(neg, thresholds, side="left")
    return tp.astype(np.int64), fp.astype(np.int64)


def _curve_values(tp, fp, n_pos, n_neg):
    """(AUROC, AP) in float64 from per-threshold counts, the port's formulas."""
    tp, fp = tp.astype(np.float64), fp.astype(np.float64)
    fn, tn = n_pos - tp, n_neg - fp
    tpr, fpr = tp / np.maximum(tp + fn, 1), fp / np.maximum(fp + tn, 1)
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 has only trapz
    auroc = -trapezoid(tpr, fpr)
    precision = np.where(tp + fp == 0, 0.0, tp / np.where(tp + fp == 0, 1, tp + fp))
    recall = np.where(tp + fn == 0, 0.0, tp / np.where(tp + fn == 0, 1, tp + fn))
    return auroc, -np.sum((recall[1:] - recall[:-1]) * precision[:-1])


def _confusion_values(conf):
    """Accuracy and macro F1 / precision / recall in float64 from a confusion matrix."""
    tp = np.diag(conf).astype(np.float64)
    fp, fn = conf.sum(0) - tp, conf.sum(1) - tp
    prec = np.where(tp + fp == 0, 0.0, tp / np.maximum(tp + fp, 1))
    rec = np.where(tp + fn == 0, 0.0, tp / np.maximum(tp + fn, 1))
    f1 = np.where(prec + rec == 0, 0.0, 2 * prec * rec / np.where(prec + rec == 0, 1, prec + rec))
    return {"Accuracy": tp.sum() / conf.sum(), "F1": f1.mean(), "Precision": prec.mean(), "Recall": rec.mean()}


def phase_device():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    return smi


def phase_build():
    from metrics_tpu_torch.ops.binned import launch_plan
    from metrics_tpu_torch.ops.build import KERNELS

    t0 = time.perf_counter()
    KERNELS.load("binned_counts", force=True)
    seconds = time.perf_counter() - t0
    print(f"[2] built binned_counts.cu for sm_90a in {seconds:.2f} s (nvcc {KERNELS.build_seconds['binned_counts']:.2f} s)")
    for line in KERNELS.build_log["binned_counts"].splitlines():
        if "Compiling entry" in line or "Used" in line:
            print("   ", line.strip())
    print(f"    launch plan at T={K1_T}, bool weights: {launch_plan(K1_T)}")
    return seconds


def _torch_ops(p, pos_f, neg_f, ranked):
    """The yardstick: the kernel's algorithm as PyTorch calls (the port never calls this)."""
    import torch

    sorted_thr, perm = ranked
    t = sorted_thr.shape[0]
    bins = torch.searchsorted(sorted_thr, p, right=True)
    hist = torch.stack([torch.bincount(bins, weights=pos_f, minlength=t + 1),
                        torch.bincount(bins, weights=neg_f, minlength=t + 1)])
    suffix = hist.flip(1).cumsum(1).flip(1)[:, 1:]
    out = torch.empty_like(suffix)
    out[:, perm.long()] = suffix
    return out


def phase_k1():
    import torch

    from metrics_tpu_torch.ops.binned import _binned_counts_torch, binned_counts_cuda, rank_thresholds
    from metrics_tpu_torch.tools.cuda_timing import device_breakdown, device_ms_cold, host_enqueue_us, ms_back_to_back

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    max_err = 0.0
    timings = {}
    cases = [
        ("main", K1_N, K1_T),
        ("edges", K1_N - 1, K1_T - 1),
    ]
    for label, n, t in cases:
        scores = rng.random(n, dtype=np.float32)
        thr = np.linspace(0.0, 1.0, t, dtype=np.float32)
        if label == "edges":
            scores[rng.choice(n, 3000, replace=False)] = np.repeat(np.float32([np.nan, np.inf, -np.inf]), 1000)
            thr[:4] = [-np.inf, np.inf, 0.5, 0.5]
            rng.shuffle(thr)
        positive = rng.random(n) < 0.3
        weights = rng.random(n, dtype=np.float32)
        p, y, th = (torch.from_numpy(x).to(dev) for x in (scores, positive, thr))
        w = torch.from_numpy(weights).to(dev)

        ranked = rank_thresholds(th)
        tp, fp = binned_counts_cuda(p, y, ~y, th, ranked=ranked)
        utp, ufp = binned_counts_cuda(p, y, ~y, th)
        torch.cuda.synchronize()
        ref_tp, ref_fp = _binned_counts_torch(p[:, None], y[:, None], ~y[:, None], th)
        torch.cuda.synchronize()
        _check(torch.equal(tp, ref_tp[0]) and torch.equal(fp, ref_fp[0]),
               f"K1 {label} N={n} T={t}: bool-weight counts equal the plain version exactly")
        _check(torch.equal(tp, utp) and torch.equal(fp, ufp),
               f"K1 {label}: the ranked-grid call equals the call that ranks on the card exactly")
        o_tp, o_fp = _oracle_counts(scores, positive, thr)
        _check(np.array_equal(tp.cpu().numpy(), o_tp.astype(np.float32))
               and np.array_equal(fp.cpu().numpy(), o_fp.astype(np.float32)),
               f"K1 {label}: bool-weight counts equal the numpy sort/searchsorted oracle exactly")

        ftp, ffp = binned_counts_cuda(p, w, 1 - w, th, ranked=ranked)
        torch.cuda.synchronize()
        rtp, rfp = _binned_counts_torch(p[:, None], w[:, None], (1 - w)[:, None], th)
        torch.cuda.synchronize()
        err = max((ftp - rtp[0]).abs().max().item(), (ffp - rfp[0]).abs().max().item())
        max_err = max(max_err, err)
        _check(torch.allclose(ftp, rtp[0], rtol=RTOL_FLOAT, atol=0) and torch.allclose(ffp, rfp[0], rtol=RTOL_FLOAT, atol=0),
               f"K1 {label}: float-weight counts within rtol {RTOL_FLOAT} of the plain version (max abs err {err:.3g})")
        if label == "main":
            flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
            neg = ~y

            def call():
                return binned_counts_cuda(p, y, neg, th, ranked=ranked)

            timings["ms"] = device_ms_cold(call, reps=30, flush=flush)
            timings["ms_back_to_back"] = ms_back_to_back(call, 100)
            timings["host_enqueue_us"] = host_enqueue_us(call)
            # the profiler can leave a kernel of a session unrecorded (18 of 20 once on the card), never add
            # one: three sessions, the one that recorded the most K1 launches is held to one a call, and no session
            # may record another device operation
            sessions = [device_breakdown(call) for _ in range(K1_PROFILE_SESSIONS)]
            ops = max(sessions, key=lambda rows: sum(r["per_call"] for r in rows))
            timings["device_ops"] = ops
            names = {r["name"] for rows in sessions for r in rows}
            _check(len(names) == 1 and ops[0]["per_call"] == 1 and "count_kernel" in ops[0]["name"],
                   f"K1 with the ranked grid is one device operation per call, no fill ({ops[0]['name'][:48]}...;"
                   f" recorded a call in {K1_PROFILE_SESSIONS} sessions:"
                   f" {[sum(r['per_call'] for r in rows) for rows in sessions]})")
            timings["plain_ms"] = device_ms_cold(
                lambda: _binned_counts_torch(p[:, None], y[:, None], neg[:, None], th), reps=5, flush=flush)
            pos_f, neg_f = y.to(torch.float32), neg.to(torch.float32)
            yard = _torch_ops(p, pos_f, neg_f, ranked).to(torch.float32)
            torch.cuda.synchronize()
            _check(torch.equal(yard[0], tp) and torch.equal(yard[1], fp),
                   "K1 main: the torch_ops yardstick computes the same counts")
            timings["torch_ops_ms"] = device_ms_cold(lambda: _torch_ops(p, pos_f, neg_f, ranked), reps=30, flush=flush)
    bytes_moved = K1_N * (4 + 1 + 1) + 4 * K1_T + 2 * 4 * K1_T
    ops = K1_N * int(np.ceil(np.log2(K1_T + 1)))  # one comparison per binary-search step per score
    timings["bound_ms"] = max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    timings["bound_by"] = "bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S else "operations"
    timings["max_abs_err"] = max_err
    print(f"[3] K1 at N={K1_N}, T={K1_T}: kernel {timings['ms']:.4f} ms (device, L2 cold, median of 30),"
          f" {timings['ms_back_to_back']:.4f} ms per call back to back (L2 warm, host enqueue included),"
          f" host enqueue {timings['host_enqueue_us']:.2f} us per call,"
          f" plain {timings['plain_ms']:.3f} ms, torch ops {timings['torch_ops_ms']:.4f} ms,"
          f" bound {timings['bound_ms']:.4f} ms ({timings['bound_by']})")
    for op in timings["device_ops"]:
        print(f"    device op per call: {op['name']} x{op['per_call']:g}, {op['us_per_call']:.2f} us")
    return timings


def _main_collection(device, compute_groups=True, **kw):
    import metrics_tpu_torch as pt

    return pt.MetricCollection([
        pt.Accuracy(device=device, **kw),
        pt.F1(num_classes=A_CLASSES, average="macro", device=device, **kw),
        pt.Precision(num_classes=A_CLASSES, average="macro", device=device, **kw),
        pt.Recall(num_classes=A_CLASSES, average="macro", device=device, **kw),
    ], compute_groups=compute_groups)


class _CountCollectives:
    """Counts ``torch.distributed`` all_reduce / all_gather calls while active."""

    def __enter__(self):
        import torch.distributed as dist

        self.counts = {"all_reduce": 0, "all_gather": 0}
        self._real = {name: getattr(dist, name) for name in self.counts}
        for name, fn in self._real.items():
            setattr(dist, name, self._counting(name, fn))
        return self.counts

    def _counting(self, name, fn):
        def call(*args, **kwargs):
            self.counts[name] += 1
            return fn(*args, **kwargs)

        return call

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._real.items():
            setattr(dist, name, fn)


def _packed_step_reduces(collection):
    """The ``all_reduce`` calls a step of ``collection`` makes when its ``dist_sync_on_step`` members share the
    packed step sync (``MetricCollection._step_sync_packs``), or one member syncs alone: one a (dtype, op) bucket of
    the deduplicated state, as ``sync_state`` of a fresh state makes them."""
    with _CountCollectives() as counts:
        collection.sync_state(collection.init_state())
    return counts["all_reduce"]


def _epoch_collectives(collection, batches):
    """The collective calls and the values of one epoch ``compute()`` after ``batches``."""
    for batch in batches:
        collection.update(*batch)
    with _CountCollectives() as counts:
        values = collection.compute()
    return counts, values


def _check_epoch_values(batches, values):
    """Epoch values on the card equal a CPU run's (outside the process group: a CPU metric cannot use NCCL)."""
    cpu = _main_collection("cpu")
    for preds, target in batches:
        cpu.update(preds.cpu(), target.cpu())
    for k, v in cpu.compute().items():
        if not np.isclose(values[k].item(), v.item(), rtol=RTOL_CLASS, atol=0):
            raise AssertionError(f"path A ungrouped epoch {k}: card {values[k].item()} vs CPU {v.item()}")


def _check_composition(device, batches):
    """``(F1 + Precision) / 2`` per step and at the epoch equals the arithmetic of its children exactly."""
    import metrics_tpu_torch as pt
    import torch

    f1 = pt.F1(num_classes=A_CLASSES, average="macro", device=device)
    prec = pt.Precision(num_classes=A_CLASSES, average="macro", device=device)
    composed = (f1 + prec) / 2
    for preds, target in batches:
        value = composed(preds, target)
        if not torch.equal(value, (f1._forward_cache + prec._forward_cache) / 2):
            raise AssertionError(f"path A composed step value {value.item()} differs from its parts")
    epoch = composed.compute()
    if not torch.equal(epoch, (f1.compute() + prec.compute()) / 2):
        raise AssertionError(f"path A composed epoch value {epoch.item()} differs from its parts")
    return epoch.item()


def _binned_collection(device, **kw):
    import metrics_tpu_torch as pt

    return pt.MetricCollection([
        pt.BinnedAUROC(thresholds=B_T, device=device, **kw),
        pt.BinnedAveragePrecision(thresholds=B_T, device=device, **kw),
    ])


def phase_paths():
    import torch
    import torch.distributed as dist

    from metrics_tpu_torch.ops.binned import binned_counts_cuda

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    a_batches = [
        (torch.softmax(torch.randn(A_BATCH, A_CLASSES, generator=gen, device=dev), dim=1),
         torch.randint(0, A_CLASSES, (A_BATCH,), generator=gen, device=dev))
        for _ in range(A_STEPS)
    ]
    b_batches = []
    for _ in range(B_STEPS):
        target = torch.rand(B_N, generator=gen, device=dev) < 0.3
        scores = torch.sigmoid(torch.randn(B_N, generator=gen, device=dev) + 1.5 * target)
        b_batches.append((scores, target.to(torch.int64)))
    torch.cuda.synchronize()

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        col_a = _main_collection(dev, dist_sync_on_step=True)
        binned_counts_cuda.launches = 0
        a_values, a_ms = _run_steps(col_a, a_batches)
        a_launches = binned_counts_cuda.launches
        with _CountCollectives() as a_epoch_calls:
            a_epoch = col_a.compute()

        col_b = _binned_collection(dev, dist_sync_on_step=True)
        step_launches = []
        binned_counts_cuda.launches = 0
        b_values, b_ms = _run_steps(col_b, b_batches, on_step=lambda i: step_launches.append(binned_counts_cuda.launches))
        b_launches = binned_counts_cuda.launches
        b_epoch = col_b.compute()
        torch.cuda.synchronize()
        step_kernels = _profile_step(_binned_collection(dev, dist_sync_on_step=True), b_batches[0])

        a_ungrouped_calls, a_ungrouped = _epoch_collectives(_main_collection(dev, compute_groups=False), a_batches[:2])
        composed = _check_composition(dev, a_batches[:5])
        path_c = run_path_c(dev)
        path_d = run_path_d(dev)
        path_e = run_path_e(dev)
        path_f = run_path_f(dev)
        path_g = run_path_g(dev, a_batches, b_batches)
        path_h = run_path_h(dev)
        path_i = run_path_i(dev)
        path_j = run_path_j(dev, a_batches)
        t0 = time.perf_counter()
        path_k = run_path_k(dev, a_batches)
        path_k_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        path_l = run_path_l(dev, a_batches)
        path_l_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        path_m = run_path_m(dev, a_batches)
        path_m_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        path_n = run_path_n(dev, a_batches, path_c, path_e, path_f)
        path_n_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        path_o = run_path_o(dev, a_batches, b_batches)
        path_o_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        path_p = run_path_p(dev)
        path_p_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()

    print(f"[4] path A: {A_STEPS} steps of {A_BATCH} x {A_CLASSES}: median {statistics.median(a_ms):.3f} ms/step"
          f" (first step {a_ms[0]:.1f} ms); K1 launches {a_launches}")
    _check_path_a(a_batches, a_values, a_epoch, col_a)
    _check_epoch_values(a_batches[:2], a_ungrouped)
    _check(a_epoch_calls["all_reduce"] == 2 and a_ungrouped_calls["all_reduce"] == 4,
           f"path A epoch compute: {a_epoch_calls['all_reduce']} all_reduce calls, one per compute group"
           f" ({a_ungrouped_calls['all_reduce']} with compute_groups=False, same values as the CPU run)")
    print(f"  ok: path A (F1 + Precision) / 2 equals the arithmetic of its parts on the card, per step and at the"
          f" epoch ({composed:.6f})")
    print(f"[5] path B: {B_STEPS} steps of {B_N} scores, {B_T} thresholds: median {statistics.median(b_ms):.3f} ms/step"
          f" (first step {b_ms[0]:.1f} ms); K1 launches {b_launches}")
    _check(step_launches == [2 * (i + 1) for i in range(B_STEPS)], "path B: K1 launched exactly 2 times per step")
    _check(step_kernels.get("count_kernel", 0) == 2 and step_kernels.get("sort", 0) == 0,
           f"path B profiled step: 2 K1 kernels, no threshold ranking (no sort kernel) ({step_kernels})")
    _check_path_b(b_batches, b_values, b_epoch, col_b)
    check_path_c(path_c)
    d_timings = check_path_d(path_d)
    e_timings = check_path_e(path_e)
    f_timings = check_path_f(path_f)
    g_timings = check_path_g(path_g)
    h_timings = check_path_h(path_h)
    i_timings = check_path_i(path_i)
    t0 = time.perf_counter()
    j_timings = check_path_j(path_j)
    print(f"    path J checks on the host: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k_timings = check_path_k(path_k)
    print(f"    path K: {path_k_s:.1f} s on the card, {time.perf_counter() - t0:.1f} s of checks on the host")
    t0 = time.perf_counter()
    l_timings = check_path_l(path_l)
    print(f"    path L: {path_l_s:.1f} s on the card and in L6's processes, {time.perf_counter() - t0:.1f} s of checks")
    t0 = time.perf_counter()
    m_timings = check_path_m(path_m)
    print(f"    path M: {path_m_s:.1f} s on the card and in M6's processes, {time.perf_counter() - t0:.1f} s of checks")
    t0 = time.perf_counter()
    n_timings = check_path_n(path_n, a_batches)
    print(f"    path N: {path_n_s:.1f} s on the card and in N6's processes, {time.perf_counter() - t0:.1f} s of checks")
    print(f"[18] path O: observability over paths A and B ({path_o_s:.1f} s, O3 in its own process)")
    t0 = time.perf_counter()
    o_timings = check_path_o(path_o, a_values, a_epoch, a_ms, b_values)
    print(f"    path O: {path_o_s:.1f} s on the card, {time.perf_counter() - t0:.1f} s of checks")
    t0 = time.perf_counter()
    p_timings = check_path_p(path_p, path_k["W1"]["epoch"], dev)
    print(f"    path P: {path_p_s:.1f} s on the card ({', '.join(f'{k} {v:.1f}' for k, v in p_timings['s'].items())}),"
          f" {time.perf_counter() - t0:.1f} s of checks")
    return {"a_ms": statistics.median(a_ms), "b_ms": statistics.median(b_ms), "b_launches": b_launches,
            "c": path_c["timings"], "d": d_timings, "e": e_timings,
            "f": f_timings, "g": g_timings, "h": h_timings, "i": i_timings, "j": j_timings,
            "k": k_timings, "l": l_timings, "m": m_timings, "n": n_timings, "o": o_timings, "p": p_timings}


def _profile_step(collection, batch):
    """K1's kernels and the sort kernels (a threshold ranking) in one profiled collection step, after a warm-up
    step whose events the session drops (``device_breakdown``'s reason). The profiler can leave a kernel
    unrecorded and never adds one, so each name's count is the largest of ``K1_PROFILE_SESSIONS`` sessions."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    counts = {}
    for _ in range(K1_PROFILE_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            collection(*batch)
            torch.cuda.synchronize()
            prof.step()
            collection(*batch)
            torch.cuda.synchronize()
            prof.step()
        session = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for name in ("count_kernel", "sort"):
                    if name in e.key.lower():
                        session[name] = session.get(name, 0) + e.count
        for name, n in session.items():
            counts[name] = max(counts.get(name, 0), n)
    return counts


def _check_path_a(batches, values, epoch, col_gpu):
    import torch

    cpu = _main_collection("cpu", dist_sync_on_step=True)
    conf_total = np.zeros((A_CLASSES, A_CLASSES), dtype=np.int64)
    worst = 0.0
    for (preds, target), got in zip(batches, values):
        p_cpu, t_cpu = preds.cpu(), target.cpu()
        want = cpu(p_cpu, t_cpu)
        conf = np.bincount(t_cpu.numpy() * A_CLASSES + p_cpu.numpy().argmax(1),
                           minlength=A_CLASSES * A_CLASSES).reshape(A_CLASSES, A_CLASSES)
        conf_total += conf
        oracle = _confusion_values(conf)
        for k in want:
            g = got[k].item()
            if not np.isclose(g, want[k].item(), rtol=RTOL_CLASS, atol=0):
                raise AssertionError(f"path A step value {k}: card {g} vs CPU {want[k].item()}")
            if not np.isclose(g, oracle[k], rtol=RTOL_ORACLE, atol=0):
                raise AssertionError(f"path A step value {k}: card {g} vs bincount oracle {oracle[k]}")
            worst = max(worst, abs(g - oracle[k]))
    print(f"  ok: path A per-step values equal the CPU run (rtol {RTOL_CLASS}) and the bincount oracle"
          f" (rtol {RTOL_ORACLE}; max abs diff {worst:.3g})")
    want_epoch, oracle = cpu.compute(), _confusion_values(conf_total)
    for k, v in epoch.items():
        _check(np.isclose(v.item(), want_epoch[k].item(), rtol=RTOL_CLASS, atol=0)
               and np.isclose(v.item(), oracle[k], rtol=RTOL_ORACLE, atol=0),
               f"path A epoch {k} = {v.item():.6f} equals the CPU run and the oracle")
    for name in ("F1", "Precision", "Recall"):
        for s in ("tp", "fp", "tn", "fn"):
            if not torch.equal(getattr(col_gpu[name], s).cpu(), getattr(cpu[name], s)):
                raise AssertionError(f"path A {name}.{s} counts differ between card and CPU")
    _check(int(col_gpu["F1"].tp.sum()) == int(np.trace(conf_total)), "path A count states equal the CPU run and the oracle")


def _check_path_b(batches, values, epoch, col_gpu):
    import torch

    from metrics_tpu_torch.functional.classification.binned_curves import binned_stat_curve_update

    thr_t = col_gpu["BinnedAUROC"].thresholds
    thr = thr_t.cpu().numpy()
    tot = {k: np.zeros(B_T, dtype=np.int64) for k in ("tp", "fp")}
    n_pos = n_neg = 0
    for step, ((scores, target), got) in enumerate(zip(batches, values)):
        s, y = scores.cpu().numpy(), target.cpu().numpy() > 0
        tp, fp = _oracle_counts(s, y, thr)
        tot["tp"] += tp
        tot["fp"] += fp
        n_pos, n_neg = n_pos + int(y.sum()), n_neg + int((~y).sum())
        auroc, ap = _curve_values(tp, fp, int(y.sum()), int((~y).sum()))
        for k, want in (("BinnedAUROC", auroc), ("BinnedAveragePrecision", ap)):
            if not np.isclose(got[k].item(), want, rtol=RTOL_FLOAT, atol=0):
                raise AssertionError(f"path B step {step} {k}: card {got[k].item()} vs oracle {want}")
        if step == 0:
            plain = binned_stat_curve_update(scores, target, thr_t, impl="torch")
            kernel = binned_stat_curve_update(scores, target, thr_t, impl="cuda")
            torch.cuda.synchronize()
            _check(all(torch.equal(a, b) for a, b in zip(plain, kernel)),
                   "path B step 0: kernel counts equal the plain version on the card exactly")
    print(f"  ok: path B per-step AUROC / AP equal the numpy oracle (rtol {RTOL_FLOAT})")
    for name in ("BinnedAUROC", "BinnedAveragePrecision"):
        m = col_gpu[name]
        _check(np.array_equal(m.tp.cpu().numpy(), tot["tp"]) and np.array_equal(m.fp.cpu().numpy(), tot["fp"])
               and np.array_equal(m.fn.cpu().numpy(), n_pos - tot["tp"])
               and np.array_equal(m.tn.cpu().numpy(), n_neg - tot["fp"]),
               f"path B {name} count states equal the oracle exactly")
    auroc, ap = _curve_values(tot["tp"], tot["fp"], n_pos, n_neg)
    for k, want in (("BinnedAUROC", auroc), ("BinnedAveragePrecision", ap)):
        _check(np.isclose(epoch[k].item(), want, rtol=RTOL_FLOAT, atol=0),
               f"path B epoch {k} = {epoch[k].item():.6f} equals the oracle {want:.6f}")


def _curve_collection(device, **kw):
    import metrics_tpu_torch as pt

    return pt.MetricCollection([pt.AUROC(pos_label=1, device=device, **kw),
                                pt.AveragePrecision(pos_label=1, device=device, **kw)])


def _curve_batches(steps, n):
    """Seeded scores on a 2**-12 grid (tied), about 10% positives."""
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(steps):
        target = (rng.random(n) < 0.1).astype(np.int64)
        logits = rng.standard_normal(n, dtype=np.float32) + 1.5 * target
        scores = np.round(1 / (1 + np.exp(-logits)) * 4096) / 4096
        batches.append((scores.astype(np.float32), target))
    return batches


def _curve_oracle(scores, target):
    """(AUROC, AP, distinct thresholds descending, fpr, tpr) in float64 numpy."""
    uniq, inverse, counts = np.unique(scores, return_inverse=True, return_counts=True)
    pos_per = np.bincount(inverse, weights=target, minlength=len(uniq))
    neg_per = counts - pos_per
    n_pos, n_neg = pos_per.sum(), neg_per.sum()
    avg_rank = np.cumsum(counts) - (counts - 1) / 2.0  # ties share their average rank
    auroc = (np.sum(pos_per * avg_rank) - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    tp, fp = np.cumsum(pos_per[::-1]), np.cumsum(neg_per[::-1])
    recall = tp / n_pos
    ap = np.sum(np.diff(np.concatenate([[0.0], recall])) * tp / (tp + fp))
    return auroc, ap, uniq[::-1], np.concatenate([[0.0], fp / n_neg]), np.concatenate([[0.0], tp / n_pos])


def run_path_c(device):
    """Path C inside the caller's process group: both modes, timed, the epoch profiled."""
    import torch

    host = _curve_batches(C_STEPS, C_N)
    batches = [(torch.from_numpy(p).to(device), torch.from_numpy(t).to(device)) for p, t in host]
    runs = {}
    for mode, kw in (("list", {}), ("capacity", {"capacity": C_CAPACITY})):
        col = _curve_collection(device, **kw)
        values, ms = _run_steps(col, batches)
        epoch, epoch_ms, calls, _ = _epoch_timed(col, device)
        runs[mode] = {"values": values, "ms": ms, "epoch": epoch, "epoch_ms": epoch_ms, "calls": calls,
                      "collection": col}
    profile = _profile_epoch(runs["list"]["collection"], device)
    import metrics_tpu_torch as pt

    roc = pt.ROC(pos_label=1, device=device)
    roc.update(*batches[0])
    fpr, tpr, thresholds = roc.compute()
    return {"host": host, "runs": runs, "roc": (fpr.cpu().numpy(), tpr.cpu().numpy(), thresholds.cpu().numpy()),
            "timings": {"forward_ms": {m: r["ms"] for m, r in runs.items()},
                        "epoch_ms": {m: r["epoch_ms"] for m, r in runs.items()},
                        "epoch_collectives": {m: r["calls"] for m, r in runs.items()},
                        "epoch_profile": profile}}


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _run_steps(collection, batches, on_step=None, call=None):
    """Per-step values (tensors), per-step milliseconds (host clock, synchronized). A step is
    ``call(collection, batch)``, by default ``collection(*batch)``."""
    values, ms = [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        values.append(collection(*batch) if call is None else call(collection, batch))
        _sync(batch[0].device)
        ms.append((time.perf_counter() - t0) * 1e3)
        if on_step is not None:
            on_step(i)
    return values, ms


def _forward_counted(collection, batches, call=None, on_step=None):
    """``_run_steps`` counting updates: (values, ms per step, cumulative updates after each step)."""
    updates = []

    def step_done(i):
        updates.append(calls[0])
        if on_step is not None:
            on_step(i)

    with _CountUpdates() as calls:
        values, ms = _run_steps(collection, batches, on_step=step_done, call=call)
    return values, ms, updates


def _epoch_timed(collection, device, repeats=2):
    """Epoch ``compute()`` ``repeats`` times with the compute caches cleared: the values (with the
    warnings they raised), milliseconds, and the collective calls of the first."""
    import warnings

    ms, counted = [], None
    for _ in range(repeats):
        for m in collection.values():
            m._computed = None
        t0 = time.perf_counter()
        with _CountCollectives() as collectives, warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            epoch = collection.compute()
            _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        if counted is None:
            counted, said = dict(collectives), [str(w.message) for w in caught]
    return epoch, ms, counted, said


def _profile_epoch(collection, device):
    """Device operations of an uncached epoch compute (``torch.profiler``, 3 calls): the sort kernels'
    share of its device time, and the top operations."""
    if device.type != "cuda":
        return None
    from metrics_tpu_torch.tools.cuda_timing import device_breakdown

    def fresh_compute():
        for m in collection.values():
            m._computed = None
        collection.compute()

    rows = device_breakdown(fresh_compute, calls=3)
    total = sum(r["us_per_call"] for r in rows)
    sort = sum(r["us_per_call"] for r in rows if "sort" in r["name"].lower())
    return {"sort_share": sort / total, "sort_ms": sort / 1e3, "device_ms": total / 1e3, "top": rows[:8]}


def check_path_c(result):
    """Both modes against the numpy oracle and each other; the ROC of batch 0 against the oracle's curve."""
    runs, host = result["runs"], result["host"]
    worst = 0.0
    for step, (scores, target) in enumerate(host):
        auroc, ap, _, _, _ = _curve_oracle(scores, target)
        for mode, run in runs.items():
            got = run["values"][step]
            for k, want in (("AUROC", auroc), ("AveragePrecision", ap)):
                if not np.isclose(got[k].item(), want, rtol=RTOL_ORACLE, atol=0):
                    raise AssertionError(f"path C {mode} step {step} {k}: {got[k].item()} vs oracle {want}")
                worst = max(worst, abs(got[k].item() - want) / want)
    print(f"  ok: path C per-step AUROC / AP of both modes equal the numpy oracle (rtol {RTOL_ORACLE};"
          f" max rel diff {worst:.3g})")
    all_scores = np.concatenate([s for s, _ in host])
    all_target = np.concatenate([t for _, t in host])
    auroc, ap, thresholds, fpr, tpr = _curve_oracle(all_scores, all_target)
    for mode, run in runs.items():
        for k, want in (("AUROC", auroc), ("AveragePrecision", ap)):
            got = run["epoch"][k].item()
            _check(np.isclose(got, want, rtol=RTOL_ORACLE, atol=0),
                   f"path C {mode} epoch {k} = {got:.7f} equals the oracle {want:.7f} over {len(all_scores)} samples")
    for k in ("AUROC", "AveragePrecision"):
        a, b = runs["list"]["epoch"][k].item(), runs["capacity"]["epoch"][k].item()
        _check(np.isclose(a, b, rtol=RTOL_ORACLE, atol=0), f"path C epoch {k}: list mode {a:.7f} = capacity mode {b:.7f}")
    _, _, thr0, fpr0, tpr0 = _curve_oracle(*host[0])
    got_fpr, got_tpr, got_thr = result["roc"]
    _check(np.array_equal(got_thr[1:], thr0.astype(np.float32)) and got_thr[0] == thr0[0] + 1,
           f"path C ROC of batch 0: exactly the oracle's {len(thr0)} distinct thresholds (max + 1 first)")
    _check(np.allclose(got_fpr, fpr0, rtol=RTOL_CURVE, atol=0) and np.allclose(got_tpr, tpr0, rtol=RTOL_CURVE, atol=0),
           f"path C ROC of batch 0: fpr / tpr within rtol {RTOL_CURVE} of the oracle")
    t = result["timings"]
    for mode in runs:
        fwd = t["forward_ms"][mode]
        print(f"[6] path C {mode}: {C_STEPS} steps of {C_N} scores: forward {', '.join(f'{x:.2f}' for x in fwd)} ms/step"
              f" (median {statistics.median(fwd):.2f}); epoch compute {t['epoch_ms'][mode][0]:.2f} ms"
              f" (again: {t['epoch_ms'][mode][1]:.2f} ms);"
              f" epoch sync collectives {t['epoch_collectives'][mode]}")
    prof = t["epoch_profile"]
    if prof is not None:
        print(f"    path C list-mode epoch compute, profiled: {prof['device_ms']:.3f} ms device time a compute,"
              f" sort kernels {prof['sort_ms']:.3f} ms ({100 * prof['sort_share']:.1f}%)")
        for op in prof["top"]:
            print(f"      {op['us_per_call']:10.1f} us x{op['per_call']:g}  {op['name'][:100]}")


def _d1_collection(device, **kw):
    import metrics_tpu_torch as pt

    c = A_CLASSES
    return pt.MetricCollection([
        pt.ConfusionMatrix(c, device=device, **kw),
        pt.IoU(c, device=device, **kw),
        pt.CohenKappa(c, device=device, **kw),
        pt.MatthewsCorrcoef(c, device=device, **kw),
        pt.Specificity(average="macro", num_classes=c, device=device, **kw),
        pt.HammingDistance(device=device, **kw),
        pt.ExactMatch(device=device, **kw),
        pt.CalibrationError(n_bins=D_BINS, device=device, **kw),
        pt.HingeLoss(device=device, **kw),
    ])


def _d2_collection(device, **kw):
    import metrics_tpu_torch as pt

    return pt.MetricCollection([
        pt.CoverageError(device=device, **kw),
        pt.LabelRankingAveragePrecision(device=device, **kw),
        pt.LabelRankingLoss(device=device, **kw),
        pt.CriticalSuccessIndex(threshold=0.5, device=device, **kw),
    ])


def _d1_batches():
    """Seeded probabilities: 2 x N(0, 1) logits with the true class raised by 8 (top-1 about 77%)."""
    rng = np.random.default_rng(4)
    rows = np.arange(A_BATCH)
    batches = []
    for _ in range(D1_STEPS):
        logits = 2 * rng.standard_normal((A_BATCH, A_CLASSES))
        target = rng.integers(0, A_CLASSES, A_BATCH)
        logits[rows, target] += 8
        e = np.exp(logits - logits.max(1, keepdims=True))
        batches.append(((e / e.sum(1, keepdims=True)).astype(np.float32), target))
    return batches


def _d2_batches():
    """Seeded multilabel scores: about 2.9 true labels a row (some rows none), scores on a 2**-8 grid."""
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(D2_STEPS):
        target = (rng.random((D2_BATCH, D2_LABELS)) < 2.9 / D2_LABELS).astype(np.int64)
        logits = rng.standard_normal((D2_BATCH, D2_LABELS)) + 2.0 * target - 1.0
        scores = np.round(256 / (1 + np.exp(-logits))) / 256
        batches.append((scores.astype(np.float32), target))
    return batches


def _d1_stats(p, t):
    """Sufficient statistics of one D1 batch in float64 numpy; they add across batches."""
    rows, pred = np.arange(len(t)), p.argmax(1)
    conf = p.max(1)
    # the bin of the reference's arithmetic: ceil(conf * B) in float32
    bins = np.clip(np.ceil(conf * np.float32(D_BINS)).astype(np.int64) - 1, 0, D_BINS - 1)
    wrong = p.astype(np.float64)
    true_score = wrong[rows, t].copy()
    wrong[rows, t] = -np.inf
    return {
        "confmat": np.bincount(t * A_CLASSES + pred, minlength=A_CLASSES * A_CLASSES).reshape(A_CLASSES, A_CLASSES),
        "cal_conf": np.bincount(bins, weights=conf.astype(np.float64), minlength=D_BINS),
        "cal_acc": np.bincount(bins, weights=(pred == t).astype(np.float64), minlength=D_BINS),
        "cal_count": np.bincount(bins, minlength=D_BINS),
        "hinge": np.maximum(0.0, 1.0 - (true_score - wrong.max(1))).sum(),
    }


def _d1_values(st):
    """D1's values in float64 from summed statistics (a wrong one-hot row differs in two places)."""
    conf = st["confmat"].astype(np.float64)
    n, c = conf.sum(), conf.shape[0]
    tp = np.diag(conf)
    pred_n, true_n = conf.sum(0), conf.sum(1)
    fp, fn = pred_n - tp, true_n - tp
    union = tp + fp + fn
    w = 1.0 - np.eye(c)
    correct = tp.sum()
    count = st["cal_count"].astype(np.float64)
    seen = count > 0
    gap = np.abs(st["cal_acc"][seen] - st["cal_conf"][seen]) / count[seen]
    return {
        "ConfusionMatrix": conf,
        "IoU": np.where(union == 0, 0.0, tp / np.maximum(union, 1)).mean(),
        "CohenKappa": 1 - (w * conf).sum() / (w * np.outer(true_n, pred_n) / n).sum(),
        "MatthewsCorrcoef": (correct * n - pred_n @ true_n)
        / (np.sqrt(n**2 - true_n @ true_n) * np.sqrt(n**2 - pred_n @ pred_n)),
        "Specificity": ((n - tp - fp - fn) / (n - true_n)).mean(),
        "HammingDistance": 2 * (n - correct) / (n * c),
        "ExactMatch": correct / n,
        "CalibrationError": np.sum(count[seen] / n * gap),
        "HingeLoss": st["hinge"] / n,
    }


def _below(values, queries):
    """Per row, how many of ``values[i]`` lie strictly below each ``queries[i, j]``: one sort and a
    ``searchsorted`` over all rows, kept apart by an offset of 3 a row (every value is in [-1, 1])."""
    n, width = queries.shape
    offset = 3.0 * np.arange(n)[:, None]
    flat = np.sort((values + offset).ravel())
    below = np.searchsorted(flat, (queries + offset).ravel(), side="left").reshape(n, width)
    return below - width * np.arange(n)[:, None]


def _d2_stats(p, t):
    """Sufficient statistics of one D2 batch: ranks from a sort (not the pairwise comparison the port
    uses), ties counted pessimistically, degenerate rows as sklearn scores them."""
    s, r = p.astype(np.float64), t > 0
    labels = s.shape[1]
    n_true = r.sum(1)
    ranks = labels - _below(s, s)  # |{k: s_k >= s_j}|
    among_true = n_true[:, None] - (_below(np.where(r, s, -1.0), s) - (labels - n_true)[:, None])
    false_ge = ranks - among_true
    lrap = np.where(r, among_true / ranks, 0.0).sum(1) / np.maximum(n_true, 1)
    pairs = n_true * (labels - n_true)
    violations = np.where(r, false_ge, 0).sum(1)
    pe, te = p >= 0.5, t >= 0.5
    return {
        "coverage": np.where(r, ranks, 0).max(1).sum(),
        "lrap": np.where((n_true == 0) | (n_true == labels), 1.0, lrap).sum(),
        "lrl": np.where(pairs > 0, violations / np.maximum(pairs, 1), 0.0).sum(),
        "n": len(t),
        "tp": int((pe & te).sum()),
        "fp_fn": int((pe != te).sum()),
    }


def _d2_values(st):
    return {
        "CoverageError": st["coverage"] / st["n"],
        "LabelRankingAveragePrecision": st["lrap"] / st["n"],
        "LabelRankingLoss": st["lrl"] / st["n"],
        "CriticalSuccessIndex": st["tp"] / (st["tp"] + st["fp_fn"]),
    }


_D_PARTS = {"D1": (_d1_collection, _d1_batches, _d1_stats, _d1_values),
            "D2": (_d2_collection, _d2_batches, _d2_stats, _d2_values)}


class _CountUpdates:
    """Counts metric updates (``Metric._run_update_on_state``: every forward runs its update there) while active."""

    def __enter__(self):
        from metrics_tpu_torch.core.metric import Metric

        self.calls = [0]
        self._real = real = Metric._run_update_on_state
        calls = self.calls

        def counting(metric, state, *args, **kwargs):
            calls[0] += 1
            return real(metric, state, *args, **kwargs)

        Metric._run_update_on_state = counting
        return self.calls

    def __exit__(self, *exc):
        from metrics_tpu_torch.core.metric import Metric

        Metric._run_update_on_state = self._real


def _syncs_per_epoch(collection):
    """Collective calls one epoch sync makes, each compute group syncing once: an ``all_reduce`` per
    (dtype, operation) bucket of its sum / min / max states, and for its gather states (lists, buffers,
    callable reductions) one layout ``all_gather`` plus one per dtype."""
    import torch

    from metrics_tpu_torch.parallel.buffer import PaddedBuffer

    calls = {"all_reduce": 0, "all_gather": 0}
    for rep in collection.compute_groups:
        m = collection[rep]
        reduce_buckets, gather_dtypes = set(), set()
        for name, value in m._current_state().items():
            fx = m._reductions[name]
            if isinstance(value, (list, PaddedBuffer)) or fx not in ("sum", "mean", "min", "max"):
                gather_dtypes.add(m._cat_layouts[name][0] if isinstance(value, list) else value.dtype if
                                  isinstance(value, torch.Tensor) else value.data.dtype)
            else:
                reduce_buckets.add((value.dtype, "sum" if fx == "mean" else fx))
        calls["all_reduce"] += len(reduce_buckets)
        calls["all_gather"] += 1 + len(gather_dtypes) if gather_dtypes else 0
    return calls


def run_path_d(device):
    """Path D inside the caller's process group: D1 and D2 forward with ``dist_sync_on_step``, timed,
    the updates of each step and the collective calls of the epoch compute counted."""
    import torch

    runs = {}
    for name, (build, make, _, _) in _D_PARTS.items():
        host = make()
        batches = [(torch.from_numpy(p).to(device), torch.from_numpy(t).to(device)) for p, t in host]
        col = build(device, dist_sync_on_step=True)
        values, ms, updates = _forward_counted(col, batches)
        epoch, epoch_ms, collectives, _ = _epoch_timed(col, device)
        fresh = build(device, dist_sync_on_step=True)
        runs[name] = {"host": host, "values": values, "ms": ms, "updates": updates, "epoch": epoch,
                      "epoch_ms": epoch_ms, "collectives": collectives, "expected": _syncs_per_epoch(col),
                      "collection": col,
                      "profile": _profile_call(lambda: fresh(*batches[0])) if device.type == "cuda" else None}
    return runs


def _host_sync_sites(fn):
    """``fn()`` under torch's sync debug mode: a ``Counter`` of the Python lines that made a synchronizing CUDA
    call (torch's own notice that the mode is a prototype is not one), and ``fn``'s result."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    here = os.path.dirname(os.path.abspath(__file__))
    return Counter(f"{os.path.relpath(w.filename, here)}:{w.lineno}" for w in caught
                   if "synchroniz" in str(w.message).lower() and "prototype" not in str(w.message)), out


def _profile_call(step, calls=5):
    """Device operations of one ``step()`` (``torch.profiler`` over ``calls`` calls) and the synchronizing
    CUDA calls of one more."""
    import torch

    from metrics_tpu_torch.tools.cuda_timing import device_breakdown

    rows = device_breakdown(step, calls=calls)
    torch.cuda.synchronize()
    sites, _ = _host_sync_sites(step)
    return {"device_ms": sum(r["us_per_call"] for r in rows) / 1e3, "ops": sum(r["per_call"] for r in rows),
            "host_syncs": sum(sites.values()), "sync_sites": sites.most_common(8),
            "sort_ms": sum(r["us_per_call"] for r in rows if "sort" in r["name"].lower()) / 1e3,
            "scatter_ms": sum(r["us_per_call"] for r in rows
                              if "indexfunc" in r["name"].lower() or "scatter_gather" in r["name"].lower()) / 1e3,
            "top": rows[:8]}


def _d_close(label, got, cpu, oracle):
    g = got.item()
    atol = ATOL_HAMMING if "Hamming" in label else 0.0
    rtol = 0.0 if atol else RTOL_D
    if not (np.isclose(g, cpu.item(), rtol=rtol, atol=atol) and np.isclose(g, oracle, rtol=rtol, atol=atol)):
        raise AssertionError(f"{label}: card {g} vs CPU {cpu.item()} vs float64 oracle {oracle}")
    return 0.0 if atol else abs(g - oracle) / abs(oracle)


def check_path_d(result):
    """Each part against the CPU run and the float64 oracle, per step and at the epoch; counts exactly."""
    import torch

    timings = {}
    for name, (build, _, stats, values_of) in _D_PARTS.items():
        run = result[name]
        cpu = build("cpu", dist_sync_on_step=True)
        groups = len(cpu.compute_groups)
        steps = len(run["host"])
        total, worst = None, 0.0
        for step, ((p, t), got) in enumerate(zip(run["host"], run["values"])):
            want = cpu(torch.from_numpy(p), torch.from_numpy(t))
            st = stats(p, t)
            total = st if total is None else {k: total[k] + v for k, v in st.items()}
            oracle = values_of(st)
            for k, v in got.items():
                if k == "ConfusionMatrix":
                    exact = np.array_equal(v.cpu().numpy(), oracle[k].astype(np.float32))
                    if not (torch.equal(v.cpu(), want[k]) and exact):
                        raise AssertionError(f"path {name} step {step}: confusion matrix differs from the CPU / oracle")
                    continue
                worst = max(worst, _d_close(f"path {name} step {step} {k}", v, want[k], oracle[k]))
        print(f"  ok: path {name} per-step values equal the CPU run and the float64 oracle (rtol {RTOL_D},"
              f" Hamming atol {ATOL_HAMMING:.3g}; max rel diff to the oracle of the others {worst:.3g})")
        oracle, want = values_of(total), cpu.compute()
        for k, v in run["epoch"].items():
            if k == "ConfusionMatrix":
                _check(np.array_equal(v.cpu().numpy(), oracle[k].astype(np.float32))
                       and np.array_equal(run["collection"][k].confmat.cpu().numpy(), total["confmat"]),
                       f"path {name} epoch confusion matrix ({int(total['confmat'].sum())} pairs) equals the numpy"
                       " bincount oracle exactly")
                continue
            rel = _d_close(f"path {name} epoch {k}", v, want[k], oracle[k])
            print(f"  ok: path {name} epoch {k} = {v.item():.7g} (oracle {oracle[k]:.7g}, rel diff {rel:.3g})")
        for k, m in run["collection"].items():
            for state, value in m._current_state().items():
                ref = getattr(cpu[k], state)
                same = (torch.equal(value.cpu(), ref) if not value.is_floating_point()
                        else torch.allclose(value.cpu(), ref, rtol=RTOL_D, atol=0))
                if not same:
                    raise AssertionError(f"path {name} {k}.{state} differs between the card and the CPU run")
        if name == "D2":
            csi = run["collection"]["CriticalSuccessIndex"]
            _check(int(csi.tp) == total["tp"] and int(csi.fp_fn) == total["fp_fn"],
                   f"path D2 CSI counts equal the oracle (tp {total['tp']}, fp + fn {total['fp_fn']})")
        print(f"  ok: path {name} count states equal the CPU run exactly, float sums to rtol {RTOL_D}")
        _check(run["updates"] == [groups * (i + 1) for i in range(steps)],
               f"path {name}: {groups} updates a step, one per compute group of the CPU run ({cpu.compute_groups})")
        calls = run["collectives"]["all_reduce"]
        _check(run["collectives"] == run["expected"] and run["collectives"]["all_gather"] == 0,
               f"path {name} epoch compute: {calls} all_reduce calls for {groups} compute groups, one sync a group"
               " (one call per state dtype in it)")
        ms = run["ms"]
        print(f"[7] path {name}: {steps} steps of {tuple(run['host'][0][0].shape)}: median {statistics.median(ms):.3f}"
              f" ms/step (first step {ms[0]:.1f} ms); epoch compute {run['epoch_ms'][0]:.2f} ms"
              f" (again: {run['epoch_ms'][1]:.2f} ms); epoch all_reduce calls {calls}")
        prof = run["profile"]
        if prof is not None:
            print(f"    path {name} step, profiled: {prof['device_ms']:.3f} ms device time a step"
                  f" ({100 * prof['device_ms'] / statistics.median(ms):.1f}% of the median step),"
                  f" {prof['ops']:g} device operations, {prof['host_syncs']} synchronizing CUDA calls")
            for op in prof["top"]:
                print(f"      {op['us_per_call']:10.1f} us x{op['per_call']:g}  {op['name'][:100]}")
        timings[name] = {"ms_per_step": statistics.median(ms), "first_step_ms": ms[0], "epoch_ms": run["epoch_ms"],
                         "epoch_all_reduce": calls, "compute_groups": groups, "step_profile": prof}
    return timings


# ------------------------------------------------------------------------------------------- path E
def _e1_collection(device, **kw):
    import metrics_tpu_torch as pt

    return pt.MetricCollection([
        pt.MeanSquaredError(device=device, **kw),
        pt.MeanAbsoluteError(device=device, **kw),
        pt.MeanSquaredLogError(device=device, **kw),
        pt.MeanAbsolutePercentageError(device=device, **kw),
        pt.SymmetricMeanAbsolutePercentageError(device=device, **kw),
        pt.WeightedMeanAbsolutePercentageError(device=device, **kw),
        pt.ExplainedVariance(device=device, **kw),
        pt.R2Score(device=device, **kw),
        pt.RelativeSquaredError(device=device, **kw),
        pt.PearsonCorrcoef(device=device, **kw),
        pt.ConcordanceCorrCoef(device=device, **kw),
        pt.MinkowskiDistance(p=3, device=device, **kw),
        pt.LogCoshError(device=device, **kw),
        pt.TweedieDevianceScore(power=1.5, device=device, **kw),
    ])


def _e2_collection(device, **kw):
    import metrics_tpu_torch as pt

    return pt.MetricCollection([pt.KLDivergence(device=device, **kw), pt.CosineSimilarity(device=device, **kw)])


def _e4_collection(device, **kw):
    import metrics_tpu_torch as pt

    return pt.MetricCollection([
        pt.SSIM(data_range=1.0, device=device, **kw),
        pt.MultiScaleSSIM(data_range=1.0, device=device, **kw),
        pt.PSNR(data_range=1.0, device=device, **kw),
        pt.UniversalImageQualityIndex(device=device, **kw),
        pt.TotalVariation(device=device, **kw),
        pt.SpectralAngleMapper(device=device, **kw),
        pt.ErrorRelativeGlobalDimensionlessSynthesis(device=device, **kw),
    ])


def _e1_batches():
    """Lognormal targets (positive, skewed: prices, durations), predictions within exp(0.1 N(0, 1)) of them."""
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(E_STEPS):
        target = rng.lognormal(0.0, 1.0, E1_N).astype(np.float32)
        batches.append(((target * np.exp(0.1 * rng.standard_normal(E1_N))).astype(np.float32), target))
    return batches


def _e2_batches():
    """Softmax rows: q is p's logits moved by N(0, 0.5^2)."""
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(E_STEPS):
        logits = rng.standard_normal((E2_BATCH, E2_DIM))
        p = np.exp(logits - logits.max(1, keepdims=True))
        logits_q = logits + 0.5 * rng.standard_normal(logits.shape)
        q = np.exp(logits_q - logits_q.max(1, keepdims=True))
        batches.append(((p / p.sum(1, keepdims=True)).astype(np.float32),
                        (q / q.sum(1, keepdims=True)).astype(np.float32)))
    return batches


def _e3_batches(steps, n, seed):
    """Scores on a 2**-12 grid (tied), the target a noisy copy on the same grid."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(steps):
        x = np.round(rng.random(n) * 4096) / 4096
        y = np.round((x + 0.5 * rng.standard_normal(n)) * 4096) / 4096
        batches.append((x.astype(np.float32), y.astype(np.float32)))
    return batches


def _e4_images(rng, shape):
    """A smooth field in [0.14, 0.86] (three random sinusoid products a channel) and the same plus
    N(0, 0.05^2) noise, clipped to [0, 1]."""
    n, c, h, w = shape
    yy = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    target = np.full(shape, 0.5, np.float32)
    for _ in range(3):
        fy, fx, phase = (rng.uniform(lo, hi, (n, c, 1, 1)).astype(np.float32) for lo, hi in ((2, 12), (2, 12), (0, 6.3)))
        target += 0.12 * np.sin(fy * yy + phase) * np.cos(fx * xx - phase)
    preds = np.clip(target + 0.05 * rng.standard_normal(shape, dtype=np.float32), 0, 1)
    return preds, target


def _e4_batches(steps, seed):
    rng = np.random.default_rng(seed)
    return [_e4_images(rng, E4_SHAPE) for _ in range(steps)]


def _to(device, batches):
    import torch

    return [tuple(torch.from_numpy(x).to(device) for x in b) for b in batches]


def _e4_call(collection, batch):
    """The image collection's step: ``TotalVariation`` scores the prediction (its ``img``), the rest the pair."""
    preds, target = batch
    return collection(preds=preds, target=target, img=preds)


def _count_states(metric):
    import torch

    return {k: v.clone() for k, v in metric._current_state().items()
            if isinstance(v, torch.Tensor) and not v.is_floating_point()}


K2_REPS = 20  # L2-cold timings of K2 a shape (median)
K2_PLAIN_REPS = 5


def _k2_plain_maps(p, t, window, sigma, shift=None):
    """The plain version's maps on the same tensors: SSIM's (ssim, cs) at data_range 1, or UQI's one."""
    import torch

    from metrics_tpu_torch.functional.regression.ssim import _ssim_map
    from metrics_tpu_torch.functional.regression.uqi import _uqi_map

    if shift is None:
        return torch.stack(_ssim_map(p, t, window, sigma, 1.0, 0.01, 0.03))
    return _uqi_map(p, t, window, sigma, shift)[None]


def _e4_k2(device):
    """Kernel K2 alone at E4's shapes (the benchmark cell's: batches of 16 and 8 of 3 x 512 x 512, every
    MS-SSIM scale): its maps against the plain version's on the card, bit for bit, its per-block sums
    against the plain maps' sums, then its device ms (L2 cold and back to back), host enqueue and the plain
    version's ms at the full size."""
    import torch
    import torch.nn.functional as F

    from metrics_tpu_torch.functional.regression.ssim import _window_taps
    from metrics_tpu_torch.ops.ssim_filter import ssim_filter_cuda
    from metrics_tpu_torch.tools.cuda_timing import device_breakdown, device_ms_cold, host_enqueue_us, ms_back_to_back

    window, sigma = (11, 11), (1.5, 1.5)
    taps = _window_taps(window, sigma)
    full = _to(device, _e4_batches(1, 13))[0]
    out = {"compared": [], "ms": {}}
    for batch in (E4_SHAPE[0], E4_SHAPE[0] // 2):
        p, t = (x[:batch].contiguous() for x in full)
        for scale in range(5):
            for form, kw in (("ssim", {"data_range": 1.0}), ("uqi", {"shift": torch.mean((p + t) * 0.5)})):
                want = _k2_plain_maps(p, t, window, sigma, kw.get("shift"))
                maps = ssim_filter_cuda(p, t, *taps, maps=True, **kw)
                sums = ssim_filter_cuda(p, t, *taps, **kw).sum(-1).double()
                want_sums = want.double().sum(dim=(2, 3, 4))
                torch.cuda.synchronize()
                out["compared"].append({
                    "form": form, "shape": tuple(p.shape), "equal": bool(torch.equal(maps, want)),
                    "max_abs": float((maps - want).abs().max()),
                    "sums_rel": float(((sums - want_sums).abs() / want_sums.abs()).max())})
            p, t = F.avg_pool2d(p, 2), F.avg_pool2d(t, 2)
    p, t = full
    shift = torch.mean((p + t) * 0.5)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    calls = {
        "ssim_sums": lambda: ssim_filter_cuda(p, t, *taps, data_range=1.0),
        "ssim_maps": lambda: ssim_filter_cuda(p, t, *taps, data_range=1.0, maps=True),
        "uqi_sums": lambda: ssim_filter_cuda(p, t, *taps, shift=shift),
        "ssim_sums_batch8": lambda: ssim_filter_cuda(p[:8], t[:8], *taps, data_range=1.0),
    }
    for name, call in calls.items():
        out["ms"][name] = device_ms_cold(call, reps=K2_REPS, flush=flush)
    out["ms_back_to_back"] = ms_back_to_back(calls["ssim_sums"], 100)
    out["host_enqueue_us"] = host_enqueue_us(calls["ssim_sums"])
    # the device operations of one full-size call, as phase 3 counts K1's: the profiler can drop a kernel record,
    # never add one, so the session that recorded the most is kept and every session's names are checked
    sessions = [device_breakdown(calls["ssim_sums"]) for _ in range(K1_PROFILE_SESSIONS)]
    out["device_ops"] = max(sessions, key=lambda rows: sum(r["per_call"] for r in rows))
    out["device_op_names"] = sorted({r["name"] for rows in sessions for r in rows})
    out["launches_per_call"] = sum(r["per_call"] for r in out["device_ops"])
    out["plain_ms"] = device_ms_cold(lambda: torch.sum(_k2_plain_maps(p, t, window, sigma)[0]), reps=K2_PLAIN_REPS,
                                     flush=flush)
    n, c, h, w = E4_SHAPE
    flops = 5 * 2 * window[0] * 2 * n * c * h * w  # five moments, two passes, a multiply-add a tap (work count's)
    out["bound_ms"] = max(flops / FP32_OPS_PER_S, 2 * 4 * n * c * h * w / HBM_BYTES_PER_S) * 1e3
    return out


def run_path_e(device):
    """Path E inside the caller's process group: E1, E2 and E4 forward with ``dist_sync_on_step``, E3 synced
    at ``compute()``; timed, updates and epoch collectives counted, an E1 and an E4 step profiled."""
    import torch

    out = {}
    for name, build, make in (("E1", _e1_collection, _e1_batches), ("E2", _e2_collection, _e2_batches)):
        host = make()
        col = build(device, dist_sync_on_step=True)
        values, ms, updates = _forward_counted(col, _to(device, host))
        epoch, epoch_ms, collectives, said = _epoch_timed(col, device)
        out[name] = {"host": host, "collection": col, "values": values, "ms": ms, "updates": updates,
                     "epoch": epoch, "epoch_ms": epoch_ms, "collectives": collectives, "warnings": said,
                     "expected": _syncs_per_epoch(col)}
    if device.type == "cuda":
        batch = _to(device, out["E1"]["host"][:1])[0]
        fresh = _e1_collection(device, dist_sync_on_step=True)
        out["E1"]["profile"] = _profile_call(lambda: fresh(*batch))

    import metrics_tpu_torch as pt
    from metrics_tpu_torch.ops.ssim_filter import ssim_filter_cuda

    e3 = {}
    for kind, cls, (steps, n), seed, capacity in (("Spearman", pt.SpearmanCorrcoef, E3_SPEARMAN, 9, 2**23),
                                                  ("Kendall", pt.KendallRankCorrCoef, E3_KENDALL, 10, 16_384)):
        host = _e3_batches(steps, n, seed)
        batches = _to(device, host)
        for mode, kw in (("list", {}), ("capacity", {"capacity": min(capacity, steps * n)})):
            col = pt.MetricCollection([cls(device=device, **kw)])
            values, ms, updates = _forward_counted(col, batches)
            epoch, epoch_ms, collectives, _ = _epoch_timed(col, device)
            e3[f"{kind} {mode}"] = {"host": host, "collection": col, "values": values, "ms": ms, "updates": updates,
                                    "epoch": epoch, "epoch_ms": epoch_ms, "collectives": collectives,
                                    "expected": _syncs_per_epoch(col)}
    out["E3"] = e3

    # E4 runs under the precision flags a user has by default (TF32 allowed for convolutions and, at
    # "high", for matmuls): the SSIM family must not depend on them
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        host = _e4_batches(E_STEPS, 11)
        col = _e4_collection(device, dist_sync_on_step=True)
        snapshot = {}

        def keep_counts(i):  # the count states at the end of the steps the CPU run repeats
            if i == E4_CPU_STEPS - 1:
                snapshot.update({k: _count_states(m) for k, m in col.items()})

        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        k2_before = ssim_filter_cuda.launches, ssim_filter_cuda.plain_cuda_calls
        values, ms, updates = _forward_counted(col, _to(device, host), call=_e4_call, on_step=keep_counts)
        k2_counts = (ssim_filter_cuda.launches - k2_before[0], ssim_filter_cuda.plain_cuda_calls - k2_before[1])
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
        epoch, epoch_ms, collectives, said = _epoch_timed(col, device)
        out["E4"] = {"host": host, "collection": col, "values": values, "ms": ms, "updates": updates,
                     "epoch": epoch, "epoch_ms": epoch_ms, "collectives": collectives, "warnings": said,
                     "expected": _syncs_per_epoch(col), "counts_at_cpu_steps": snapshot, "peak_bytes": peak,
                     "k2_launches": k2_counts[0], "k2_plain_cuda_calls": k2_counts[1]}
        if device.type == "cuda":
            batch = _to(device, host[:1])[0]
            fresh = _e4_collection(device, dist_sync_on_step=True)
            out["E4"]["profile"] = _profile_call(lambda: _e4_call(fresh, batch), calls=3)
        stored_host = _e4_batches(E4_STORED_STEPS, 12)
        stored = pt.MetricCollection([pt.SSIM(device=device)])
        values, ms, updates = _forward_counted(stored, _to(device, stored_host))
        epoch, epoch_ms, collectives, _ = _epoch_timed(stored, device)
        out["E4 stored"] = {"host": stored_host, "collection": stored, "values": values, "ms": ms, "updates": updates,
                            "epoch": epoch, "epoch_ms": epoch_ms, "collectives": collectives,
                            "expected": _syncs_per_epoch(stored)}
        out["flags_kept"] = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                             torch.get_float32_matmul_precision()) == (True, True, "high")
        if device.type == "cuda":
            out["E4 K2"] = _e4_k2(device)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
    return out


# ---- path E's float64 oracles: numpy and scipy, no code shared with the port
def _e1_stats(p, t):
    """Sufficient statistics of one E1 batch in float64; they add across batches."""
    p, t = p.astype(np.float64), t.astype(np.float64)
    d = p - t
    a = np.abs(d)
    eps = 1.17e-6  # MAPE's clamp on the denominator
    return {
        "n": float(len(t)), "sse": (d * d).sum(), "sae": a.sum(),
        "ssle": ((np.log1p(p) - np.log1p(t)) ** 2).sum(),
        "mape": (a / np.maximum(np.abs(t), eps)).sum(), "smape": (2 * a / np.maximum(np.abs(p) + np.abs(t), eps)).sum(),
        "abs_t": np.abs(t).sum(), "st": t.sum(), "stt": (t * t).sum(), "sp": p.sum(), "spp": (p * p).sum(),
        "spt": (p * t).sum(), "cube": (a**3).sum(), "logcosh": (a + np.log1p(np.exp(-2 * a)) - np.log(2)).sum(),
        # Tweedie deviance at power 1.5: 2 (y^0.5 / -0.25 + 2 y mu^-0.5 + 2 mu^0.5)
        "tweedie": (2 * (-4 * np.sqrt(t) + 2 * t / np.sqrt(p) + 2 * np.sqrt(p))).sum(),
    }


def _e1_values(s):
    n = s["n"]
    mp, mt = s["sp"] / n, s["st"] / n
    var_p, var_t = s["spp"] / n - mp**2, s["stt"] / n - mt**2
    cov = s["spt"] / n - mp * mt
    ss_tot = s["stt"] - s["st"] ** 2 / n
    mean_err = (s["st"] - s["sp"]) / n
    return {
        "MeanSquaredError": s["sse"] / n, "MeanAbsoluteError": s["sae"] / n, "MeanSquaredLogError": s["ssle"] / n,
        "MeanAbsolutePercentageError": s["mape"] / n, "SymmetricMeanAbsolutePercentageError": s["smape"] / n,
        "WeightedMeanAbsolutePercentageError": s["sae"] / s["abs_t"],
        "ExplainedVariance": 1 - (s["sse"] / n - mean_err**2) / var_t,
        "R2Score": 1 - s["sse"] / ss_tot, "RelativeSquaredError": s["sse"] / ss_tot,
        "PearsonCorrcoef": cov / np.sqrt(var_p * var_t),
        "ConcordanceCorrCoef": 2 * cov / (var_p + var_t + (mp - mt) ** 2),
        "MinkowskiDistance": s["cube"] ** (1 / 3), "LogCoshError": s["logcosh"] / n,
        "TweedieDevianceScore": s["tweedie"] / n,
    }


def _e2_stats(p, q):
    p, q = p.astype(np.float64), q.astype(np.float64)
    p, q = p / p.sum(1, keepdims=True), q / q.sum(1, keepdims=True)
    cos = (p * q).sum(1) / (np.linalg.norm(p, axis=1) * np.linalg.norm(q, axis=1))
    return {"n": float(len(p)), "kl": (p * np.log(p / q)).sum(), "cos": cos.sum()}


def _e2_values(s):
    return {"KLDivergence": s["kl"] / s["n"], "CosineSimilarity": s["cos"] / s["n"]}


def _window(k, sigma):
    x = np.arange(k) - (k - 1) / 2
    g = np.exp(-((x / sigma) ** 2) / 2)
    return g / g.sum()


_WINDOW = _window(11, 1.5)


def _blur(x):
    """The 11 x 11, sigma 1.5 gaussian over H and W, ``mode="mirror"`` (the edge pixel not repeated)."""
    import scipy.ndimage as ndi

    return ndi.correlate1d(ndi.correlate1d(x, _WINDOW, axis=-2, mode="mirror"), _WINDOW, axis=-1, mode="mirror")


def _moments(p, t):
    mu_p, mu_t = _blur(p), _blur(t)
    return mu_p, mu_t, _blur(p * p) - mu_p**2, _blur(t * t) - mu_t**2, _blur(p * t) - mu_p * mu_t


def _crop(x):
    return x[..., 5:-5, 5:-5]


def _ssim_maps(p, t, data_range=1.0):
    mu_p, mu_t, var_p, var_t, cov = _moments(p, t)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    cs = (2 * cov + c2) / (var_p + var_t + c2)
    return _crop((2 * mu_p * mu_t + c1) / (mu_p**2 + mu_t**2 + c1) * cs), _crop(cs)


def _e4_chunk_stats(p, t):
    """Per-image float64 values of one chunk of images: SSIM map sum, MS-SSIM, UQI map sum, SSE, TV, SAM,
    ERGAS."""
    p, t = p.astype(np.float64), t.astype(np.float64)
    ssim_map, _ = _ssim_maps(p, t)
    betas = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
    ms, sp, st = np.ones(len(p)), p, t
    for scale, beta in enumerate(betas):
        full, cs = _ssim_maps(sp, st)
        value = (full if scale == len(betas) - 1 else cs).mean(axis=(1, 2, 3))
        ms *= np.maximum(value, 0) ** beta
        h, w = sp.shape[-2] // 2 * 2, sp.shape[-1] // 2 * 2
        sp, st = (x[..., :h, :w].reshape(*x.shape[:2], h // 2, 2, w // 2, 2).mean(axis=(3, 5)) for x in (sp, st))
    mu_p, mu_t, var_p, var_t, cov = _moments(p, t)
    uqi = _crop(4 * cov * mu_p * mu_t / ((var_p + var_t) * (mu_p**2 + mu_t**2)))
    d = p - t
    cos = (p * t).sum(1) / np.sqrt((p * p).sum(1) * (t * t).sum(1))
    return {
        "ssim": ssim_map.sum(axis=(1, 2, 3)), "ssim_pixels": ssim_map[0].size, "ms_ssim": ms,
        "uqi": uqi.sum(axis=(1, 2, 3)), "uqi_pixels": uqi[0].size, "sse": (d * d).sum(axis=(1, 2, 3)),
        "tv": np.abs(np.diff(p, axis=2)).sum(axis=(1, 2, 3)) + np.abs(np.diff(p, axis=3)).sum(axis=(1, 2, 3)),
        "sam": np.arccos(np.clip(cos, -1, 1)).mean(axis=(1, 2)),
        "ergas": 100 * 4.0 * np.sqrt(((d * d).mean(axis=(2, 3)) / t.mean(axis=(2, 3)) ** 2).mean(axis=1)),
    }


def _e4_stats(p, t):
    """Per-image values of one E4 batch, two images a thread (scipy's filters release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        parts = list(pool.map(lambda i: _e4_chunk_stats(p[i:i + 2], t[i:i + 2]), range(0, len(p), 2)))
    out = {k: np.concatenate([x[k] for x in parts]) for k in parts[0] if not k.endswith("_pixels")}
    out.update({k: parts[0][k] * len(p) for k in ("ssim_pixels", "uqi_pixels")})
    out["pixels"] = float(p[0].size * len(p))
    return out


def _ssim_inferred_range(p, t):
    """Float64 SSIM over a batch with the range inferred as the port does: the larger of the two spans."""
    from concurrent.futures import ThreadPoolExecutor

    data_range = max(float(p.max()) - float(p.min()), float(t.max()) - float(t.min()))
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        maps = list(pool.map(lambda i: _ssim_maps(p[i:i + 2].astype(np.float64), t[i:i + 2].astype(np.float64),
                                                  data_range)[0], range(0, len(p), 2)))
    return np.concatenate(maps).mean()


def _e4_values(stats):
    """E4's values in float64 from a list of per-batch stats (the epoch: all of them)."""
    cat = {k: np.concatenate([s[k] for s in stats]) for k in stats[0] if not k.endswith("pixels")}
    return {
        "SSIM": cat["ssim"].sum() / sum(s["ssim_pixels"] for s in stats),
        "MultiScaleSSIM": cat["ms_ssim"].mean(),
        "PSNR": 10 * np.log10(1.0 / (cat["sse"].sum() / sum(s["pixels"] for s in stats))),
        "UniversalImageQualityIndex": cat["uqi"].sum() / sum(s["uqi_pixels"] for s in stats),
        "TotalVariation": cat["tv"].sum(),
        "SpectralAngleMapper": cat["sam"].mean(),
        "ErrorRelativeGlobalDimensionlessSynthesis": cat["ergas"].mean(),
    }


def _e_close(label, got, cpu, oracle, rtol, atol=0.0):
    g = float(got)
    if cpu is not None and not np.isclose(g, float(cpu), rtol=rtol, atol=atol):
        raise AssertionError(f"{label}: card {g} vs CPU {float(cpu)} (rtol {rtol}, atol {atol})")
    if not np.isclose(g, oracle, rtol=rtol, atol=atol):
        raise AssertionError(f"{label}: card {g} vs float64 oracle {oracle} (rtol {rtol}, atol {atol})")
    return abs(g - oracle) / abs(oracle)


def _e4_tol(name):
    """(rtol, atol) of an E4 value."""
    return (0.0, ATOL_SSIM) if name in ("SSIM", "MultiScaleSSIM", "UniversalImageQualityIndex") else (RTOL_E4, 0.0)


def _e_states_equal(label, gpu_col, cpu_col, rtol):
    """Every count state of the card's collection equals the CPU run's exactly, every float state to ``rtol``."""
    import torch

    from metrics_tpu_torch.parallel.buffer import as_values

    for k, m in gpu_col.items():
        for state, value in m._current_state().items():
            got, ref = as_values(value), as_values(getattr(cpu_col[k], state))
            same = (torch.equal(got.cpu(), ref) if not got.is_floating_point()
                    else torch.allclose(got.cpu(), ref, rtol=rtol, atol=0))
            if not same:
                raise AssertionError(f"{label} {k}.{state} differs between the card and the CPU run")


def _e_report(name, run, groups, steps):
    _check(run["updates"] == [groups * (i + 1) for i in range(steps)],
           f"path {name}: {groups} updates a step, one per compute group of the CPU run")
    _check(run["collectives"] == run["expected"],
           f"path {name} epoch compute: {run['collectives']}, one sync a compute group")
    ms = run["ms"]
    print(f"[8] path {name}: {steps} steps: median {statistics.median(ms):.3f} ms/step (first step {ms[0]:.1f} ms);"
          f" epoch compute {run['epoch_ms'][0]:.2f} ms (again: {run['epoch_ms'][1]:.2f} ms)")
    prof = run.get("profile")
    if prof is not None:
        print(f"    path {name} step, profiled: {prof['device_ms']:.3f} ms device time a step"
              f" ({100 * prof['device_ms'] / statistics.median(ms):.1f}% of the median step),"
              f" {prof['ops']:g} device operations, {prof['host_syncs']} synchronizing CUDA calls"
              f" ({', '.join(f'{site} x{n}' for site, n in prof['sync_sites'])})")
        for op in prof["top"]:
            print(f"      {op['us_per_call']:10.1f} us x{op['per_call']:g}  {op['name'][:100]}")
    return {"ms_per_step": statistics.median(ms), "first_step_ms": ms[0], "epoch_ms": run["epoch_ms"],
            "collectives": run["collectives"], "step_profile": prof}


def check_path_e(result):
    """E1-E4 against the port's CPU run and the float64 oracles; counts exactly."""
    import warnings

    import scipy.stats
    import torch

    import metrics_tpu_torch as pt
    from metrics_tpu_torch.parallel.buffer import as_values

    timings = {}
    warnings.simplefilter("ignore")  # the CPU runs warn as the card's did; the card's warnings were recorded
    for name, build, stats, values_of in (("E1", _e1_collection, _e1_stats, _e1_values),
                                          ("E2", _e2_collection, _e2_stats, _e2_values)):
        run = result[name]
        cpu = build("cpu", dist_sync_on_step=True)
        total, worst = None, 0.0
        for step, ((p, t), got) in enumerate(zip(run["host"], run["values"])):
            want = cpu(torch.from_numpy(p), torch.from_numpy(t))
            st = stats(p, t)
            total = st if total is None else {k: total[k] + v for k, v in st.items()}
            oracle = values_of(st)
            for k, v in got.items():
                worst = max(worst, _e_close(f"path {name} step {step} {k}", v, want[k], oracle[k], RTOL_E))
        print(f"  ok: path {name} per-step values equal the CPU run and the float64 oracle (rtol {RTOL_E};"
              f" max rel diff to the oracle {worst:.3g})")
        oracle, want = values_of(total), cpu.compute()
        for k, v in run["epoch"].items():
            rel = _e_close(f"path {name} epoch {k}", v, want[k], oracle[k], RTOL_E)
            print(f"  ok: path {name} epoch {k} = {float(v):.7g} (oracle {oracle[k]:.7g}, rel diff {rel:.3g})")
        _e_states_equal(f"path {name}", run["collection"], cpu, RTOL_E)
        print(f"  ok: path {name} count states equal the CPU run exactly, float sums to rtol {RTOL_E}")
        if name == "E1":
            col, n = run["collection"], int(total["n"])
            _check(int(col["MeanSquaredError"].total) == n and int(col["PearsonCorrcoef"].n_total) == n
                   and float(col["PearsonCorrcoef"].comoments[0]) == n and float(col["ExplainedVariance"].n_obs) == n,
                   f"path E1 counts: int64 totals {n}, and the float32 counts the reference carries"
                   f" (Pearson's n, ExplainedVariance's n_obs) exact at this multiple of the batch")
            warned = any("saturates at 2^24" in w for w in run["warnings"])
            _check(warned == (n >= 2**24), f"path E1 epoch compute {'warned' if warned else 'did not warn'} that"
                                           f" Pearson's float32 count passed 2**24 ({n} samples)")
        timings[name] = _e_report(name, run, len(cpu.compute_groups), len(run["host"]))

    for label, run in result["E3"].items():
        kind = label.split()[0]
        fn = scipy.stats.spearmanr if kind == "Spearman" else scipy.stats.kendalltau
        rtol = RTOL_E if kind == "Spearman" else RTOL_KENDALL
        cpu = pt.MetricCollection([(pt.SpearmanCorrcoef if kind == "Spearman" else pt.KendallRankCorrCoef)(device="cpu")])
        key = next(iter(run["epoch"]))
        for step, ((p, t), got) in enumerate(zip(run["host"], run["values"])):
            want = cpu(torch.from_numpy(p), torch.from_numpy(t))[key]
            _e_close(f"path E3 {label} step {step}", got[key], want, fn(p, t).statistic, rtol)
        all_p = np.concatenate([p for p, _ in run["host"]])
        all_t = np.concatenate([t for _, t in run["host"]])
        want, oracle = cpu.compute()[key], fn(all_p, all_t).statistic
        rel = _e_close(f"path E3 {label} epoch", run["epoch"][key], want, oracle, rtol)
        if kind == "Kendall":
            _check(torch.equal(run["epoch"][key].cpu(), want), f"path E3 {label}: tau equals the CPU run bit for bit")
        kept = [len(as_values(getattr(run["collection"][key], s))) for s in ("preds_all", "target_all")]
        _check(kept == [len(all_p)] * 2, f"path E3 {label}: every row kept ({kept})")
        print(f"  ok: path E3 {label} epoch over {len(all_p)} samples = {float(run['epoch'][key]):.7g}"
              f" (scipy {oracle:.7g}, rel diff {rel:.3g}; CPU run equal to rtol {rtol})")
        timings[f"E3 {label}"] = _e_report(f"E3 {label}", run, 1, len(run["host"]))
    for kind in ("Spearman", "Kendall"):
        a, b = (float(result["E3"][f"{kind} {m}"]["epoch"][next(iter(result["E3"][f"{kind} list"]["epoch"]))])
                for m in ("list", "capacity"))
        _check(np.isclose(a, b, rtol=1e-6, atol=0), f"path E3 {kind}: list mode {a:.7g} = capacity mode {b:.7g}")

    run = result["E4"]
    cpu = _e4_collection("cpu", dist_sync_on_step=True)
    all_stats, worst = [], {}
    for step, ((p, t), got) in enumerate(zip(run["host"], run["values"])):
        want = _e4_call(cpu, (torch.from_numpy(p), torch.from_numpy(t))) if step < E4_CPU_STEPS else None
        if step == E4_CPU_STEPS - 1:
            for k, m in cpu.items():
                for state, ref in _count_states(m).items():
                    if not torch.equal(run["counts_at_cpu_steps"][k][state].cpu(), ref):
                        raise AssertionError(f"path E4 {k}.{state} after {E4_CPU_STEPS} steps differs from the CPU run")
        all_stats.append(_e4_stats(p, t))
        oracle = _e4_values(all_stats[-1:])
        for k, v in got.items():
            rel = _e_close(f"path E4 step {step} {k}", v, None if want is None else want[k], oracle[k], *_e4_tol(k))
            worst[k] = max(worst.get(k, 0.0), abs(float(v) - oracle[k]))
    print(f"  ok: path E4 per-step values equal the CPU run (steps 0-{E4_CPU_STEPS - 1}) and, every step, the float64"
          f" oracle (SSIM, MS-SSIM, UQI atol {ATOL_SSIM}, the rest rtol {RTOL_E4}); max abs diff to the oracle"
          f" {', '.join(f'{k} {v:.3g}' for k, v in worst.items())}")
    print(f"  ok: path E4 count states after {E4_CPU_STEPS} steps equal the CPU run's exactly")
    oracle = _e4_values(all_stats)
    for k, v in run["epoch"].items():
        rel = _e_close(f"path E4 epoch {k}", v, None, oracle[k], *_e4_tol(k))
        print(f"  ok: path E4 epoch {k} = {float(v):.7g} (oracle {oracle[k]:.7g}, rel diff {rel:.3g})")
    col = run["collection"]
    images = len(run["host"]) * E4_SHAPE[0]
    _check(int(col["TotalVariation"].num_images) == images == int(col["MultiScaleSSIM"].count)
           and int(col["PSNR"].total) == images * int(np.prod(E4_SHAPE[1:])),
           f"path E4 epoch counts: {images} images, {int(col['PSNR'].total)} pixels (int64)")
    _check(result["flags_kept"], "path E4 ran with TF32 allowed (cuDNN and matmul, precision 'high'), and its calls"
                                  " left those flags as they were")
    timings["E4"] = _e_report("E4", run, len(cpu.compute_groups), len(run["host"]))
    timings["E4"]["peak_bytes"] = run["peak_bytes"]
    if "E4 K2" in result:
        steps = len(run["host"])
        _check((run["k2_launches"], run["k2_plain_cuda_calls"]) == (7 * steps, 0),
               f"path E4: kernel K2 launched {run['k2_launches']} times over {steps} steps (SSIM 1, MS-SSIM 5, UQI 1"
               f" a step) and the plain filter ran {run['k2_plain_cuda_calls']} times on the card")
        k2 = result["E4 K2"]
        names = k2["device_op_names"]
        _check(k2["launches_per_call"] == 1 and len(names) == 1 and "ssim_filter_kernel" in names[0],
               f"K2 at {E4_SHAPE} is one device operation per call, no fill or copy ({names}; recorded"
               f" {k2['launches_per_call']:g} a call in the fullest of {K1_PROFILE_SESSIONS} sessions)")
        for row in k2["compared"]:
            _check(row["equal"] and row["sums_rel"] < 1e-5,
                   f"K2 {row['form']} {row['shape']}: maps equal the plain version's on the card bit for bit (max abs"
                   f" diff {row['max_abs']:.3g}), per-block sums within rtol 1e-5 of the maps' sums"
                   f" ({row['sums_rel']:.3g})")
        print(f"    K2 at {E4_SHAPE}: {k2['ms']['ssim_sums']:.4f} ms (device, L2 cold, median of {K2_REPS}; sums),"
              f" {k2['ms']['ssim_maps']:.4f} (maps), UQI {k2['ms']['uqi_sums']:.4f}, batch 8"
              f" {k2['ms']['ssim_sums_batch8']:.4f}; {k2['ms_back_to_back']:.4f} ms a call back to back; host"
              f" enqueue {k2['host_enqueue_us']:.2f} us; bound {k2['bound_ms']:.4f} ms (float32 FMA); plain"
              f" {k2['plain_ms']:.3f} ms; {k2['launches_per_call']:g} device operation a call")
        timings["E4"]["k2"] = dict(k2, launches=run["k2_launches"])
    if run["peak_bytes"] is not None:
        print(f"    path E4 peak device memory {run['peak_bytes'] / 2**20:.0f} MiB")

    run = result["E4 stored"]
    cpu = pt.MetricCollection([pt.SSIM(device="cpu")])
    for step, ((p, t), got) in enumerate(zip(run["host"], run["values"])):
        want = cpu(torch.from_numpy(p), torch.from_numpy(t))["SSIM"]
        _e_close(f"path E4 stored step {step}", got["SSIM"], want, _ssim_inferred_range(p, t), *_e4_tol("SSIM"))
    all_p = np.concatenate([p for p, _ in run["host"]])
    all_t = np.concatenate([t for _, t in run["host"]])
    oracle = _ssim_inferred_range(all_p, all_t)
    rel = _e_close("path E4 stored epoch", run["epoch"]["SSIM"], cpu.compute()["SSIM"], oracle, *_e4_tol("SSIM"))
    m = run["collection"]["SSIM"]
    _check(len(m.y) == len(run["host"]) and tuple(m.y[0].shape) == E4_SHAPE,
           f"path E4 stored SSIM: {len(m.y)} 4-D states of {E4_SHAPE} gathered at compute() (rel diff to the oracle"
           f" {rel:.3g})")
    timings["E4 stored"] = _e_report("E4 stored", run, 1, len(run["host"]))
    return timings


# ------------------------------------------------------------------------------------------- path F
def _f_collection(device, **kw):
    import metrics_tpu_torch as pt

    return pt.MetricCollection([
        pt.RetrievalMAP(device=device, **kw),
        # MS MARCO's official MRR counts a query with no relevant candidate as 0
        pt.RetrievalMRR(query_without_relevant_docs="neg", device=device, **kw),
        pt.RetrievalPrecision(k=10, device=device, **kw),
        pt.RetrievalRecall(k=100, device=device, **kw),
        pt.RetrievalHitRate(k=10, device=device, **kw),
        pt.RetrievalFallOut(k=10, device=device, **kw),
        pt.RetrievalRPrecision(device=device, **kw),
        pt.RetrievalNormalizedDCG(k=10, device=device, **kw),
    ])


def _f_batches():
    """The epoch: 7,168 queries with sparse int32 ids, 1,000 candidates each. About 15% of the queries hold
    no relevant candidate (a first-stage miss), the others 1-3 graded 1-3 (TREC Deep Learning's grades);
    scores sigmoid(N(0, 1) + 1.5 grade) on a 2**-12 grid (ties in every query), 16 of them NaN, 0.5% of
    the rows the exclude sentinel -100. In query order, rotated by 500 rows and cut into 28 steps of
    256,000 rows, each step's rows shuffled."""
    rng = np.random.default_rng(14)
    q, c = F_QUERIES, F_CANDIDATES
    qids = rng.permutation(np.unique(rng.integers(0, 2**31 - 1, 2 * q)))[:q].astype(np.int32)
    positions = np.argpartition(rng.random((q, c)), 3, axis=1)[:, :3]
    relevant = (np.arange(3)[None, :] < rng.integers(1, 4, (q, 1))) & (rng.random((q, 1)) >= 0.15)
    grades = np.zeros((q, c), np.int32)
    np.put_along_axis(grades, positions, np.where(relevant, rng.integers(1, 4, (q, 3)), 0).astype(np.int32), axis=1)
    logits = rng.standard_normal((q, c), dtype=np.float32) + 1.5 * grades
    scores = (np.round(4096 / (1 + np.exp(-logits))) / 4096).astype(np.float32).reshape(-1)
    scores[rng.choice(q * c, F_NAN, replace=False)] = np.nan
    target = grades.reshape(-1)
    target[rng.random(q * c) < 0.005] = -100
    idx = np.repeat(qids, c)
    epoch = [np.roll(x, F_ROTATE) for x in (idx, scores, target)]
    batches = []
    for step in range(F_STEPS):
        perm = rng.permutation(F_BATCH) + step * F_BATCH
        batches.append(tuple(x[perm] for x in epoch))
    return batches


def _f_integers(idx, preds, target):
    """The per-query integer quantities of an epoch, in query-id order: relevant rows, hits in the top 10
    and top 100, the rank of the first relevant row (0: none) and the valid rows, computed by the port's
    segment functions on the tensors' device with the modules' neutralized sentinel rows."""
    import torch

    from metrics_tpu_torch.functional.retrieval.segments import first_relevant_rank, grouped_topk_hits

    dense = torch.unique(idx, return_inverse=True)[1]
    n = int(dense.max()) + 1
    excluded = target == -100
    preds, target = torch.where(excluded, float("-inf"), preds), torch.where(excluded, 0, target)
    hits10, rel, valid = grouped_topk_hits(dense, preds, target, n, 10, ~excluded)
    hits100, _, _ = grouped_topk_hits(dense, preds, target, n, 100, ~excluded)
    return {"relevant": rel, "hits@10": hits10, "hits@100": hits100,
            "first_hit_rank": first_relevant_rank(dense, preds, target, n), "valid": valid}


def run_path_f(device):
    """Path F inside the caller's process group: the eight retrieval metrics in one compute group, list and
    capacity states, synced at ``compute()``; timed, updates and epoch collectives counted, both epochs
    profiled, peak device memory read."""
    import torch

    host = _f_batches()
    batches = _to(device, host)
    _sync(device)
    base = torch.cuda.memory_allocated() if device.type == "cuda" else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    runs = {}
    for mode, kw in (("list", {}), ("capacity", {"capacity": F_CAPACITY})):
        col = _f_collection(device, **kw)
        values, ms, updates = _forward_counted(col, batches)
        epoch, epoch_ms, collectives, _ = _epoch_timed(col, device)
        runs[mode] = {"collection": col, "values": values, "ms": ms, "updates": updates, "epoch": epoch,
                      "epoch_ms": epoch_ms, "collectives": collectives, "expected": _syncs_per_epoch(col)}
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    for run in runs.values():
        col = run["collection"]

        def fresh_compute(col=col):
            for m in col.values():
                m._computed = None
            col.compute()

        run["profile"] = _profile_call(fresh_compute, calls=3) if device.type == "cuda" else None
    epoch_rows = [torch.cat([b[i] for b in batches]) for i in range(3)]
    integers = {k: v.cpu() for k, v in _f_integers(*epoch_rows).items()}
    return {"host": host, "runs": runs, "integers": integers, "base_bytes": base, "peak_bytes": peak}


def _f_oracle(idx, preds, target):
    """The eight values and the per-query integer quantities in float64 numpy, from the metrics'
    definitions: rows ranked by (query, score descending, row), NaN scores last; a sentinel row (-100)
    keeps its place in its query with score -inf and no gain, so it ranks after every real score and
    before the NaN scores (the reference's masking), and counts neither as relevant nor as a document.
    A query is empty when its raw target sum is 0 (the reference's rule: a sentinel makes a query
    non-empty); for fall-out when it has no valid non-relevant row. 'skip' averages over the other
    queries, 'neg' scores an empty query 0."""
    n = len(idx)
    excluded = target == -100
    score = np.where(excluded, -np.inf, preds.astype(np.float64))
    nan = np.isnan(score)
    order = np.lexsort((np.arange(n), np.where(nan, 0.0, -score), nan, idx))
    q, raw, ex = idx[order], target[order], excluded[order]
    gain = np.where(ex, 0, raw).astype(np.float64)
    starts = np.flatnonzero(np.r_[True, q[1:] != q[:-1]])
    counts = np.diff(np.r_[starts, n])
    nq = len(starts)
    seg = np.repeat(np.arange(nq), counts)
    rank = np.arange(n) - starts[seg] + 1
    rel = gain > 0
    per = lambda w: np.bincount(seg, weights=w, minlength=nq)  # noqa: E731
    count = lambda w: np.rint(per(w.astype(np.float64))).astype(np.int64)  # noqa: E731
    n_rel = count(rel)
    scan = np.cumsum(rel)
    so_far = scan - np.r_[0, scan][starts][seg]
    ap = per(np.where(rel, so_far / rank, 0.0)) / np.maximum(n_rel, 1)
    first = np.full(nq, n + 1)
    np.minimum.at(first, seg[rel], rank[rel])
    first = np.where(first > n, 0, first)
    hits10, hits100 = count(rel & (rank <= 10)), count(rel & (rank <= 100))
    neg = (gain <= 0) & ~ex
    neg_total, false10 = count(neg), count(neg & (rank <= 10))
    r_hits = count(rel & (rank <= n_rel[seg]))
    discount = np.where(rank <= 10, 1.0 / np.log2(rank + 1.0), 0.0)
    ideal = np.lexsort((-gain, seg))  # each query's gains in descending order, in the query's own positions
    ndcg_num, ndcg_den = per(gain * discount), per(gain[ideal] * discount)
    safe = lambda a, b: np.where(b > 0, a / np.maximum(b, 1e-300), 0.0)  # noqa: E731
    per_query = {
        "RetrievalMAP": ap, "RetrievalMRR": np.where(first > 0, 1.0 / np.maximum(first, 1), 0.0),
        "RetrievalPrecision": hits10 / 10.0, "RetrievalRecall": safe(hits100, n_rel),
        "RetrievalHitRate": (hits10 > 0).astype(np.float64), "RetrievalFallOut": safe(false10, neg_total),
        "RetrievalRPrecision": safe(r_hits, n_rel), "RetrievalNormalizedDCG": safe(ndcg_num, ndcg_den),
    }
    empty = per(raw.astype(np.float64)) == 0
    values = {}
    for name, v in per_query.items():
        e = (neg_total == 0) if name == "RetrievalFallOut" else empty
        if name == "RetrievalMRR":  # query_without_relevant_docs="neg"
            values[name] = float(np.mean(np.where(e, 0.0, v)))
        else:
            values[name] = float(np.mean(v[~e])) if (~e).any() else 0.0
    integers = {"relevant": n_rel, "hits@10": hits10, "hits@100": hits100, "first_hit_rank": first,
                "valid": count(~ex)}
    return values, integers, int(empty.sum())


def check_path_f(result):
    """Both modes against the port's CPU run and the float64 oracle, per step and at the epoch; the
    per-query integer quantities exactly; one update a step, one gather at the epoch, no synchronizing
    call in the list-mode epoch compute beyond the gather's two."""
    import warnings

    import torch

    from metrics_tpu_torch.parallel.buffer import as_values

    host, runs = result["host"], result["runs"]
    warnings.simplefilter("ignore")
    cpu = _f_collection("cpu")
    worst = {"cpu": 0.0, "oracle": 0.0}
    for step, (i, p, t) in enumerate(host):
        args = tuple(torch.from_numpy(x) for x in (i, p, t))
        want = cpu(*args) if step < F_CPU_STEPS else (cpu.update(*args), None)[1]
        oracle, _, _ = _f_oracle(i, p, t)
        for mode, run in runs.items():
            for k, v in run["values"][step].items():
                g = float(v)
                if want is not None:
                    if not np.isclose(g, float(want[k]), rtol=RTOL_F, atol=0):
                        raise AssertionError(f"path F {mode} step {step} {k}: card {g} vs CPU {float(want[k])}")
                    worst["cpu"] = max(worst["cpu"], abs(g - float(want[k])) / max(abs(float(want[k])), 1e-30))
                if not np.isclose(g, oracle[k], rtol=RTOL_F_ORACLE, atol=0):
                    raise AssertionError(f"path F {mode} step {step} {k}: card {g} vs float64 oracle {oracle[k]}")
                worst["oracle"] = max(worst["oracle"], abs(g - oracle[k]) / max(abs(oracle[k]), 1e-30))
    print(f"  ok: path F per-step values of both modes equal the CPU run (steps 0-{F_CPU_STEPS - 1}, rtol {RTOL_F};"
          f" max rel diff {worst['cpu']:.3g}) and, every step, the float64 oracle (rtol {RTOL_F_ORACLE};"
          f" max rel diff {worst['oracle']:.3g})")

    epoch_rows = [np.concatenate([b[j] for b in host]) for j in range(3)]
    oracle, oracle_ints, n_empty = _f_oracle(*epoch_rows)
    want = {k: float(v) for k, v in cpu.compute().items()}
    for k in want:
        got = {mode: float(run["epoch"][k]) for mode, run in runs.items()}
        _check(all(np.isclose(g, want[k], rtol=RTOL_F, atol=0) and np.isclose(g, oracle[k], rtol=RTOL_F_ORACLE, atol=0)
                   for g in got.values()),
               f"path F epoch {k}: list {got['list']:.7f}, capacity {got['capacity']:.7f}, CPU {want[k]:.7f},"
               f" oracle {oracle[k]:.7f}")
    cpu_ints = {k: v for k, v in _f_integers(*(torch.from_numpy(x) for x in epoch_rows)).items()}
    for k, v in result["integers"].items():
        if not (torch.equal(v, cpu_ints[k]) and np.array_equal(v.numpy(), oracle_ints[k])):
            raise AssertionError(f"path F per-query {k} differ between the card, the CPU run and the oracle")
    ints = result["integers"]
    print(f"  ok: path F per-query integers over {len(ints['relevant'])} queries equal the CPU run and the oracle"
          f" exactly: relevant rows ({int(ints['relevant'].sum())}), hits in the top 10 / 100, first-hit ranks,"
          f" valid rows ({int(ints['valid'].sum())}); {n_empty} queries empty by the raw-target rule,"
          f" {int((ints['relevant'] == 0).sum())} with no relevant row")
    rows = sum(len(b[0]) for b in host)
    timings = {}
    for mode, run in runs.items():
        col = run["collection"]
        kept = [len(as_values(getattr(col["RetrievalMAP"], s))) for s in ("idx", "preds", "target")]
        _check(kept == [rows] * 3, f"path F {mode}: every row kept in each state ({kept[0]})")
        _check(run["updates"] == [i + 1 for i in range(len(host))] and len(col.compute_groups) == 1,
               f"path F {mode}: the eight members form one compute group, one update a step")
        _check(run["collectives"] == run["expected"] == {"all_reduce": 0, "all_gather": 3},
               f"path F {mode} epoch compute: {run['collectives']}: one gather for the group (layout, int32, float32)")
        ms, prof = run["ms"], run["profile"]
        print(f"[9] path F {mode}: {len(host)} steps of {F_BATCH} rows: median {statistics.median(ms):.3f} ms/step"
              f" (first step {ms[0]:.1f} ms); epoch compute of {rows} rows {run['epoch_ms'][0]:.2f} ms"
              f" (again: {run['epoch_ms'][1]:.2f} ms)")
        timing = {"ms_per_step": statistics.median(ms), "first_step_ms": ms[0], "epoch_ms": run["epoch_ms"],
                  "collectives": run["collectives"], "epoch_profile": prof}
        if prof is not None:
            timing["sort_share"] = prof["sort_ms"] / prof["device_ms"]
            print(f"    path F {mode} epoch compute, profiled: {prof['device_ms']:.3f} ms device time"
                  f" ({100 * prof['device_ms'] / run['epoch_ms'][1]:.1f}% of the second epoch compute),"
                  f" sort kernels {prof['sort_ms']:.3f} ms ({100 * timing['sort_share']:.1f}%), {prof['ops']:g} device"
                  f" operations, {prof['host_syncs']} synchronizing CUDA calls"
                  f" ({', '.join(f'{site} x{n}' for site, n in prof['sync_sites'])})")
            for op in prof["top"]:
                print(f"      {op['us_per_call']:10.1f} us x{op['per_call']:g}  {op['name'][:100]}")
            if mode == "list":
                _check(prof["host_syncs"] == 2 and all(site.startswith("metrics_tpu_torch/parallel/sync.py")
                                                        for site, _ in prof["sync_sites"]),
                       "path F list-mode epoch compute: no synchronizing call but the gather's two (its layout table)")
        timings[mode] = timing
    if result["peak_bytes"] is not None:
        print(f"    path F peak device memory {result['peak_bytes'] / 2**20:.0f} MiB"
              f" ({(result['peak_bytes'] - result['base_bytes']) / 2**20:.0f} MiB above the"
              f" {result['base_bytes'] / 2**20:.0f} MiB held before path F)")
    return {"ms_per_step": timings["list"]["ms_per_step"], "modes": timings, "peak_bytes": result["peak_bytes"],
            "base_bytes": result["base_bytes"]}


# ------------------------------------------------------------------------------------------- path G
def _g_key_counts_class():
    """A metric of the script's own: key counts in a count-min state declared through ``add_state``."""
    import torch

    from metrics_tpu_torch.core.metric import Metric
    from metrics_tpu_torch.parallel.cms import CMSTail, CountMinSketch, cms_scatter, cms_total, make_cms_spec

    class KeyCounts(Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("tail", default=make_cms_spec(CMSTail(), (), torch.int64), dist_reduce_fx="sum")

        def update(self, buckets):
            ones = torch.ones(buckets.shape[0], dtype=torch.int64, device=buckets.device)
            self.tail = CountMinSketch(cms_scatter(self.tail.counts, buckets, ones))

        def compute(self):
            return cms_total(self.tail.counts)

    return KeyCounts


def _g_collection(part, device, **kw):
    import metrics_tpu_torch as pt

    kw = dict(device=device, **kw)
    members = {
        "G1": lambda: [pt.AUROC(approx="sketch", num_bins=G_BINS, **kw),
                       pt.AveragePrecision(approx="sketch", num_bins=G_BINS, **kw),
                       pt.ROC(approx="sketch", num_bins=G_BINS, **kw),
                       pt.PrecisionRecallCurve(approx="sketch", num_bins=G_BINS, **kw)],
        "G1q": lambda: [pt.AUROC(approx="qsketch", **kw), pt.AveragePrecision(approx="qsketch", **kw)],
        "G2": lambda: [pt.AUROC(approx="sketch", num_classes=A_CLASSES, num_bins=G_BINS, **kw),
                       pt.AveragePrecision(approx="sketch", num_classes=A_CLASSES, num_bins=G_BINS, **kw)],
        "G3": lambda: [pt.SpearmanCorrcoef(approx="sketch", num_bins=G_RANK_BINS, **kw),
                       pt.KendallRankCorrCoef(approx="sketch", num_bins=G_RANK_BINS, **kw)],
        "G3q": lambda: [pt.SpearmanCorrcoef(approx="qsketch", **kw), pt.KendallRankCorrCoef(approx="qsketch", **kw)],
        "G4": lambda: [pt.Quantile(q=G4_Q, **kw), pt.Percentile(p=G4_P, **kw)],
        "G4mae": lambda: [pt.MedianAbsoluteError(**kw)],
        "G5": lambda: [_g_key_counts_class()(**kw)],
    }[part]
    return pt.MetricCollection(members())


# the data each part runs on, by the name run_path_g gives it
_G_DATA = {"G1": "scores", "G1q": "logits", "G2": "probs", "G3": "pairs", "G3q": "pairs", "G4": "latency",
           "G4mae": "pairs", "G5": "buckets"}


def _g_latencies():
    """Request latencies in seconds: lognormal, 20 ms median, sigma 1; 0.1% outliers at 50x; 0.05% exact zeros;
    16 NaN and 4 +inf a step."""
    rng = np.random.default_rng(13)
    steps = []
    for _ in range(G_STEPS):
        x = 0.02 * rng.lognormal(0.0, 1.0, G4_N)
        x[rng.random(G4_N) < 0.001] *= 50
        x[rng.random(G4_N) < 0.0005] = 0.0
        x = x.astype(np.float32)
        x[rng.choice(G4_N, 20, replace=False)] = [np.nan] * 16 + [np.inf] * 4
        steps.append((x,))
    return steps


def _g_keys():
    """Int keys drawn Zipf(1.1) over 1,000,000 distinct keys, and their (N, 4) count-min buckets on the host."""
    from metrics_tpu_torch.parallel.cms import CMSTail, cms_buckets, stable_key_hash_array

    tail = CMSTail()
    rng = np.random.default_rng(14)
    cdf = np.cumsum(np.arange(1, G5_KEYS + 1, dtype=np.float64) ** -1.1)
    keys, buckets, hash_ms = [], [], []
    for _ in range(G_STEPS):
        k = np.searchsorted(cdf, rng.random(G5_N) * cdf[-1]).astype(np.int64)
        t0 = time.perf_counter()
        buckets.append((cms_buckets(stable_key_hash_array(k), tail.depth, tail.width, tail.seed),))
        hash_ms.append((time.perf_counter() - t0) * 1e3)
        keys.append(k)
    return keys, buckets, hash_ms


def _g_host(value):
    """A step's value on the host: numpy arrays, keeping tuples."""
    if isinstance(value, (list, tuple)):
        return tuple(_g_host(v) for v in value)
    return value.detach().cpu().numpy()


def _g_counts(collection):
    """{member: {state: int64 counts on the host}} of a collection of sketch metrics."""
    return {k: {s: v.counts.cpu().numpy() for s, v in m._current_state().items()} for k, m in collection.items()}


def run_path_g(device, a_batches, b_batches):
    """Path G inside the caller's process group: every sketch collection forward with ``dist_sync_on_step``; the
    updates and ``all_reduce`` calls of each step counted, the epoch compute timed, a step of G1-G4 profiled with
    its synchronizing calls, the count states and state bytes read."""
    import torch

    from metrics_tpu_torch.parallel.sketch import sketch_nbytes

    keys, buckets, hash_ms = _g_keys()
    data = {
        "scores": [(s, t) for s, t in b_batches],
        "logits": [(torch.logit(s), t) for s, t in b_batches],
        "probs": list(a_batches),
        "pairs": _to(device, _e1_batches()),
        "latency": _to(device, _g_latencies()),
        "buckets": [(torch.from_numpy(b),) for (b,) in buckets],  # copied to the card in the step
    }
    _sync(device)
    host = {k: [tuple(x.cpu().numpy() for x in b) for b in v] for k, v in data.items() if k != "buckets"}
    host["buckets"] = list(buckets)
    out = {"host": host, "keys": keys, "hash_ms": hash_ms, "parts": {}}
    for part, kind in _G_DATA.items():
        col = _g_collection(part, device, dist_sync_on_step=True)
        values, ms, updates, reduces = [], [], [], []
        for batch in data[kind]:
            with _CountUpdates() as up, _CountCollectives() as coll:
                t0 = time.perf_counter()
                step_in = tuple(x.to(device) for x in batch)
                values.append({k: _g_host(v) for k, v in col(*step_in).items()})
                _sync(device)
                ms.append((time.perf_counter() - t0) * 1e3)
            updates.append(up[0])
            reduces.append(coll["all_reduce"])
        epoch, epoch_ms, collectives, _ = _epoch_timed(col, device)
        run = {"collection": col, "values": values, "ms": ms, "updates": updates, "reduces": reduces,
               "epoch": {k: _g_host(v) for k, v in epoch.items()}, "epoch_ms": epoch_ms, "collectives": collectives,
               "groups": len(col.compute_groups), "counts": _g_counts(col), "step_reduces": _packed_step_reduces(col),
               "bytes": {k: sum(sketch_nbytes(v) for v in m._current_state().values()) for k, m in col.items()}}
        bounds = {}
        for k, m in col.items():
            for name in ("error_bound", "collision_bound"):
                if hasattr(m, name):
                    bounds[k] = _g_host(getattr(m, name)())
        run["bounds"] = bounds
        if device.type == "cuda" and part != "G5":
            fresh = _g_collection(part, device, dist_sync_on_step=True)
            first = data[kind][0]
            run["profile"] = _profile_call(lambda fresh=fresh, first=first: fresh(*first))
        out["parts"][part] = run
    return out


# ---- path G's oracles: numpy, no code shared with the port
def _g_linear_bins(x, num_bins):
    """The linear grid on [0, 1): the JAX package's float32 ``floor(x * B)``, clipped into the end bins."""
    return np.clip(np.floor(x.astype(np.float32) * np.float32(num_bins)), 0, num_bins - 1).astype(np.int64)


def _g_softsign_bins(x, num_bins):
    """The range-free rank grid: the soft-sign squash in float32, then the linear grid."""
    x = x.astype(np.float32)
    with np.errstate(invalid="ignore"):
        t = np.where(np.isinf(x), np.sign(x), x / (np.float32(1.0) + np.abs(x))).astype(np.float32)
    return _g_linear_bins(np.float32(0.5) + np.float32(0.5) * t, num_bins)


def _g_q_buckets(x, alpha, min_value, max_value):
    """The float64-exact bucket of each value on the qsketch grid."""
    gamma = (1.0 + alpha) / (1.0 - alpha)
    m = max(int(np.ceil(np.log(max_value / min_value) / np.log(gamma))), 1)
    edges = min_value * gamma ** np.arange(m + 1, dtype=np.float64)
    return m + 1 + np.sign(x).astype(np.int64) * np.searchsorted(edges, np.abs(x.astype(np.float64)), side="right")


def _g_oracle_counts(part, host_batch):
    """One step's count states from numpy bincounts: {state name: counts}."""
    from metrics_tpu_torch.parallel.cms import CMSTail
    from metrics_tpu_torch.parallel.qsketch import (QSKETCH_ALPHA, QSKETCH_CURVE_ALPHA, QSKETCH_CURVE_RANGE,
                                                    QSKETCH_MAX_VALUE, QSKETCH_MIN_VALUE, QSKETCH_RANK_ALPHA,
                                                    QSKETCH_RANK_RANGE, qsketch_num_buckets)

    if part in ("G1", "G1q"):
        s, t = host_batch
        grid = (QSKETCH_CURVE_ALPHA, *QSKETCH_CURVE_RANGE)
        b, nb = (_g_linear_bins(s, G_BINS), G_BINS) if part == "G1" else (_g_q_buckets(s, *grid),
                                                                          qsketch_num_buckets(*grid))
        keep = ~np.isnan(s)
        return {"hist": np.bincount((np.where(t == 1, 0, 1) * nb + b)[keep], minlength=2 * nb).reshape(2, nb)}
    if part == "G2":
        p, labels = host_batch
        classes = np.arange(p.shape[1])
        row = np.where(labels[:, None] == classes[None, :], 0, 1)
        flat = (classes[None, :] * 2 + row) * G_BINS + _g_linear_bins(p, G_BINS)
        return {"hist": np.bincount(flat.reshape(-1), minlength=p.shape[1] * 2 * G_BINS).reshape(p.shape[1], 2,
                                                                                                    G_BINS)}
    if part in ("G3", "G3q"):
        p, t = host_batch
        if part == "G3":
            bi, bj, nb = _g_softsign_bins(p, G_RANK_BINS), _g_softsign_bins(t, G_RANK_BINS), G_RANK_BINS
        else:
            grid = (QSKETCH_RANK_ALPHA, *QSKETCH_RANK_RANGE)
            bi, bj, nb = _g_q_buckets(p, *grid), _g_q_buckets(t, *grid), qsketch_num_buckets(*grid)
        keep = ~(np.isnan(p) | np.isnan(t))
        return {"joint": np.bincount((bi * nb + bj)[keep], minlength=nb * nb).reshape(nb, nb)}
    grid = (QSKETCH_ALPHA, QSKETCH_MIN_VALUE, QSKETCH_MAX_VALUE)
    if part in ("G4", "G4mae"):
        x = host_batch[0] if part == "G4" else np.abs(host_batch[0] - host_batch[1])
        keep = ~np.isnan(x)
        return {"qsketch": np.bincount(_g_q_buckets(x[keep], *grid), minlength=qsketch_num_buckets(*grid))}
    tail = CMSTail()
    (b,) = host_batch
    flat = np.arange(tail.depth)[None, :] * tail.width + b
    return {"tail": np.bincount(flat.reshape(-1), minlength=tail.depth * tail.width).reshape(tail.depth, tail.width)}


def _g_curves(counts):
    """(AUROC, AP, fpr, tpr, precision, recall) in float64 from (..., 2, B) counts: suffix sums over the bins and a
    terminal all-rejecting threshold, the trapezoid and the step integral."""
    pos, neg = counts[..., 0, :].astype(np.float64), counts[..., 1, :].astype(np.float64)
    zero = np.zeros(pos.shape[:-1] + (1,))
    tp = np.concatenate([np.cumsum(pos[..., ::-1], -1)[..., ::-1], zero], -1)
    fp = np.concatenate([np.cumsum(neg[..., ::-1], -1)[..., ::-1], zero], -1)
    n_pos, n_neg = pos.sum(-1, keepdims=True), neg.sum(-1, keepdims=True)
    tpr, fpr = tp / np.maximum(n_pos, 1), fp / np.maximum(n_neg, 1)
    auroc = -np.sum((fpr[..., 1:] - fpr[..., :-1]) * (tpr[..., 1:] + tpr[..., :-1]) / 2, -1)
    precision = np.where(tp + fp == 0, 0.0, tp / np.where(tp + fp == 0, 1, tp + fp))
    precision[..., -1] = 1.0
    recall = np.where(n_pos == 0, 0.0, tp / np.maximum(n_pos, 1))
    ap = -np.sum((recall[..., 1:] - recall[..., :-1]) * precision[..., :-1], -1)
    return auroc, ap, fpr, tpr, precision, recall


def _g_ranks(h):
    """(Spearman, Kendall tau-b) in float64 from a (B, B) joint histogram: the counts-weighted correlation of the
    bins' midranks, and concordant minus discordant pairs over the tie-corrected pair count."""
    h = h.astype(np.float64)
    n, p, t = h.sum(), h.sum(1), h.sum(0)
    r = np.cumsum(p) - p / 2 + 0.5 - (n + 1) / 2
    s = np.cumsum(t) - t / 2 + 0.5 - (n + 1) / 2
    spearman = np.sum(h * np.outer(r, s)) / np.sqrt(np.sum(p * r * r) * np.sum(t * s * s))
    below_right = np.zeros_like(h)  # pairs (i' > i, j' > j)
    below_right[:-1, :-1] = np.cumsum(np.cumsum(h[::-1, ::-1], 0), 1)[::-1, ::-1][1:, 1:]
    below = np.zeros_like(h)  # rows i' > i, all columns
    below[:-1] = np.cumsum(h[::-1], 0)[::-1][1:]
    below_left = np.zeros_like(h)  # pairs (i' > i, j' < j)
    below_left[:, 1:] = np.cumsum(below, 1)[:, :-1]
    n0 = n * (n - 1) / 2
    tau = (np.sum(h * below_right) - np.sum(h * below_left)) / np.sqrt(
        (n0 - np.sum(p * (p - 1)) / 2) * (n0 - np.sum(t * (t - 1)) / 2))
    return spearman, tau


def _g_oracle_values(part, counts):
    """{member: value} in float64 from a collection's oracle counts."""
    h = counts["hist"] if "hist" in counts else counts.get("joint")
    if part in ("G1", "G1q", "G2"):
        auroc, ap, fpr, tpr, precision, recall = _g_curves(h)
        values = {"AUROC": auroc.mean() if part == "G2" else auroc, "AveragePrecision": ap}
        if part == "G1":
            values.update({"ROC": (fpr, tpr), "PrecisionRecallCurve": (precision, recall)})
        return values
    if part in ("G3", "G3q"):
        spearman, tau = _g_ranks(h)
        return {"SpearmanCorrcoef": spearman, "KendallRankCorrCoef": tau}
    return None


def _g_close(label, got, want, rtol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if not np.allclose(got, want, rtol=rtol, atol=0.0, equal_nan=True):
        bad = ~np.isclose(got, want, rtol=rtol, atol=0.0, equal_nan=True)
        raise AssertionError(f"{label}: {np.count_nonzero(bad)} values off, e.g. card {got[bad][:3]} vs"
                             f" oracle {want[bad][:3]}")
    nz = want != 0
    return float(np.max(np.abs(got[nz] - want[nz]) / np.abs(want[nz]), initial=0.0))


def check_path_g(result):
    """Every count state against the CPU run and the numpy bincount oracle; values against the float64 oracles;
    the certificates; one update and one all_reduce a compute group a step; no synchronizing call in a profiled
    G1-G4 step."""
    import warnings

    import torch

    from metrics_tpu_torch.parallel.cms import CMSTail, cms_buckets, stable_key_hash_array
    from metrics_tpu_torch.parallel.qsketch import QSKETCH_ALPHA, QSKETCH_MAX_VALUE, QSKETCH_MIN_VALUE

    warnings.simplefilter("ignore")
    host, parts = result["host"], result["parts"]
    timings = {}
    for part, run in parts.items():
        batches = host[_G_DATA[part]]
        # the port's CPU run: one update a step, the same host inputs
        cpu = _g_collection(part, "cpu")
        for batch in batches:
            cpu.update(*(torch.from_numpy(x) for x in batch))
        cpu_counts = _g_counts(cpu)
        total, worst = None, 0.0
        for step, batch in enumerate(batches):
            counts = _g_oracle_counts(part, batch)
            total = counts if total is None else {k: total[k] + v for k, v in counts.items()}
            oracle = _g_oracle_values(part, counts)
            if oracle is None:
                continue
            for k, want in oracle.items():
                got = run["values"][step][k]
                rtol = RTOL_G_RANK if part.startswith("G3") else RTOL_G_CURVE
                if isinstance(want, tuple):
                    worst = max([worst] + [_g_close(f"path {part} step {step} {k}", g, w, rtol)
                                           for g, w in zip(got, want)])
                else:
                    worst = max(worst, _g_close(f"path {part} step {step} {k}", got, want, rtol))
        for member, states in run["counts"].items():
            for name, counts in states.items():
                if not (np.array_equal(counts, cpu_counts[member][name]) and np.array_equal(counts, total[name])):
                    raise AssertionError(f"path {part} {member}.{name}: card counts differ from the CPU run or the"
                                         f" numpy oracle")
        n = int(next(iter(total.values())).sum())
        print(f"  ok: path {part} count states ({', '.join(sorted(total))}, {n} counts) equal the CPU run and the"
              f" numpy bincount oracle bit for bit")
        oracle = _g_oracle_values(part, total)
        if oracle is not None:
            for k, want in oracle.items():
                got = run["epoch"][k]
                rtol = RTOL_G_RANK if part.startswith("G3") else RTOL_G_CURVE
                pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
                worst = max([worst] + [_g_close(f"path {part} epoch {k}", g, w, rtol) for g, w in pairs])
            shown = {k: (float(v) if np.ndim(v) == 0 else f"({np.shape(v)[0]},)") for k, v in run["epoch"].items()
                     if not isinstance(v, tuple)}
            print(f"  ok: path {part} values per step and at the epoch equal the float64 oracle over the oracle counts"
                  f" (rtol {RTOL_G_RANK if part.startswith('G3') else RTOL_G_CURVE}; max rel diff {worst:.3g});"
                  f" epoch {shown}")
        steps = len(batches)
        _check(run["updates"] == [run["groups"]] * steps and run["reduces"] == [run["step_reduces"]] * steps,
               f"path {part}: {run['groups']} compute group(s), one update a group and {run['step_reduces']}"
               f" all_reduce (the step's packed sync, one a (dtype, op) bucket) every step")
        _check(run["collectives"] == {"all_reduce": run["groups"], "all_gather": 0},
               f"path {part} epoch compute: {run['collectives']}, one all_reduce a compute group")
        prof = run.get("profile")
        timing = {"ms_per_step": statistics.median(run["ms"]), "first_step_ms": run["ms"][0],
                  "epoch_ms": run["epoch_ms"], "state_bytes": run["bytes"]}
        print(f"[10] path {part}: {steps} steps: median {timing['ms_per_step']:.3f} ms/step (first step"
              f" {run['ms'][0]:.1f} ms); epoch compute {run['epoch_ms'][0]:.2f} ms (again {run['epoch_ms'][1]:.2f} ms);"
              f" state bytes {run['bytes']}")
        if prof is not None:
            scatter = prof["scatter_ms"]
            timing.update({"profile_device_ms": prof["device_ms"], "profile_ops": prof["ops"],
                           "scatter_ms": scatter, "host_syncs": prof["host_syncs"]})
            print(f"    path {part} step, profiled: {prof['device_ms']:.3f} ms device time, {prof['ops']:g} device"
                  f" operations, scatter_add / index_add kernels {scatter:.3f} ms, {prof['host_syncs']} synchronizing"
                  f" CUDA calls")
            for op in prof["top"]:
                print(f"      {op['us_per_call']:10.1f} us x{op['per_call']:g}  {op['name'][:100]}")
            if prof["host_syncs"]:
                print(f"    path {part} synchronizing calls at {prof['sync_sites']}")
        timings[part] = timing
    for part, timing in timings.items():  # after every part has printed its profile
        if "host_syncs" in timing:
            _check(timing["host_syncs"] == 0, f"path {part}: a profiled step makes no synchronizing CUDA call")

    # the certificates: the exact AUROC of path C's rank oracle over G1's epoch
    scores = np.concatenate([s for s, _ in host["scores"]])
    target = np.concatenate([t for _, t in host["scores"]])
    exact_auroc = _curve_oracle(scores, target)[0]
    for part in ("G1", "G1q"):
        got, bound = float(parts[part]["epoch"]["AUROC"]), float(parts[part]["bounds"]["AUROC"])
        _check(abs(got - exact_auroc) <= bound,
               f"path {part}: |sketch AUROC {got:.7f} - exact AUROC {exact_auroc:.7f}| = {abs(got - exact_auroc):.3g}"
               f" <= error_bound() {bound:.3g}")

    # quantiles: within error_bound() of the sample the sketch's rank selects, and within alpha of np.quantile of the
    # finite samples
    grid = (QSKETCH_ALPHA, QSKETCH_MIN_VALUE, QSKETCH_MAX_VALUE)
    latency = np.concatenate([x for (x,) in host["latency"]]).astype(np.float64)
    err = np.concatenate([np.abs(p - t) for p, t in host["pairs"]]).astype(np.float64)
    for part, member, q, samples in (("G4", "Quantile", G4_Q, latency), ("G4", "Percentile", tuple(v / 100 for v in G4_P),
                                                                         latency),
                                     ("G4mae", "MedianAbsoluteError", 0.5, err)):
        got = np.atleast_1d(parts[part]["epoch"][member]).astype(np.float64)
        bound = np.atleast_1d(parts[part]["bounds"][member])
        ranked = np.quantile(samples[~np.isnan(samples)], q, method="lower")
        finite = np.quantile(samples[np.isfinite(samples)], q)
        _check(np.all(bound == grid[0]) and np.all(np.abs(got - ranked) <= bound * np.abs(ranked) + grid[1])
               and np.all(np.abs(got - finite) <= grid[0] * np.abs(finite) + grid[1]),
               f"path {part} {member} q={q}: {np.round(got, 6).tolist()} within error_bound() {bound.tolist()} of the"
               f" ranked samples {np.round(ranked, 6).tolist()}, and within relative alpha of np.quantile of the"
               f" finite samples (relative {np.round(np.abs(got - finite) / np.abs(finite), 5).tolist()})")

    # count-min: every key's min-row estimate is an overcount
    tail = CMSTail()
    counts = parts["G5"]["counts"]["KeyCounts"]["tail"]
    true = np.bincount(np.concatenate(result["keys"]), minlength=G5_KEYS)
    per_key = cms_buckets(stable_key_hash_array(np.arange(G5_KEYS)), tail.depth, tail.width, tail.seed)
    estimate = counts[np.arange(tail.depth)[None, :], per_key].min(1)
    over = estimate - true
    _check(np.all(over >= 0) and int(parts["G5"]["epoch"]["KeyCounts"]) == true.sum(),
           f"path G5: every key's min-row estimate >= its true count over {G5_KEYS} keys (max overcount {over.max()},"
           f" median {int(np.median(over))}; the e/width bound is {np.e / tail.width * true.sum():.0f}); total"
           f" {true.sum()}; host hashing and bucketing {statistics.median(result['hash_ms']):.1f} ms a step")

    # state bytes beside what the exact modes would hold for the same epoch
    n1 = scores.size
    exact = {"G1": 4 * n1 * (4 + 8), "G1q": 2 * n1 * (4 + 8), "G2": 2 * G2_STEPS * A_BATCH * (A_CLASSES * 4 + 8),
             "G3": 2 * 2 * err.size * 4, "G3q": 2 * 2 * err.size * 4, "G4": 2 * latency.size * 4,
             "G4mae": err.size * 4, "G5": int((true > 0).sum()) * 16}
    for part, run in parts.items():
        timings[part]["exact_bytes"] = exact[part]
    print("    path G state bytes (sketch_nbytes, summed over members) beside the exact mode's for the same epoch: "
          + "; ".join(f"{p} {sum(r['bytes'].values()):,} vs {exact[p]:,}" for p, r in parts.items()))
    return timings


# ---- path H: detection, audio, clustering and nominal association, and the pairwise functionals
# H1: COCO val2017's evaluation: 5,000 images, 80 classes, ~36,800 boxes (7.3 an image), 100 detections an image
H1_IMAGES, H1_BATCH, H1_CLASSES, H1_DETS = 5_000, 8, 80, 100
H1_GT_MEAN, H1_GT_TAIL = 7.3, 64  # one image holds H1_GT_TAIL boxes: the tail reaches past 50
H1_ORACLE_IMAGES = 500  # the loop-wise pycocotools replica runs over these
H1_MEMORY_BUDGET = 8 << 30  # the stated ceiling of the epoch compute's peak device memory
# AP and recall from equal counts, float32 divisions and means in another order
RTOL_H1 = 1e-6
# against the replica: precision in float64 there, float32 here, the same float32 recall and grid
RTOL_H1_ORACLE = 1e-5
# H2: WSJ0-2mix's test set (3,000 mixtures of 2 speakers, 8 kHz, 4 s) and Libri3Mix's 3-source layout
H2A_MIXTURES, H2_BATCH, H2_SAMPLES, H2B_STEPS = 3_000, 64, 32_000, 10
# dB values are 10 log10 of float32 sums over 32,000 samples, added in another order on the card, on the host and in
# numpy float64: a relative error of ~1e-6 in a ratio is 4e-6 dB
RTOL_DB, ATOL_DB = 1e-5, 1e-4
PIT_MARGIN_DB = 1e-3  # PIT's choice must equal the oracle's where its best and second-best differ by more
# H3: k-means cluster ids of ImageNet-1k's train set against its labels
H3_N, H3_BATCH, H3_K = 1_281_167, 16_384, 1_000
H3_ORACLE_N = 131_072  # the numpy gammaln EMI oracle's share: the first 8 steps
H3_FOLLOW = 0.6
# float64 closed forms from equal counts rounded once to float32, against numpy float64 over the same counts
RTOL_H3 = 1e-6
# the float64 EMI, card against CPU: each summand's log P is nine lgamma values of up to lgamma(N + 1) = 1.7e7
# that cancel to O(1), and the card's lgamma and the host's differ by an ulp, so a term moves by up to
# 9 * 1.7e7 * 2.2e-16 = 3.3e-8 relative
RTOL_H3_EMI = 1e-7
# H4: ResNet-50 pooled features of ImageNet's validation set, scored against 1,000 clusters
H4_N, H4_BATCH, H4_DIM, H4_K = 50_000, 1_024, 2_048, 1_000
H4_CAPACITY = 65_536
# float32 moments summed in another order (cuBLAS on the card, the host BLAS on the CPU): rtol 1e-5 between the two
# runs; against the float64 formulas, the JAX package's own tolerance for these scores, rtol 1e-4
RTOL_H4, RTOL_H4_ORACLE = 1e-5, 1e-4
# H5: 8,192 query against 4,096 gallery embeddings of 2,048 features; E4's images
H5_X, H5_Y, H5_DIM = 8_192, 4_096, 2_048
H5_ROWS = 128  # rows of x the CPU run and the float64 oracle hold (each against every column)
# float32 products over 2,048 features in another order: an entry is off by a few eps times the L1 mass of its
# products (|x||y| ~ 0.64 a feature: ~1.6e-4 at worst for the raw products, ~1e-7 for unit vectors); a row's
# mean or sum by rtol 1e-5 of its entries' L1 mass
RTOL_H5 = 1e-5
_H5_ATOL = {"pairwise_cosine_similarity": 1e-6, "pairwise_euclidean_distance": 1e-3,
            "pairwise_manhattan_distance": 1e-3, "pairwise_linear_similarity": 1e-3, "cosine": 1e-6, "dot": 1e-3}


def _h_timed(device, fn):
    """``fn()`` and its milliseconds on the host clock, synchronized."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _h_peak(device, fn):
    """``fn()``, its milliseconds, and the peak device bytes it allocated above what was live before it."""
    import torch

    if device.type != "cuda":
        out, ms = _h_timed(device, fn)
        return out, ms, None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, ms = _h_timed(device, fn)
    return out, ms, torch.cuda.max_memory_allocated() - base


def _h_share(device, fn, wall_ms, calls=2):
    """Device milliseconds of one ``fn()`` (``torch.profiler``) and their share of ``wall_ms``."""
    if device.type != "cuda":
        return None
    from metrics_tpu_torch.tools.cuda_timing import device_breakdown

    rows = device_breakdown(fn, calls=calls)
    device_ms = sum(r["us_per_call"] for r in rows) / 1e3
    return {"device_ms": device_ms, "share": device_ms / wall_ms, "top": rows[:6]}


def _h1_images(seed):
    """Padded numpy images: detections (I, 100) and ground truths (I, G) with counts, crowd flags and classes."""
    rng = np.random.default_rng(seed)
    n_gt = rng.geometric(1 / H1_GT_MEAN, H1_IMAGES)
    n_gt[rng.integers(H1_IMAGES)] = H1_GT_TAIL
    g_max = int(n_gt.max())
    class_p = 1.0 / np.arange(1, H1_CLASSES + 1) ** 0.8  # a few frequent classes (person, car, ...) and a long tail
    class_p /= class_p.sum()
    gb = np.zeros((H1_IMAGES, g_max, 4), np.float32)
    gl = np.zeros((H1_IMAGES, g_max), np.int64)
    gc = np.zeros((H1_IMAGES, g_max), bool)
    db = np.zeros((H1_IMAGES, H1_DETS, 4), np.float32)
    ds = np.zeros((H1_IMAGES, H1_DETS), np.float32)
    dl = np.zeros((H1_IMAGES, H1_DETS), np.int64)

    def boxes(n):
        side = np.exp(rng.uniform(np.log(4.0), np.log(400.0), n))  # sqrt(area): ~45% small, 24% medium, 31% large
        aspect = np.exp(rng.normal(0, 0.4, n))
        w, h = side * aspect, side / aspect
        x0, y0 = rng.uniform(0, 640 - np.minimum(w, 600)), rng.uniform(0, 480 - np.minimum(h, 440))
        return np.stack([x0, y0, x0 + w, y0 + h], 1)

    for i in range(H1_IMAGES):
        g = int(n_gt[i])
        gb[i, :g] = boxes(g)
        gl[i, :g] = rng.choice(H1_CLASSES, g, p=class_p)
        gc[i, :g] = rng.random(g) < 0.01
        copies = rng.choice([0, 1, 1, 1, 2, 3], g)  # missed, found, found with duplicates
        src = np.repeat(np.arange(g), copies)[:H1_DETS]
        k = src.shape[0]
        wh = np.tile(gb[i, src, 2:] - gb[i, src, :2], (1, 2))
        det = gb[i, src] + rng.normal(0, 0.08, (k, 4)) * wh
        det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 1)
        lab = np.where(rng.random(k) < 0.9, gl[i, src], rng.choice(H1_CLASSES, k, p=class_p))
        score = rng.beta(5, 2, k)
        background = H1_DETS - k
        det = np.concatenate([det, boxes(background)])
        lab = np.concatenate([lab, rng.choice(H1_CLASSES, background, p=class_p)])
        score = np.concatenate([score, rng.beta(1, 6, background)])
        order = rng.permutation(H1_DETS)
        db[i], dl[i] = det[order], lab[order]
        ds[i] = (np.floor(score[order] * 4096) / 4096).astype(np.float32)  # a 2**-12 grid: tied scores
    return {"det_boxes": db, "det_scores": ds, "det_labels": dl, "gt_boxes": gb, "gt_labels": gl, "gt_crowd": gc,
            "n_gt": n_gt}


def _h1_batches(images, device, lo, hi):
    """Updates of H1_BATCH images from the padded arrays on ``device``: lists of per-image dicts (views, no copy)."""
    import torch

    t = {k: torch.from_numpy(v).to(device) for k, v in images.items() if k != "n_gt"}
    batches = []
    for start in range(lo, hi, H1_BATCH):
        idx = range(start, min(start + H1_BATCH, hi))
        preds = [{"boxes": t["det_boxes"][i], "scores": t["det_scores"][i], "labels": t["det_labels"][i]} for i in idx]
        target = [{"boxes": t["gt_boxes"][i, :images["n_gt"][i]], "labels": t["gt_labels"][i, :images["n_gt"][i]],
                   "iscrowd": t["gt_crowd"][i, :images["n_gt"][i]]} for i in idx]
        batches.append((preds, target))
    return batches


def _h1_metric(device, g_max):
    import metrics_tpu_torch as pt

    return pt.MeanAveragePrecision(num_classes=H1_CLASSES, max_detections=H1_DETS, max_gt=g_max, class_metrics=True,
                                   device=device)


def _h1_flags(metric):
    """The port's match flags over the metric's states, in the in-image order ``coco_map_padded`` applies."""
    import torch

    from metrics_tpu_torch.functional.detection import map as tmap
    from metrics_tpu_torch.parallel.buffer import as_values

    state = {k: as_values(getattr(metric, k)) for k in ("det_boxes", "det_scores", "det_labels", "det_valid",
                                                         "gt_boxes", "gt_labels", "gt_valid", "gt_crowd")}
    valid = state["det_valid"]
    key = torch.where(valid, state["det_scores"], torch.tensor(float("-inf"), device=valid.device))
    order = torch.argsort(-key, dim=1, stable=True)
    return tmap._match_flags(
        torch.take_along_dim(state["det_boxes"], order[..., None], 1), torch.take_along_dim(valid, order, 1),
        torch.take_along_dim(state["det_labels"], order, 1), state["gt_boxes"], state["gt_labels"], state["gt_valid"],
        state["gt_crowd"], H1_CLASSES, max(tmap.COCO_MAX_DETS), tmap.COCO_IOU_THRESHOLDS, tmap.COCO_AREA_RANGES)


def _h_host(values):
    return {k: v.detach().cpu().numpy() for k, v in values.items()}


def run_path_h1(device):
    images = _h1_images(81)
    g_max = int(images["n_gt"].max())
    batches = _h1_batches(images, device, 0, H1_IMAGES)
    metric = _h1_metric(device, g_max)
    update_ms = []
    for preds, target in batches:
        _, ms = _h_timed(device, lambda: metric.update(preds, target))
        update_ms.append(ms)
    with _CountCollectives() as collectives:
        epoch, epoch_ms, peak = _h_peak(device, metric.compute)
    metric._computed = None
    _, epoch_ms_again = _h_timed(device, metric.compute)
    # the matching alone, on the same synced states
    flags, match_ms = _h_timed(device, lambda: _h1_flags(metric))
    first = _h1_metric(device, g_max)
    for preds, target in _h1_batches(images, device, 0, H1_ORACLE_IMAGES):
        first.update(preds, target)
    out = {"images": images, "update_ms": update_ms, "epoch": _h_host(epoch), "epoch_ms": [epoch_ms, epoch_ms_again],
           "peak_bytes": peak, "match_ms": match_ms, "collectives": collectives,
           "flags": [f.cpu().numpy() for f in flags], "first": _h_host(first.compute())}
    if device.type == "cuda":
        def fresh_compute():
            metric._computed = None
            metric.compute()

        out["profile"] = _h_share(device, fresh_compute, epoch_ms_again)
        preds, target = batches[1]
        spare = _h1_metric(device, g_max)
        out["update_profile"] = _h_share(device, lambda: spare.update(preds, target),
                                         statistics.median(update_ms), calls=5)
    return out


def _h2_batches(steps, sources, last, seed):
    """Host (preds, target) batches: sources with random gains, estimates the sources in swapped order for half the
    batch plus white noise at 0-20 dB SNR."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        b = last if step == steps - 1 else H2_BATCH
        target = (rng.standard_normal((b, sources, H2_SAMPLES), dtype=np.float32)
                  * rng.uniform(0.2, 1.0, (b, sources, 1)).astype(np.float32))
        perm = np.tile(np.arange(sources), (b, 1))
        perm[: b // 2] = np.stack([rng.permutation(sources) if sources > 2 else np.array([1, 0])
                                   for _ in range(b // 2)])
        swapped = np.take_along_axis(target, perm[:, :, None], 1)
        snr_db = rng.uniform(0, 20, (b, sources, 1))
        rms = np.sqrt(np.mean(swapped.astype(np.float64) ** 2, -1, keepdims=True))
        noise = rng.standard_normal(swapped.shape, dtype=np.float32) * (rms * 10 ** (-snr_db / 20)).astype(np.float32)
        out.append((swapped + noise, target))
    return out


def _si_snr(preds, target):
    """PIT's per-example function: SI-SDR of the mean-centred signals."""
    from metrics_tpu_torch.functional.audio.si_sdr import _si_sdr_per_example

    return _si_sdr_per_example(preds, target, True)


def _h2_collection(device, **kw):
    import metrics_tpu_torch as pt

    return pt.MetricCollection({"SNR": pt.SNR(device=device, **kw), "SI_SDR": pt.SI_SDR(device=device, **kw),
                                "SI_SNR": pt.SI_SNR(device=device, **kw),
                                "PIT": pt.PIT(_si_snr, "max", device=device, **kw)})


def _h2_pit(device, **kw):
    import metrics_tpu_torch as pt

    return pt.PIT(_si_snr, "max", device=device, **kw)


def run_path_h2(device):
    import torch

    import metrics_tpu_torch.functional as ptf

    steps_a = -(-H2A_MIXTURES // H2_BATCH)
    parts = {"H2a": (_h2_batches(steps_a, 2, H2A_MIXTURES - (steps_a - 1) * H2_BATCH, 82), _h2_collection),
             "H2b": (_h2_batches(H2B_STEPS, 3, H2_BATCH, 83), lambda d, **kw: _h2_pit(d, **kw))}
    out = {}
    for part, (host, build) in parts.items():
        col = build(device, dist_sync_on_step=True)
        values, ms, perms = [], [], []
        for p, t in host:
            batch = (torch.from_numpy(p).to(device), torch.from_numpy(t).to(device))
            value, step_ms = _h_timed(device, lambda: col(*batch))
            values.append({k: v.item() for k, v in value.items()} if isinstance(value, dict) else {"PIT": value.item()})
            ms.append(step_ms)
            perms.append(ptf.permutation_invariant_training(*batch, _si_snr, "max")[1].cpu().numpy())
        epoch = col.compute()
        run = {"host": host, "values": values, "ms": ms, "perms": perms,
               "epoch": {k: v.item() for k, v in epoch.items()} if isinstance(epoch, dict) else {"PIT": epoch.item()}}
        if device.type == "cuda":
            fresh = build(device, dist_sync_on_step=True)
            first = (torch.from_numpy(host[0][0]).to(device), torch.from_numpy(host[0][1]).to(device))
            run["profile"] = _h_share(device, lambda: fresh(*first), statistics.median(ms), calls=3)
        out[part] = run
    return out


_H3_EXTRINSIC = ("RandScore", "AdjustedRandScore", "MutualInfoScore", "NormalizedMutualInfoScore",
                 "AdjustedMutualInfoScore", "HomogeneityScore", "CompletenessScore", "VMeasureScore",
                 "FowlkesMallowsScore")
_H3_NOMINAL = ("CramersV", "PearsonsContingencyCoefficient", "TschuprowsT", "TheilsU")


def _h3_collection(device, **kw):
    import metrics_tpu_torch as pt

    members = {name: getattr(pt, name)(H3_K, H3_K, device=device, **kw) for name in _H3_EXTRINSIC}
    members.update({name: getattr(pt, name)(H3_K, H3_K, device=device, **kw) for name in _H3_NOMINAL})
    return pt.MetricCollection(members)


def _h3_labels():
    """(cluster ids, true labels): the cluster follows the true class (through a fixed relabeling) with
    probability 0.6, else it is uniform."""
    rng = np.random.default_rng(84)
    target = rng.integers(0, H3_K, H3_N)
    relabel = rng.permutation(H3_K)
    preds = np.where(rng.random(H3_N) < H3_FOLLOW, relabel[target], rng.integers(0, H3_K, H3_N))
    return preds, target


def run_path_h3(device):
    import torch

    import metrics_tpu_torch.functional as ptf
    from metrics_tpu_torch.functional import clustering as clust

    preds, target = _h3_labels()
    col = _h3_collection(device, dist_sync_on_step=True)
    step_values, ms, updates, reduces = [], [], [], []
    for lo in range(0, H3_N, H3_BATCH):
        batch = tuple(torch.from_numpy(x[lo:lo + H3_BATCH]).to(device) for x in (preds, target))
        with _CountUpdates() as up, _CountCollectives() as coll:
            value, step_ms = _h_timed(device, lambda: col(*batch))
        step_values.append(torch.stack([value[k] for k in col.keys()]).cpu().numpy())
        ms.append(step_ms)
        updates.append(up[0])
        reduces.append(coll["all_reduce"])
    epoch, epoch_ms, collectives, _ = _epoch_timed(col, device)
    cont = col["RandScore"].contingency
    emi, emi_ms, emi_peak = _h_peak(device, lambda: clust._expected_mutual_info(cont, H3_N))
    first = tuple(torch.from_numpy(x[:H3_ORACLE_N]).to(device) for x in (preds, target))
    first_ami = ptf.adjusted_mutual_info_score(*first, H3_K, H3_K).item()
    out = {"names": list(col.keys()), "step_values": step_values, "ms": ms, "updates": updates, "reduces": reduces,
           "epoch": {k: v.item() for k, v in epoch.items()}, "epoch_ms": epoch_ms, "collectives": collectives,
           "contingency": {k: m.contingency.cpu().numpy() for k, m in col.items()}, "emi": emi.item(),
           "emi_ms": emi_ms, "emi_peak": emi_peak, "first_ami": first_ami, "groups": len(col.compute_groups),
           "step_reduces": _packed_step_reduces(col)}
    if device.type == "cuda":
        fresh = _h3_collection(device, dist_sync_on_step=True)
        step0 = (torch.from_numpy(preds[:H3_BATCH]).to(device), torch.from_numpy(target[:H3_BATCH]).to(device))
        out["profile"] = _h_share(device, lambda: fresh(*step0), statistics.median(ms), calls=3)
    return out


def _h4_features():
    """Gaussian blobs around 1,000 centres in 2,048 dimensions (ReLU-pooled features are non-negative: the centres
    are |N(0, 1)|), each sample labeled with its nearest centre."""
    rng = np.random.default_rng(85)
    centres = np.abs(rng.standard_normal((H4_K, H4_DIM), dtype=np.float32))
    assigned = rng.integers(0, H4_K, H4_N)
    data = centres[assigned] + rng.standard_normal((H4_N, H4_DIM), dtype=np.float32) * np.float32(0.7)
    c64 = centres.astype(np.float64)
    dist = (data.astype(np.float64) ** 2).sum(1)[:, None] - 2 * data.astype(np.float64) @ c64.T + (c64 ** 2).sum(1)
    return data, np.argmin(dist, 1)


def _h4_collection(device):
    import metrics_tpu_torch as pt

    return pt.MetricCollection({"CH": pt.CalinskiHarabaszScore(H4_K, H4_DIM, device=device),
                                "DB": pt.DaviesBouldinScore(H4_K, device=device),
                                "DB_capacity": pt.DaviesBouldinScore(H4_K, capacity=H4_CAPACITY, device=device)})


def _h_tf32(fn):
    """``fn()`` with TF32 allowed (the card's default for convolutions and the caller's choice for matmuls) and
    with it off; the caller's flags come back as they were."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        on = fn()
        kept = torch.get_float32_matmul_precision() == "high" and torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        off = fn()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
    return on, off, kept


def run_path_h4(device):
    import torch

    import metrics_tpu_torch.functional as ptf
    from metrics_tpu_torch.functional.clustering_intrinsic import _cluster_moments_batch

    data, labels = _h4_features()
    x, lab = torch.from_numpy(data).to(device), torch.from_numpy(labels).to(device)
    col = _h4_collection(device)
    ms = []
    for lo in range(0, H4_N, H4_BATCH):
        _, step_ms = _h_timed(device, lambda: col.update(x[lo:lo + H4_BATCH], lab[lo:lo + H4_BATCH]))
        ms.append(step_ms)
    with _CountCollectives() as collectives:
        epoch, epoch_ms, peak = _h_peak(device, col.compute)
    on, off, kept = _h_tf32(lambda: (_cluster_moments_batch(x[:H4_BATCH], lab[:H4_BATCH], H4_K),
                                     ptf.davies_bouldin_score(x, lab, H4_K)))
    out = {"host": (data, labels), "ms": ms, "epoch": {k: v.item() for k, v in epoch.items()}, "epoch_ms": epoch_ms,
           "peak_bytes": peak, "collectives": collectives, "moments": col["CH"].moments.cpu().numpy(),
           "tf32_equal": all(torch.equal(a, b) for a, b in zip(on, off)), "tf32_flags_kept": kept}
    if device.type == "cuda":
        fresh = _h4_collection(device)
        out["profile"] = _h_share(device, lambda: fresh.update(x[:H4_BATCH], lab[:H4_BATCH]), statistics.median(ms),
                                  calls=5)
    return out


_H5_PAIRWISE = ("pairwise_cosine_similarity", "pairwise_euclidean_distance", "pairwise_manhattan_distance",
                "pairwise_linear_similarity")


def run_path_h5(device):
    import torch

    import metrics_tpu_torch.functional as ptf

    rng = np.random.default_rng(86)
    xh = rng.standard_normal((H5_X, H5_DIM), dtype=np.float32)
    yh = rng.standard_normal((H5_Y, H5_DIM), dtype=np.float32)
    x, y = torch.from_numpy(xh).to(device), torch.from_numpy(yh).to(device)
    results, ms, tf32 = {}, {}, {}
    for name in _H5_PAIRWISE + ("embedding_similarity",):
        fn = getattr(ptf, name)
        for reduction in (None, "mean", "sum"):
            for zero_diagonal in (False, True):
                if name == "embedding_similarity":
                    red = "none" if reduction is None else reduction
                    for similarity in ("cosine", "dot"):
                        key = (name, similarity, reduction, zero_diagonal)
                        value, ms[key] = _h_timed(device, lambda: fn(x, similarity, red, zero_diagonal))
                        results[key] = value[:H5_ROWS].cpu().numpy()
                    continue
                key = (name, reduction, zero_diagonal)
                value, ms[key] = _h_timed(device, lambda: fn(x, y, reduction=reduction, zero_diagonal=zero_diagonal))
                results[key] = value[:H5_ROWS].cpu().numpy()
        call = (lambda: fn(x)) if name == "embedding_similarity" else (lambda: fn(x, y))
        on, off, kept = _h_tf32(call)
        tf32[name] = (torch.equal(on, off), kept)
    images = _e4_images(np.random.default_rng(87), E4_SHAPE)[0]
    img = torch.from_numpy(images).to(device)
    grads, grad_ms = _h_timed(device, lambda: ptf.image_gradients(img))
    return {"x": xh, "y": yh, "results": results, "ms": ms, "tf32": tf32, "images": images,
            "gradients": [g.cpu().numpy() for g in grads], "gradient_ms": grad_ms}


def run_path_h(device):
    """Path H inside the caller's process group: H1-H5 on the card, timed, with what the checks need on the host."""
    return {"H1": run_path_h1(device), "H2": run_path_h2(device), "H3": run_path_h3(device),
            "H4": run_path_h4(device), "H5": run_path_h5(device)}


# ---- path H's oracles: numpy / scipy float64, no code shared with the port

def _np_area(boxes):
    return np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * np.clip(boxes[:, 3] - boxes[:, 1], 0, None)


def _np_iou(a, b, crowd=None):
    """(N, M) IoU; columns flagged in ``crowd`` use intersection / detection area."""
    inter_lt = np.maximum(a[:, None, :2], b[None, :, :2])
    inter_rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(inter_rb - inter_lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a, area_b = _np_area(a), _np_area(b)
    union = area_a[:, None] + area_b[None, :] - inter
    iou = np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)
    if crowd is not None and crowd.any():
        iou_cr = np.where(area_a[:, None] > 0, inter / np.where(area_a > 0, area_a, 1.0)[:, None], 0.0)
        iou = np.where(crowd[None, :], iou_cr, iou)
    return iou


_COCO_THRESHOLDS = tuple(round(0.5 + 0.05 * i, 2) for i in range(10))
_COCO_AREAS = (("all", 0.0, 1e10), ("small", 0.0, 32.0**2), ("medium", 32.0**2, 96.0**2), ("large", 96.0**2, 1e10))
_COCO_MAX_DETS = (1, 10, 100)


def _np_coco_map(images, num_classes, thresholds=_COCO_THRESHOLDS, max_dets=_COCO_MAX_DETS, area_ranges=_COCO_AREAS):
    """The pycocotools algorithm, loop-wise, over ``(det_boxes, det_scores, det_labels, gt_boxes, gt_labels,
    gt_crowd)`` per image (a replica of the JAX package's test oracle, ``tests/detection/test_mean_ap.py``).
    The recall and its 101-point grid are float32, as the evaluated implementations take them (the grid
    ``k * float32(0.01)`` of ``jnp.linspace``), so a recall exactly on a grid point selects the same rank; the
    rest is float64. Each (image, class) cell's detections, ground truths and overlaps are gathered once for
    every area range, and a cell without ground truths matches nothing (its out-of-range detections are
    ignored), as the loop would find."""
    n_area, n_thr, k_max = len(area_ranges), len(thresholds), max(max_dets)
    aps = np.full((n_area, n_thr, num_classes), np.nan)
    recs = {k: np.full((n_area, n_thr, num_classes), np.nan) for k in max_dets}
    grid = np.arange(101, dtype=np.float32) * np.float32(0.01)
    cells = [[] for _ in range(num_classes)]  # per class: (scores, det areas, gt areas, crowd, overlaps)
    for det_boxes, det_scores, det_labels, gt_boxes, gt_labels, gt_crowd in images:
        for ci in sorted(set(det_labels.tolist()) | set(gt_labels.tolist())):
            d_idx = np.where(det_labels == ci)[0]
            d_idx = d_idx[np.argsort(-det_scores[d_idx], kind="stable")][:k_max]
            g_idx = np.where(gt_labels == ci)[0]
            g_crowd = gt_crowd[g_idx].astype(bool)
            ious = (_np_iou(det_boxes[d_idx], gt_boxes[g_idx], g_crowd)
                    if len(d_idx) and len(g_idx) else np.zeros((len(d_idx), len(g_idx))))
            cells[ci].append((det_scores[d_idx], _np_area(det_boxes[d_idx]), _np_area(gt_boxes[g_idx]), g_crowd, ious))
    for ai, (_, lo, hi) in enumerate(area_ranges):
        for ci in range(num_classes):
            n_gt = 0
            per_img = []
            for scores, d_area, g_area, g_crowd, ious in cells[ci]:
                g_ig = g_crowd | (g_area < lo) | (g_area > hi)
                g_order = np.argsort(g_ig, kind="stable")  # pycocotools sorts gts unignored-first
                g_ig, crowd, ov = g_ig[g_order], g_crowd[g_order], ious[:, g_order]
                n_gt += int((~g_ig).sum())
                d_out = (d_area < lo) | (d_area > hi)
                tp = np.zeros((n_thr, len(scores)), bool)
                ig = np.repeat(d_out[None], n_thr, 0)  # unmatched and out of range: ignored
                for ti, thr in enumerate(thresholds if len(g_ig) else ()):
                    used = np.zeros(len(g_ig), bool)
                    for r in range(len(scores)):
                        best, best_iou = -1, float(np.float32(thr))
                        for c in range(len(g_ig)):
                            if used[c] and not crowd[c]:
                                continue
                            if best >= 0 and not g_ig[best] and g_ig[c]:
                                break  # an unignored match found and the rest are ignored
                            if ov[r, c] < best_iou:
                                continue
                            best, best_iou = c, ov[r, c]
                        if best >= 0:
                            used[best] = True
                            ig[ti, r] = g_ig[best]
                            tp[ti, r] = not g_ig[best]
                per_img.append((scores, tp, ig))
            if n_gt == 0:
                continue
            for k in max_dets:
                for ti in range(n_thr):
                    recs[k][ai, ti, ci] = sum(tp[ti, :k].sum() for _, tp, _ in per_img) / n_gt
            scores = np.concatenate([s for s, _, _ in per_img])
            order = np.argsort(-scores, kind="stable")
            for ti in range(n_thr):
                tp_flat = np.concatenate([tp[ti] for _, tp, _ in per_img])[order]
                ig_flat = np.concatenate([ig[ti] for _, _, ig in per_img])[order]
                keep = ~ig_flat
                tps = np.cumsum(tp_flat[keep])
                fps = np.cumsum(~tp_flat[keep])
                recall = tps.astype(np.float32) / np.float32(n_gt)
                precision = tps / np.maximum(tps + fps, 1e-30)
                if len(precision):
                    precision = np.maximum.accumulate(precision[::-1])[::-1]
                    inds = np.searchsorted(recall, grid, side="left")
                    q = np.where(inds < len(precision), precision[np.minimum(inds, len(precision) - 1)], 0.0)
                else:
                    q = np.zeros(grid.shape)
                aps[ai, ti, ci] = q.mean()
    out = {"map": np.nanmean(aps[0]), "map_50": np.nanmean(aps[0, thresholds.index(0.5)]),
           "map_75": np.nanmean(aps[0, thresholds.index(0.75)]), "map_per_class": np.nanmean(aps[0], axis=0),
           f"mar_{k_max}_per_class": np.nanmean(recs[k_max][0], axis=0)}
    for k in max_dets:
        out[f"mar_{k}"] = np.nanmean(recs[k][0])
    for ai, (name, _, _) in enumerate(area_ranges):
        if name != "all":
            out[f"map_{name}"] = np.nanmean(aps[ai])
            out[f"mar_{name}"] = np.nanmean(recs[k_max][ai])
    return out


def _h_close(label, got, want, rtol, atol=0.0):
    """Raise unless ``got`` is within ``atol + rtol |want|`` of ``want`` (NaN where NaN); return the largest
    difference as a share of that tolerance."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.allclose(got, want, rtol=rtol, atol=atol, equal_nan=True):
        raise AssertionError(f"{label}: {got} vs {want} (rtol {rtol}, atol {atol})")
    both = np.isfinite(got) & np.isfinite(want)
    share = np.abs(got[both] - want[both]) / (np.broadcast_to(atol, got.shape)[both] + rtol * np.abs(want[both]))
    return float(share.max()) if share.size else 0.0


def check_path_h1(run):
    import warnings

    import torch

    images = run["images"]
    g_max = int(images["n_gt"].max())
    warnings.simplefilter("ignore")
    cpu = _h1_metric("cpu", g_max)
    cpu_ms = 0.0
    for preds, target in _h1_batches(images, torch.device("cpu"), 0, H1_IMAGES):
        cpu.update(preds, target)
    want, cpu_ms = _h_timed(torch.device("cpu"), cpu.compute)
    worst = max(_h_close(f"path H1 epoch {k}", run["epoch"][k], v.numpy(), RTOL_H1) for k, v in want.items())
    cpu_flags = _h1_flags(cpu)
    for got, expect, name in zip(run["flags"], cpu_flags, ("matched", "matched to ignored", "taking part", "rank")):
        _check(np.array_equal(got, expect.numpy()), f"path H1 match flags ({name}, {expect.numel():,} entries) on the"
               f" card equal the CPU run's bit for bit")
    print(f"  ok: path H1 epoch over {H1_IMAGES} images: every key equals the port's CPU run (rtol {RTOL_H1}; the"
          f" largest difference {worst:.2f} of the tolerance); map {run['epoch']['map']:.6f}, map_50"
          f" {run['epoch']['map_50']:.6f}, mar_100 {run['epoch']['mar_100']:.6f}; CPU compute {cpu_ms:.0f} ms")
    t0 = time.perf_counter()
    per_image = []
    for i in range(H1_ORACLE_IMAGES):
        n = int(images["n_gt"][i])
        # float32 boxes: the replica's IoU is then the same float32 arithmetic as the evaluated code's, so a
        # threshold comparison decides alike
        per_image.append((images["det_boxes"][i], images["det_scores"][i], images["det_labels"][i],
                          images["gt_boxes"][i, :n], images["gt_labels"][i, :n], images["gt_crowd"][i, :n]))
    oracle = _np_coco_map(per_image, H1_CLASSES)
    oracle_s = time.perf_counter() - t0
    worst = max(_h_close(f"path H1 first {H1_ORACLE_IMAGES} images {k}", run["first"][k], v, RTOL_H1_ORACLE)
                for k, v in oracle.items())
    print(f"  ok: path H1 first {H1_ORACLE_IMAGES} images: every key equals the numpy pycocotools replica (rtol"
          f" {RTOL_H1_ORACLE}; the largest difference {worst:.2f} of the tolerance; replica {oracle_s:.1f} s); map"
          f" {run['first']['map']:.6f}")
    _check(run["collectives"]["all_gather"] >= 1 and run["collectives"]["all_reduce"] == 0,
           f"path H1 epoch compute gathers the per-image states ({run['collectives']})")
    peak = run["peak_bytes"]
    if peak is not None:
        _check(peak < H1_MEMORY_BUDGET, f"path H1 epoch compute peak device memory {peak / 2**30:.2f} GiB <"
               f" {H1_MEMORY_BUDGET / 2**30:.0f} GiB (the dense (A, T, C, I, G) form would hold 4.1 GB a temporary)")
    epoch_ms = run["epoch_ms"]
    timing = {"update_ms": statistics.median(run["update_ms"]), "epoch_ms": epoch_ms, "match_ms": run["match_ms"],
              "match_share": run["match_ms"] / epoch_ms[1], "peak_bytes": peak, "cpu_epoch_ms": cpu_ms,
              "oracle_s": oracle_s}
    print(f"[11] path H1: {len(run['update_ms'])} updates of {H1_BATCH} images: median {timing['update_ms']:.3f} ms"
          f" (first {run['update_ms'][0]:.1f} ms); epoch compute {epoch_ms[0]:.1f} ms (again {epoch_ms[1]:.1f} ms), the"
          f" matching {run['match_ms']:.1f} ms of it ({timing['match_share']:.0%}); peak"
          f" {(peak or 0) / 2**20:.0f} MiB")
    for key in ("profile", "update_profile"):
        prof = run.get(key)
        if prof is not None:
            timing[key] = {"device_ms": prof["device_ms"], "share": prof["share"]}
            print(f"    path H1 {'epoch compute' if key == 'profile' else 'update'}, profiled: {prof['device_ms']:.3f}"
                  f" ms device time, {prof['share']:.0%} of its wall time")
            for op in prof["top"]:
                print(f"      {op['us_per_call']:10.1f} us x{op['per_call']:g}  {op['name'][:100]}")
    return timing


def _np_db(x, y, zero_mean):
    x, y = x.astype(np.float64), y.astype(np.float64)
    if zero_mean:
        x, y = x - x.mean(-1, keepdims=True), y - y.mean(-1, keepdims=True)
    return x, y


def _np_snr(p, t, zero_mean=False):
    p, t = _np_db(p, t, zero_mean)
    return 10 * np.log10(np.maximum((t ** 2).sum(-1), 1e-8) / np.maximum(((p - t) ** 2).sum(-1), 1e-8))


def _np_si_sdr(p, t, zero_mean=False):
    p, t = _np_db(p, t, zero_mean)
    alpha = (p * t).sum(-1, keepdims=True) / np.maximum((t ** 2).sum(-1, keepdims=True), 1e-8)
    s = alpha * t
    return 10 * np.log10(np.maximum((s ** 2).sum(-1), 1e-8) / np.maximum(((p - s) ** 2).sum(-1), 1e-8))


def _np_pit(p, t):
    """(best mean SI-SNR, best permutation, margin to the second best) per example, float64."""
    import itertools

    s = p.shape[1]
    mat = np.stack([np.stack([_np_si_sdr(p[:, i], t[:, j], True) for j in range(s)], 1) for i in range(s)], 1)
    perms = np.array(list(itertools.permutations(range(s))))
    scores = mat[:, perms, np.arange(s)].mean(-1)
    ranked = np.sort(scores, 1)
    return scores.max(1), perms[scores.argmax(1)], ranked[:, -1] - ranked[:, -2]


def check_path_h2(runs):
    import torch

    timings = {}
    for part, run in runs.items():
        cpu = _h2_collection("cpu") if part == "H2a" else _h2_pit("cpu")
        sums, n_ex, n_mix, worst_cpu, worst_oracle, decided = {}, 0, 0, 0.0, 0.0, 0
        for step, (p, t) in enumerate(run["host"]):
            value = cpu(torch.from_numpy(p), torch.from_numpy(t))
            value = {k: v.item() for k, v in value.items()} if isinstance(value, dict) else {"PIT": value.item()}
            best, perm, margin = _np_pit(p, t)
            oracle = {"PIT": best}
            if part == "H2a":
                oracle.update({"SNR": _np_snr(p, t), "SI_SDR": _np_si_sdr(p, t), "SI_SNR": _np_si_sdr(p, t, True)})
            for k, want in oracle.items():
                sums[k] = sums.get(k, 0.0) + want.sum()
                worst_cpu = max(worst_cpu, _h_close(f"path {part} step {step} {k} vs CPU", run["values"][step][k],
                                                    value[k], RTOL_DB, ATOL_DB))
                worst_oracle = max(worst_oracle, _h_close(f"path {part} step {step} {k} vs oracle",
                                                          run["values"][step][k], want.mean(), RTOL_DB, ATOL_DB))
            clear = margin > PIT_MARGIN_DB
            if not np.array_equal(run["perms"][step][clear], perm[clear]):
                raise AssertionError(f"path {part} step {step}: PIT's permutations differ from the oracle's")
            decided += int(clear.sum())
            n_mix += p.shape[0]
            n_ex += p.shape[0] * p.shape[1]
        epoch_cpu = cpu.compute()
        epoch_cpu = ({k: v.item() for k, v in epoch_cpu.items()} if isinstance(epoch_cpu, dict)
                     else {"PIT": epoch_cpu.item()})
        for k, total in sums.items():
            n = n_mix if k == "PIT" else n_ex
            _h_close(f"path {part} epoch {k} vs CPU", run["epoch"][k], epoch_cpu[k], RTOL_DB, ATOL_DB)
            worst_oracle = max(worst_oracle, _h_close(f"path {part} epoch {k} vs oracle", run["epoch"][k], total / n,
                                                      RTOL_DB, ATOL_DB))
        print(f"  ok: path {part}: {len(run['host'])} steps, {n_mix} mixtures: every step and epoch value equals the"
              f" CPU run and the float64 oracle (rtol {RTOL_DB}, atol {ATOL_DB} dB; the largest differences"
              f" {worst_cpu:.2f} and {worst_oracle:.2f} of the tolerance); PIT's permutation equals the oracle's for"
              f" all {decided} of {n_mix} mixtures whose best two differ by more than {PIT_MARGIN_DB} dB; epoch"
              f" {run['epoch']}")
        timings[part] = {"ms_per_step": statistics.median(run["ms"]), "first_step_ms": run["ms"][0]}
        prof = run.get("profile")
        print(f"[11] path {part}: median {timings[part]['ms_per_step']:.3f} ms/step (first {run['ms'][0]:.1f} ms)"
              + (f"; profiled step {prof['device_ms']:.3f} ms device, {prof['share']:.0%} of the step" if prof else ""))
        if prof:
            timings[part].update(device_ms=prof["device_ms"], share=prof["share"])
    return timings


def _np_closed_forms(cont):
    """The nine extrinsic and four nominal scores, float64 numpy from a contingency (sklearn's / scipy's formulas),
    AMI without its EMI (returned apart)."""
    c = cont.astype(np.float64)
    n = c.sum()
    a, b = c.sum(1), c.sum(0)
    comb = lambda x: x * (x - 1) / 2  # noqa: E731
    nij2, a2, b2, n2 = comb(c).sum(), comb(a).sum(), comb(b).sum(), comb(n)
    expected = a2 * b2 / n2
    nz = c > 0
    mi = (c[nz] / n * np.log(n * c[nz] / np.outer(a, b)[nz])).sum()

    def entropy(v):
        p = v[v > 0] / v.sum()
        return -(p * np.log(p)).sum()

    h_pred, h_true = entropy(a), entropy(b)
    hom, com = mi / h_true, mi / h_pred
    e = np.outer(a, b) / n
    chi2 = ((c - e) ** 2 / np.where(e > 0, e, 1))[e > 0].sum()
    r, k = (a > 0).sum(), (b > 0).sum()
    rows = c[a > 0] / a[a > 0, None]
    h_rows = -np.where(rows > 0, rows * np.log(np.where(rows > 0, rows, 1)), 0).sum(1)
    h_cond = (a[a > 0] / n * h_rows).sum()
    return {
        "RandScore": (n2 + 2 * nij2 - a2 - b2) / n2,
        "AdjustedRandScore": (nij2 - expected) / ((a2 + b2) / 2 - expected),
        "MutualInfoScore": mi,
        "NormalizedMutualInfoScore": mi / ((h_pred + h_true) / 2),
        "HomogeneityScore": hom,
        "CompletenessScore": com,
        "VMeasureScore": 2 * hom * com / (hom + com),
        "FowlkesMallowsScore": nij2 / np.sqrt(a2 * b2),
        "CramersV": np.sqrt(chi2 / (n * (min(r, k) - 1))),
        "PearsonsContingencyCoefficient": np.sqrt(chi2 / (chi2 + n)),
        "TschuprowsT": np.sqrt(chi2 / (n * np.sqrt((r - 1) * (k - 1)))),
        "TheilsU": (h_true - h_cond) / h_true,
    }, (mi, h_pred, h_true)


def _np_emi(cont):
    """sklearn's expected mutual information, float64 numpy with ``scipy.special.gammaln``: for each count k, every
    cell whose feasible range holds k at once."""
    from scipy.special import gammaln

    c = cont.astype(np.float64)
    n = c.sum()
    a, b = c.sum(1)[:, None], c.sum(0)[None, :]
    a, b = a[a[:, 0] > 0], b[:, b[0] > 0]
    lo, hi = np.maximum(1, a + b - n), np.minimum(a, b)
    base = gammaln(a + 1) + gammaln(b + 1) + gammaln(n - a + 1) + gammaln(n - b + 1) - gammaln(n + 1)
    total = 0.0
    for k in range(1, int(hi.max()) + 1):
        ok = (lo <= k) & (k <= hi)
        if not ok.any():
            continue
        aa, bb = np.broadcast_to(a, ok.shape)[ok], np.broadcast_to(b, ok.shape)[ok]
        log_p = base[ok] - gammaln(k + 1) - gammaln(aa - k + 1) - gammaln(bb - k + 1) - gammaln(n - aa - bb + k + 1)
        total += (k / n * (np.log(n * k) - np.log(aa * bb)) * np.exp(log_p)).sum()
    return total


def _np_ami(cont):
    forms, (mi, h_pred, h_true) = _np_closed_forms(cont)
    emi = _np_emi(cont)
    return (mi - emi) / ((h_pred + h_true) / 2 - emi), emi


def check_path_h3(run):
    import torch

    from metrics_tpu_torch.functional import clustering as clust

    preds, target = _h3_labels()
    names = run["names"]
    oracle = np.bincount(preds * H3_K + target, minlength=H3_K * H3_K).reshape(H3_K, H3_K)
    cpu = _h3_collection("cpu")
    for lo in range(0, H3_N, H3_BATCH):
        cpu.update(torch.from_numpy(preds[lo:lo + H3_BATCH]), torch.from_numpy(target[lo:lo + H3_BATCH]))
    for name, counts in run["contingency"].items():
        if not (np.array_equal(counts, oracle) and np.array_equal(counts, cpu[name].contingency.numpy())):
            raise AssertionError(f"path H3 {name}: the card's contingency differs from the CPU run or the oracle")
    print(f"  ok: path H3 contingency ({H3_K} x {H3_K} int64, {H3_N:,} labels) of all {len(names)} members equals the"
          f" CPU run and the numpy bincount oracle bit for bit")
    forms, _ = _np_closed_forms(oracle)
    worst = 0.0
    for k, want in forms.items():
        worst = max(worst, _h_close(f"path H3 epoch {k}", run["epoch"][k], want, RTOL_H3))
    # per step: the first and the last step's batch values against the float64 forms of that batch's counts,
    # AMI with its EMI
    for step in (0, len(run["step_values"]) - 1):
        lo = step * H3_BATCH
        batch = np.bincount(preds[lo:lo + H3_BATCH] * H3_K + target[lo:lo + H3_BATCH],
                            minlength=H3_K * H3_K).reshape(H3_K, H3_K)
        step_forms, _ = _np_closed_forms(batch)
        step_forms["AdjustedMutualInfoScore"] = _np_ami(batch)[0]
        for i, k in enumerate(names):
            worst = max(worst, _h_close(f"path H3 step {step} {k}", run["step_values"][step][i], step_forms[k],
                                        RTOL_H3))
    cont = torch.from_numpy(oracle)
    cpu_emi, cpu_ms = _h_timed(torch.device("cpu"), lambda: clust._expected_mutual_info(cont, H3_N).item())
    _h_close("path H3 epoch EMI vs the CPU run", run["emi"], cpu_emi, RTOL_H3_EMI)
    mi, h_pred, h_true = _np_closed_forms(oracle)[1]
    cpu_ami = (mi - cpu_emi) / ((h_pred + h_true) / 2 - cpu_emi)  # AMI's closed form around the CPU run's EMI
    _h_close("path H3 epoch AMI vs the CPU run", run["epoch"]["AdjustedMutualInfoScore"], cpu_ami, RTOL_H3)
    t0 = time.perf_counter()
    first = np.bincount(preds[:H3_ORACLE_N] * H3_K + target[:H3_ORACLE_N], minlength=H3_K * H3_K).reshape(H3_K, H3_K)
    first_ami, first_emi = _np_ami(first)
    oracle_s = time.perf_counter() - t0
    _h_close(f"path H3 AMI of the first {H3_ORACLE_N} labels vs the gammaln oracle", run["first_ami"], first_ami,
             RTOL_H3)
    print(f"  ok: path H3 closed forms at the epoch and at steps 0 and {len(run['step_values']) - 1} equal numpy"
          f" float64 over the same counts (rtol {RTOL_H3}; the largest difference {worst:.2f} of the tolerance); epoch"
          f" AMI {run['epoch']['AdjustedMutualInfoScore']:.7f} equals AMI over the port's CPU float64 EMI"
          f" ({cpu_ms:.0f} ms) and the card's EMI {run['emi']:.10f} the CPU's (rtol {RTOL_H3_EMI}); the AMI of the"
          f" first {H3_ORACLE_N} labels equals the numpy gammaln EMI oracle ({first_ami:.7f}; the oracle took"
          f" {oracle_s:.1f} s)")
    steps = len(run["ms"])
    _check(run["groups"] == len(names) and run["updates"] == [len(names)] * steps
           and run["reduces"] == [run["step_reduces"]] * steps,
           f"path H3: no compute group (as in the JAX package): {len(names)} updates and {run['step_reduces']}"
           f" all_reduce (the members' {H3_K * H3_K * 8 / 1e6:.0f} MB int64 states in the step's packed sync) every"
           f" step")
    timing = {"ms_per_step": statistics.median(run["ms"]), "first_step_ms": run["ms"][0], "epoch_ms": run["epoch_ms"],
              "emi_ms": run["emi_ms"], "emi_peak_bytes": run["emi_peak"], "cpu_ami_ms": cpu_ms,
              "oracle_emi_s": oracle_s}
    prof = run.get("profile")
    print(f"[11] path H3: {steps} steps of {H3_BATCH}: median {timing['ms_per_step']:.3f} ms/step (first"
          f" {run['ms'][0]:.1f} ms); epoch compute {run['epoch_ms'][0]:.1f} ms (again {run['epoch_ms'][1]:.1f} ms); EMI"
          f" alone {run['emi_ms']:.1f} ms, peak {(run['emi_peak'] or 0) / 2**20:.0f} MiB"
          + (f"; profiled step {prof['device_ms']:.3f} ms device, {prof['share']:.0%} of the step" if prof else ""))
    if prof:
        timing.update(device_ms=prof["device_ms"], share=prof["share"])
        for op in prof["top"]:
            print(f"      {op['us_per_call']:10.1f} us x{op['per_call']:g}  {op['name'][:100]}")
    return timing


def _np_intrinsic(data, labels):
    """(Calinski-Harabasz, Davies-Bouldin) in float64 numpy, sklearn's formulas."""
    x = data.astype(np.float64)
    ks = np.unique(labels)
    counts = np.bincount(labels, minlength=H4_K)[ks].astype(np.float64)
    sums = np.zeros((H4_K, x.shape[1]))
    np.add.at(sums, labels, x)
    centroids = sums[ks] / counts[:, None]
    mean = x.mean(0)
    between = (counts * ((centroids - mean) ** 2).sum(1)).sum()
    resid = x - sums[labels] / np.bincount(labels, minlength=H4_K)[labels, None]
    within = (resid ** 2).sum()
    n, k = x.shape[0], ks.size
    ch = between * (n - k) / (within * (k - 1))
    dist = np.sqrt((resid ** 2).sum(1))
    s = np.bincount(labels, weights=dist, minlength=H4_K)[ks] / counts
    sq = (centroids ** 2).sum(1)
    m = np.sqrt(np.maximum(sq[:, None] - 2 * centroids @ centroids.T + sq[None, :], 0))
    np.fill_diagonal(m, np.inf)
    db = ((s[:, None] + s[None, :]) / m).max(1).mean()
    return ch, db


def check_path_h4(run):
    import torch

    data, labels = run["host"]
    cpu = _h4_collection("cpu")
    cpu_ms = []
    for lo in range(0, H4_N, H4_BATCH):
        _, ms = _h_timed(torch.device("cpu"), lambda: cpu.update(torch.from_numpy(data[lo:lo + H4_BATCH]),
                                                                 torch.from_numpy(labels[lo:lo + H4_BATCH])))
        cpu_ms.append(ms)
    want = {k: v.item() for k, v in cpu.compute().items()}
    _check(np.allclose(run["moments"], cpu["CH"].moments.numpy(), rtol=RTOL_H4, atol=1e-4),
           f"path H4 CH moment block ({H4_K} x {2 + H4_DIM}) equals the CPU run (rtol {RTOL_H4}, atol 1e-4)")
    ch, db = _np_intrinsic(data, labels)
    worst = 0.0
    for k, oracle in (("CH", ch), ("DB", db), ("DB_capacity", db)):
        worst = max(worst, _h_close(f"path H4 {k} vs CPU", run["epoch"][k], want[k], RTOL_H4))
        _h_close(f"path H4 {k} vs float64 oracle", run["epoch"][k], oracle, RTOL_H4_ORACLE)
    _check(run["epoch"]["DB"] == run["epoch"]["DB_capacity"], "path H4 DB: list and capacity modes give the same value")
    _check(run["tf32_equal"] and run["tf32_flags_kept"],
           "path H4 CH moments and DB give the same bits with TF32 allowed and not, and leave the caller's flags alone")
    print(f"  ok: path H4 CH {run['epoch']['CH']:.4f} and DB {run['epoch']['DB']:.6f} equal the CPU run (rtol"
          f" {RTOL_H4}; the largest difference {worst:.2f} of the tolerance) and sklearn's formulas in float64"
          f" ({ch:.4f}, {db:.6f}; rtol {RTOL_H4_ORACLE})")
    _check(run["collectives"]["all_gather"] >= 1, f"path H4 epoch compute gathers DB's samples and CH's moment block"
           f" ({run['collectives']})")
    timing = {"ms_per_step": statistics.median(run["ms"]), "first_step_ms": run["ms"][0], "epoch_ms": run["epoch_ms"],
              "peak_bytes": run["peak_bytes"], "cpu_ms_per_step": statistics.median(cpu_ms)}
    prof = run.get("profile")
    print(f"[11] path H4: {len(run['ms'])} steps of {H4_BATCH} x {H4_DIM}: median {timing['ms_per_step']:.3f} ms/step"
          f" (first {run['ms'][0]:.1f} ms); epoch compute {run['epoch_ms']:.1f} ms (gathers"
          f" {H4_N * H4_DIM * 4 / 1e6:.0f} MB twice), peak {(run['peak_bytes'] or 0) / 2**20:.0f} MiB"
          + (f"; profiled step {prof['device_ms']:.3f} ms device, {prof['share']:.0%} of the step" if prof else ""))
    if prof:
        timing.update(device_ms=prof["device_ms"], share=prof["share"])
    return timing


def _np_pairwise(name, x, y):
    x, y = x.astype(np.float64), y.astype(np.float64)
    if name == "pairwise_cosine_similarity":
        return (x / np.linalg.norm(x, axis=1, keepdims=True)) @ (y / np.linalg.norm(y, axis=1, keepdims=True)).T
    if name == "pairwise_euclidean_distance":
        return np.sqrt(np.maximum((x ** 2).sum(1)[:, None] - 2 * x @ y.T + (y ** 2).sum(1)[None, :], 0))
    if name == "pairwise_manhattan_distance":
        return np.concatenate([np.abs(x[i:i + 4, None] - y[None]).sum(-1) for i in range(0, x.shape[0], 4)])
    return x @ y.T


def _h5_variants(label, results, key, base, atol):
    """Every (reduction, zero_diagonal) variant of one function against the float64 oracle's ``base`` rows."""
    worst = 0.0
    for reduction in (None, "mean", "sum"):
        for zero_diagonal in (False, True):
            want = base.copy()
            if zero_diagonal:
                np.fill_diagonal(want, 0.0)  # the first H5_ROWS diagonal entries: rows < min(N, M)
            if reduction is None:
                tol = atol
            else:
                mass = np.abs(want).sum(-1)
                tol = RTOL_H5 * (mass / want.shape[1] if reduction == "mean" else mass)
                want = want.mean(-1) if reduction == "mean" else want.sum(-1)
            worst = max(worst, _h_close(f"{label} {reduction} zero_diagonal={zero_diagonal}",
                                        results[(*key, reduction, zero_diagonal)], want, RTOL_H5, tol))
    return worst


def check_path_h5(run):
    import torch

    import metrics_tpu_torch.functional as ptf

    x, y = run["x"], run["y"]
    rows = x[:H5_ROWS]
    worst, timing = 0.0, {}
    for name in _H5_PAIRWISE:
        cpu = getattr(ptf, name)(torch.from_numpy(rows), torch.from_numpy(y)).numpy()
        worst = max(worst, _h_close(f"path H5 {name} vs CPU", run["results"][(name, None, False)], cpu, RTOL_H5,
                                    _H5_ATOL[name]))
        worst = max(worst, _h5_variants(f"path H5 {name}", run["results"], (name,), _np_pairwise(name, rows, y),
                                        _H5_ATOL[name]))
        timing[name] = statistics.median(run["ms"][(name, r, z)] for r in (None, "mean", "sum") for z in (False, True))
    x64 = x.astype(np.float64)
    for similarity in ("cosine", "dot"):
        xs = x64 / np.linalg.norm(x64, axis=1, keepdims=True) if similarity == "cosine" else x64
        cpu = ptf.embedding_similarity(torch.from_numpy(x), similarity, "none", True)[:H5_ROWS].numpy()
        label = f"path H5 embedding_similarity {similarity}"
        worst = max(worst, _h_close(f"{label} vs CPU", run["results"][("embedding_similarity", similarity, None, True)],
                                    cpu, RTOL_H5, _H5_ATOL[similarity]))
        worst = max(worst, _h5_variants(label, run["results"], ("embedding_similarity", similarity),
                                        xs[:H5_ROWS] @ xs.T, _H5_ATOL[similarity]))
    timing["embedding_similarity"] = statistics.median(v for k, v in run["ms"].items()
                                                       if k[0] == "embedding_similarity")
    for name, (equal, kept) in run["tf32"].items():
        _check(equal and kept, f"path H5 {name}: the same bits with TF32 allowed and not; the caller's flags kept")
    img = run["images"]
    cpu = [g.numpy() for g in ptf.image_gradients(torch.from_numpy(img))]
    img64 = img.astype(np.float64)
    oracle = [np.pad(img64[..., 1:, :] - img64[..., :-1, :], ((0, 0), (0, 0), (0, 1), (0, 0))).astype(np.float32),
              np.pad(img64[..., :, 1:] - img64[..., :, :-1], ((0, 0), (0, 0), (0, 0), (0, 1))).astype(np.float32)]
    _check(all(np.array_equal(g, c) and np.array_equal(g, o) for g, c, o in zip(run["gradients"], cpu, oracle)),
           f"path H5 image_gradients of {E4_SHAPE} equal the CPU run and the float64 oracle rounded to float32 bit"
           f" for bit")
    print(f"  ok: path H5 pairwise matrices ({H5_X} x {H5_Y} x {H5_DIM}) and embedding_similarity ({H5_X} x {H5_X}),"
          f" every reduction and zero_diagonal, equal the CPU run and the float64 oracle on {H5_ROWS} rows against"
          f" every column (rtol {RTOL_H5}; the largest difference {worst:.2f} of the tolerance)")
    timing["image_gradients"] = run["gradient_ms"]
    print("[11] path H5 ms a call: " + "; ".join(f"{k} {v:.2f}" for k, v in timing.items()))
    return timing


def check_path_h(result):
    timings = {}
    for part, check in (("H1", check_path_h1), ("H2", check_path_h2), ("H3", check_path_h3), ("H4", check_path_h4),
                        ("H5", check_path_h5)):
        t0 = time.perf_counter()
        timings[part] = check(result[part])
        print(f"    path {part} checks on the host: {time.perf_counter() - t0:.1f} s")
    return timings


# ---- path I: the text family
# I1: LM evaluation at Llama 3's published vocabulary; 30 steps of 4 x 2,048 tokens: 245,760 tokens, about
# WikiText-103's test set (245,569 tokens)
I1_STEPS, I1_SHAPE = 30, (4, 2_048, 128_256)
I1_IGNORED = 0.03  # share of -100 targets
I1_BOOST = (9.5, 1.5)  # the target's logit: N(9.5, 1.5^2) over N(0, 1) logits puts the perplexity near 20
I1_CPU_STEPS = 1  # the CPU run repeats step 0; the float64 oracle holds every step
# float32 sums of float32 token log-likelihoods (a float32 log_softmax of bf16 logits) against float64
RTOL_I1 = 1e-5
# I2: ASR evaluation at LibriSpeech test-clean's size: 2,620 utterances, 52,576 reference words, batches of 64
I2_UTTERANCES, I2_WORDS, I2_BATCH, I2_VOCAB = 2_620, 52_576, 64, 20_000
I2_SUB, I2_DEL, I2_INS = 0.03, 0.01, 0.01  # per reference word: ~5% word errors
I2_CHAR_ORACLE = 256  # utterances whose character distances the plain Python DP holds (the rest: the CPU run)
# I3: MT evaluation at WMT14 En-De newstest2014's size: 3,003 sentences, one reference, batches of 64
I3_SENTENCES, I3_BATCH, I3_WORDS, I3_VOCAB = 3_003, 64, 27, 30_000
# TER's host shift search is the one host cost path I cuts: its CPU run repeats the first 8 batches (512 sentences)
# against the card's states after them; the card runs all 47
I3_TER_CPU_BATCHES = 8
# I4: CNN/DailyMail test's 11,490 summaries (references ~56 words) and SQuAD v1.1 dev's 10,570 questions
I4_PAIRS, I4_BATCH, I4_REF_WORDS, I4_VOCAB = 11_490, 64, 56, 30_000
I4_LCS_ORACLE = 640  # pairs whose LCS the plain Python DP holds (every pair: the CPU run)
I4_QUESTIONS = 10_570
# rates and means from equal integer states, or float32 sums of equal host floats, card against CPU
RTOL_I = 1e-6
# float32 sums (BLEU's clipped-count ratios, ROUGE / SQuAD per-item scores) against float64 over the same items
RTOL_I_ORACLE = 1e-5


def _zipf_words(rng, vocab, count, exponent=1.1):
    """``count`` words drawn Zipf(``exponent``) over ``vocab`` distinct lowercase words."""
    lengths = 2 + rng.geometric(0.3, vocab)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = list(dict.fromkeys("".join(rng.choice(letters, n)) for n in lengths))
    p = 1.0 / np.arange(1, len(words) + 1) ** exponent
    return np.asarray(words)[rng.choice(len(words), count, p=p / p.sum())]


def _split_total(rng, n, total, shape=1.6):
    """``n`` lengths of at least 1, gamma-spread, summing to ``total`` exactly."""
    raw = rng.gamma(shape, 1.0, n)
    lengths = 1 + np.floor(raw / raw.sum() * (total - n)).astype(np.int64)
    lengths[rng.choice(n, total - lengths.sum(), replace=False)] += 1
    return lengths


def _i1_batch(gen, device):
    """Seeded bf16 logits on the card with each target's logit raised, ~3% of the targets -100."""
    import torch

    b, t, v = I1_SHAPE
    logits = torch.randn(I1_SHAPE, generator=gen, device=device, dtype=torch.bfloat16)
    ids = torch.randint(0, v, (b, t), generator=gen, device=device)
    boost = I1_BOOST[0] + I1_BOOST[1] * torch.randn((b, t, 1), generator=gen, device=device)
    logits.scatter_(-1, ids[..., None], boost.to(torch.bfloat16))
    ids = torch.where(torch.rand((b, t), generator=gen, device=device) < I1_IGNORED, -100, ids)
    return logits, ids


def _i1_oracle(logits, ids, rows=512):
    """(float64 NLL sum, token count) of one batch, from ``logsumexp`` of float64 logits in row chunks."""
    import torch

    flat, idx = logits.reshape(-1, logits.shape[-1]), ids.reshape(-1)
    keep = idx != -100
    total = torch.zeros((), dtype=torch.float64, device=logits.device)
    for lo in range(0, flat.shape[0], rows):
        x = flat[lo:lo + rows].double()
        nll = torch.logsumexp(x, -1) - x.gather(1, idx[lo:lo + rows].clamp_min(0)[:, None])[:, 0]
        total += (nll * keep[lo:lo + rows]).sum()
    return total.item(), int(keep.sum())


def run_path_i1(device):
    import torch

    import metrics_tpu_torch as pt

    gen = torch.Generator(device=device).manual_seed(91)
    metric = pt.Perplexity(ignore_index=-100, dist_sync_on_step=True, device=device)
    out = {"values": [], "ms": [], "peaks": [], "updates": [], "reduces": [], "oracle": []}
    for step in range(I1_STEPS):
        logits, ids = _i1_batch(gen, device)
        with _CountUpdates() as up, _CountCollectives() as coll:
            value, ms, peak = _h_peak(device, lambda: metric(logits, ids))
        out["values"].append(value.item())
        out["ms"].append(ms)
        out["peaks"].append(peak)
        out["updates"].append(up[0])
        out["reduces"].append(coll["all_reduce"])
        out["oracle"].append(_i1_oracle(logits, ids))
        if step < I1_CPU_STEPS:
            out.setdefault("host", []).append((logits.cpu(), ids.cpu()))
        if step == I1_STEPS - 1 and device.type == "cuda":
            fresh = pt.Perplexity(ignore_index=-100, dist_sync_on_step=True, device=device)
            out["profile"] = _profile_call(lambda: fresh(logits, ids))
        del logits, ids
    epoch_ms = []
    for _ in range(2):
        metric._computed = None
        with _CountCollectives() as collectives:
            epoch, ms = _h_timed(device, metric.compute)
        epoch_ms.append(ms)
    out.update(epoch=epoch.item(), epoch_ms=epoch_ms, epoch_collectives=dict(collectives),
               count=int(metric.count), logits_bytes=int(np.prod(I1_SHAPE)) * 2)
    return out


def _i2_corpus():
    """(hypotheses, references): LibriSpeech test-clean's utterance and word counts over a Zipf vocabulary,
    hypotheses the references with seeded word substitutions, deletions and insertions."""
    rng = np.random.default_rng(92)
    lengths = _split_total(rng, I2_UTTERANCES, I2_WORDS)
    words = _zipf_words(rng, I2_VOCAB, I2_WORDS)
    noise = _zipf_words(rng, I2_VOCAB, I2_WORDS)
    refs, hyps, at = [], [], 0
    for n in lengths:
        ref = list(words[at:at + n])
        hyp = []
        for k, w in enumerate(ref):
            r = rng.random()
            if r >= I2_SUB + I2_DEL:
                hyp.append(w)
            elif r < I2_SUB:
                hyp.append(noise[at + k])
            if rng.random() < I2_INS:
                hyp.append(noise[-1 - at - k])
        refs.append(" ".join(ref))
        hyps.append(" ".join(hyp))
        at += n
    return hyps, refs


_I2_MEMBERS = ("WER", "CharErrorRate", "MatchErrorRate", "WordInfoLost", "WordInfoPreserved", "EditDistance")


def _i2_collection(device, **kw):
    import metrics_tpu_torch as pt

    return pt.MetricCollection([getattr(pt, name)(device=device, **kw) for name in _I2_MEMBERS])


def _i2_ids(hyps, refs):
    """The batch's words as padded int64 ids of one vocabulary (0 pads), and the lengths."""
    vocab = {}
    split = [(h.split(), r.split()) for h, r in zip(hyps, refs)]
    n = max(1, max(len(h) for h, _ in split))
    m = max(1, max(len(r) for _, r in split))
    pred, target = np.zeros((len(split), n), np.int64), np.zeros((len(split), m), np.int64)
    for k, (h, r) in enumerate(split):
        pred[k, :len(h)] = [vocab.setdefault(w, len(vocab) + 1) for w in h]
        target[k, :len(r)] = [vocab.setdefault(w, len(vocab) + 1) for w in r]
    return pred, target, np.array([len(h) for h, _ in split]), np.array([len(r) for _, r in split])


def run_path_i2(device):
    import torch

    import metrics_tpu_torch as pt
    import metrics_tpu_torch.functional as ptf

    hyps, refs = _i2_corpus()
    batches = [(hyps[lo:lo + I2_BATCH], refs[lo:lo + I2_BATCH]) for lo in range(0, I2_UTTERANCES, I2_BATCH)]
    col = _i2_collection(device, dist_sync_on_step=True)
    values, ms, updates, reduces = [], [], [], []
    for batch in batches:
        with _CountUpdates() as up, _CountCollectives() as coll:
            value, step_ms = _h_timed(device, lambda: col(*batch))
        values.append({k: v.item() for k, v in value.items()})
        ms.append(step_ms)
        updates.append(up[0])
        reduces.append(coll["all_reduce"])
    epoch, epoch_ms, collectives, _ = _epoch_timed(col, device)
    # the same utterances as padded id tensors through the batched DP on the card, into WER.update_counts
    wer_dev = pt.WER(device=device)
    dists, dp_ms = [], []
    for batch in batches:
        pred, target, pl, tl = (torch.from_numpy(x).to(device) for x in _i2_ids(*batch))
        d, call_ms = _h_timed(device, lambda: ptf.edit_distance_padded(pred, target, pl, tl))
        wer_dev.update_counts(d, tl)
        dists.append(d.cpu().numpy())
        dp_ms.append(call_ms)
    out = {"hyps": hyps, "refs": refs, "values": values, "ms": ms, "updates": updates, "reduces": reduces,
           "step_reduces": _packed_step_reduces(col),
           "epoch": {k: v.item() for k, v in epoch.items()}, "epoch_ms": epoch_ms, "epoch_collectives": collectives,
           "states": _text_states(col), "dists": np.concatenate(dists), "dp_ms": dp_ms,
           "update_counts": (int(wer_dev.errors), int(wer_dev.total)), "wer_counts": wer_dev.compute().item()}
    if device.type == "cuda":
        fresh = _i2_collection(device, dist_sync_on_step=True)
        out["profile"] = _profile_call(lambda: fresh(*batches[1]), calls=3)
        pred, target, pl, tl = (torch.from_numpy(x).to(device) for x in _i2_ids(*batches[1]))
        out["dp_profile"] = _profile_call(lambda: ptf.edit_distance_padded(pred, target, pl, tl), calls=3)
    return out


def _text_states(metrics):
    """Every state of every member, on the host."""
    return {f"{name}.{s}": getattr(m, s).cpu().numpy() for name, m in metrics.items() for s in m._defaults}


_I3_PUNCT = (",", ".", ",", ".", "?", "!", ":", ";")


def _i3_sentence(rng, words, numbers):
    """A detokenized newstest-style sentence: capitals, trailing punctuation, numbers, hyphens, quote entities."""
    n = max(3, int(rng.gamma(3.0, I3_WORDS / 3.0)))
    out = []
    for k, w in enumerate(rng.choice(words, n)):
        r = rng.random()
        if r < 0.05:
            w = numbers[int(rng.integers(0, len(numbers)))]
        elif r < 0.08:
            w = f"{w}-{rng.choice(words)}"
        elif r < 0.11:
            w = f"&quot;{w}&quot;"
        if k == 0 or rng.random() < 0.08:
            w = w[:1].upper() + w[1:]
        if rng.random() < 0.07:
            w += str(rng.choice(_I3_PUNCT))
        out.append(w)
    return " ".join(out) + "."


def _i3_corpus():
    rng = np.random.default_rng(93)
    words = _zipf_words(rng, I3_VOCAB, 200_000)
    numbers = ["3.5", "1,000", "2014", "-5", "20-30", "0.25", "100,000", "7"]
    refs = [_i3_sentence(rng, words, numbers) for _ in range(I3_SENTENCES)]
    hyps = []
    for ref in refs:
        toks = ref.split()
        hyp = []
        for w in toks:
            r = rng.random()
            if r < 0.15:
                hyp.append(str(rng.choice(words)))
            elif r >= 0.2:
                hyp.append(w)
            if rng.random() < 0.05:
                hyp.append(str(rng.choice(words)))
        if len(hyp) > 4 and rng.random() < 0.5:  # a reordered block, for TER's shifts
            i = int(rng.integers(0, len(hyp) - 4))
            hyp[i:i + 4] = hyp[i + 2:i + 4] + hyp[i:i + 2]
        hyps.append(" ".join(hyp))
    return hyps, refs


def _i3_ter_batches():
    return min(I3_TER_CPU_BATCHES, -(-I3_SENTENCES // I3_BATCH))


def _i3_metrics(device):
    import metrics_tpu_torch as pt

    return {"SacreBLEUScore": pt.SacreBLEUScore(tokenize="13a", device=device), "BLEUScore": pt.BLEUScore(device=device),
            "CHRFScore": pt.CHRFScore(device=device), "TranslationEditRate": pt.TranslationEditRate(device=device)}


def _i3_feed(metrics, hyps, refs, times=None):
    for name, metric in metrics.items():
        if metric is None:
            continue
        target = refs if name == "CHRFScore" else [[r] for r in refs]
        t0 = time.perf_counter()
        metric.update(hyps, target)
        if times is not None:
            _sync(metric.device)
            times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)


def run_path_i3(device):
    hyps, refs = _i3_corpus()
    metrics = _i3_metrics(device)
    times = {}
    for step, lo in enumerate(range(0, I3_SENTENCES, I3_BATCH)):
        _i3_feed(metrics, hyps[lo:lo + I3_BATCH], refs[lo:lo + I3_BATCH], times)
        if step == _i3_ter_batches() - 1:
            ter_first = _text_states({"TranslationEditRate": metrics["TranslationEditRate"]})
    epoch, epoch_ms, collectives = {}, {}, {}
    for name, metric in metrics.items():
        with _CountCollectives() as coll:
            value, epoch_ms[name] = _h_timed(device, metric.compute)
        epoch[name], collectives[name] = value.item(), dict(coll)
    return {"hyps": hyps, "refs": refs, "ms": times, "epoch": epoch, "epoch_ms": epoch_ms,
            "epoch_collectives": collectives, "states": _text_states(metrics), "ter_first": ter_first}


def _i4_rouge_corpus():
    """(summaries, references): ~56-word references, summaries of copied reference spans and other words."""
    rng = np.random.default_rng(94)
    words = _zipf_words(rng, I4_VOCAB, 1_000_000)
    refs, hyps, at = [], [], 0
    for _ in range(I4_PAIRS):
        n = max(8, int(rng.normal(I4_REF_WORDS, 12)))
        ref = list(words[at % (len(words) - 200):][:n])
        at += n
        hyp, m = [], max(4, int(rng.normal(0.9 * n, 10)))
        while len(hyp) < m:
            if rng.random() < 0.6:
                lo = int(rng.integers(0, n))
                hyp += ref[lo:lo + int(rng.integers(2, 12))]
            else:
                hyp += list(rng.choice(words, int(rng.integers(1, 6))))
        refs.append(" ".join(w.capitalize() if rng.random() < 0.1 else w for w in ref) + ".")
        hyps.append(", ".join(hyp[:m]))
    return hyps, refs


_I4_ARTICLES = ("the", "a", "an")


def _i4_squad_corpus():
    """SQuAD v1.1 dev's size: answers of 1-5 words with articles and punctuation, 1-3 answers a question;
    predictions exact, re-cased, re-punctuated, partial or wrong."""
    rng = np.random.default_rng(95)
    words = _zipf_words(rng, I4_VOCAB, 200_000)
    preds, answers = [], []
    for q in range(I4_QUESTIONS):
        base = list(rng.choice(words, int(rng.integers(1, 6))))
        if rng.random() < 0.4:
            base.insert(0, str(rng.choice(_I4_ARTICLES)))
        gold = [" ".join(base)]
        for _ in range(int(rng.integers(0, 3))):
            gold.append(" ".join(base[int(rng.integers(0, len(base))):]) + str(rng.choice(["", ".", ",", "'s"])))
        r = rng.random()
        if r < 0.45:
            pred = gold[0]
        elif r < 0.6:
            pred = gold[0].upper() + "!"
        elif r < 0.85:
            pred = " ".join(base[:max(1, len(base) - 1)] + list(rng.choice(words, int(rng.integers(0, 3)))))
        else:
            pred = " ".join(rng.choice(words, int(rng.integers(1, 5))))
        preds.append(pred)
        answers.append(gold)
    return preds, answers


def run_path_i4(device):
    import metrics_tpu_torch as pt
    from metrics_tpu_torch.functional import text_rouge

    hyps, refs = _i4_rouge_corpus()
    rouge = pt.ROUGEScore(("rouge1", "rouge2", "rougeL"), device=device)
    ms, lcs, lcs_ms, cells = [], [], [], []
    for lo in range(0, I4_PAIRS, I4_BATCH):
        batch = (hyps[lo:lo + I4_BATCH], refs[lo:lo + I4_BATCH])
        _, step_ms = _h_timed(device, lambda: rouge.update(*batch))
        ms.append(step_ms)
        pairs = [(text_rouge._rouge_tokens(p), text_rouge._rouge_tokens(t)) for p, t in zip(*batch)]
        cells.append(sum(len(a) * len(b) for a, b in pairs))
        got, call_ms = _h_timed(device, lambda: text_rouge._lcs_lens(pairs, device))
        lcs += got
        lcs_ms.append(call_ms)
    with _CountCollectives() as coll:
        epoch, epoch_ms = _h_timed(device, rouge.compute)
    preds, answers = _i4_squad_corpus()
    squad = pt.SQuAD(device=device)
    squad_ms = []
    for lo in range(0, I4_QUESTIONS, I4_BATCH):
        _, step_ms = _h_timed(device, lambda: squad.update(preds[lo:lo + I4_BATCH], answers[lo:lo + I4_BATCH]))
        squad_ms.append(step_ms)
    squad_epoch, squad_epoch_ms = _h_timed(device, squad.compute)
    return {"hyps": hyps, "refs": refs, "ms": ms, "lcs": lcs, "lcs_ms": lcs_ms, "min_cells": min(cells),
            "epoch": {k: v.item() for k, v in epoch.items()}, "epoch_ms": epoch_ms, "epoch_collectives": dict(coll),
            "states": _text_states({"ROUGEScore": rouge, "SQuAD": squad}), "squad_preds": preds,
            "squad_answers": answers, "squad_ms": squad_ms, "squad_epoch": {k: v.item() for k, v in squad_epoch.items()},
            "squad_epoch_ms": squad_epoch_ms}


def run_path_i(device):
    """Path I inside the caller's process group: I1-I4 on the card, timed, with what the checks need on the host."""
    return {"I1": run_path_i1(device), "I2": run_path_i2(device), "I3": run_path_i3(device),
            "I4": run_path_i4(device)}


# ---- path I's oracles: plain Python DPs and Counter n-grams, no code shared with the port

def _py_levenshtein(a, b):
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, y in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y))
        prev = cur
    return prev[-1]


def _py_distance_hits(a, b):
    """(distance, hits): the fewest edits and, among minimum-edit alignments, the most matched tokens."""
    prev = [(j, 0) for j in range(len(b) + 1)]
    for i, x in enumerate(a, 1):
        cur = [(i, 0)] + [None] * len(b)
        for j, y in enumerate(b, 1):
            d, h = prev[j - 1]
            cands = ((d, -(h + 1)) if x == y else (d + 1, -h), (prev[j][0] + 1, -prev[j][1]),
                     (cur[j - 1][0] + 1, -cur[j - 1][1]))
            best = min(cands)
            cur[j] = (best[0], -best[1])
        prev = cur
    return prev[-1]


def _py_lcs(a, b):
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def _i_close(label, got, want, rtol):
    """Relative closeness; returns the difference as a share of the tolerance."""
    if not np.isclose(got, want, rtol=rtol, atol=0.0):
        raise AssertionError(f"{label}: {got} vs {want} (rtol {rtol})")
    return abs(got - want) / (rtol * abs(want)) if want else 0.0


def _i_states_equal(label, got, want):
    """Integer states equal bit for bit, float states to RTOL_I."""
    _check(sorted(got) == sorted(want), f"{label}: the card holds the CPU run's {len(want)} states")
    for k, v in want.items():
        if v.dtype.kind == "i":
            if not np.array_equal(got[k], v):
                raise AssertionError(f"{label} {k}: {got[k]} on the card, {v} on the CPU")
        else:
            np.testing.assert_allclose(got[k], v, rtol=RTOL_I, err_msg=f"{label} {k}")
    print(f"  ok: {label}: integer states equal the CPU run's bit for bit, float32 states within rtol {RTOL_I}")


def check_path_i1(run):
    import torch

    import metrics_tpu_torch as pt

    worst = max(_i_close(f"path I1 step {s} perplexity vs float64", v, np.exp(t / n), RTOL_I1)
                for s, (v, (t, n)) in enumerate(zip(run["values"], run["oracle"])))
    total = sum(t for t, _ in run["oracle"])
    count = sum(n for _, n in run["oracle"])
    worst = max(worst, _i_close("path I1 epoch perplexity vs float64", run["epoch"], np.exp(total / count), RTOL_I1))
    _check(run["count"] == count, f"path I1 token count {run['count']:,} equals the oracle's ({count:,} of"
           f" {I1_STEPS * I1_SHAPE[0] * I1_SHAPE[1]:,}: the -100 targets drop out)")
    cpu = pt.Perplexity(ignore_index=-100, device="cpu")
    for step, (logits, ids) in enumerate(run["host"]):
        value, cpu_ms = _h_timed(torch.device("cpu"), lambda: cpu(logits, ids))
        _i_close(f"path I1 step {step} vs the CPU run", run["values"][step], value.item(), RTOL_I1)
        _check(int(cpu.count) == run["oracle"][step][1], f"path I1 step {step} count equals the CPU run's")
    print(f"  ok: path I1: every step's and the epoch's perplexity equals the float64 oracle (rtol {RTOL_I1}; the"
          f" largest difference {worst:.2f} of the tolerance), step 0 the CPU run ({cpu_ms:.0f} ms on the host);"
          f" epoch perplexity {run['epoch']:.4f} over {count:,} tokens")
    _check(run["updates"] == [1] * I1_STEPS and run["reduces"] == [2] * I1_STEPS,
           "path I1: one update and two all_reduce calls (float32 total, int64 count) a step")
    peak = max(p for p in run["peaks"] if p is not None) if run["peaks"][0] is not None else None
    if peak is not None:
        _check(peak < 2 << 30, f"path I1 peak device memory of a step above its {run['logits_bytes'] / 1e9:.2f} GB of"
               f" logits: {peak / 2**20:.0f} MiB (< 2 GiB of chunk temporaries)")
    ms = statistics.median(run["ms"])
    bound_ms = run["logits_bytes"] / HBM_BYTES_PER_S * 1e3
    timing = {"ms_per_step": ms, "first_step_ms": run["ms"][0], "epoch_ms": run["epoch_ms"], "peak_bytes": peak,
              "bound_ms": bound_ms}
    line = (f"[12] path I1: {I1_STEPS} steps of {I1_SHAPE} bf16 logits: median {ms:.3f} ms/step (first"
            f" {run['ms'][0]:.1f} ms; one read of the logits at {HBM_BYTES_PER_S / 1e12:.2f} TB/s: {bound_ms:.3f} ms);"
            f" epoch compute {run['epoch_ms'][1]:.2f} ms")
    prof = run.get("profile")
    if prof:
        timing.update(device_ms=prof["device_ms"], share=prof["device_ms"] / ms, ops=prof["ops"],
                      host_syncs=prof["host_syncs"])
        line += (f"; profiled step {prof['device_ms']:.3f} ms device ({timing['share']:.0%}), {prof['ops']} operations,"
                 f" {prof['host_syncs']} synchronizing calls {prof['sync_sites']}")
    print(line)
    if prof:
        for op in prof["top"]:
            print(f"      {op['us_per_call']:10.1f} us x{op['per_call']:g}  {op['name'][:100]}")
    return timing


def check_path_i2(run):
    import torch

    hyps, refs = run["hyps"], run["refs"]
    t0 = time.perf_counter()
    word = [_py_distance_hits(h.split(), r.split()) for h, r in zip(hyps, refs)]
    plain_dist = [_py_levenshtein(h.split(), r.split()) for h, r in zip(hyps, refs)]
    oracle_s = time.perf_counter() - t0
    _check(list(run["dists"]) == plain_dist, f"path I2: edit_distance_padded on the card equals the plain Python DP"
           f" on all {len(hyps):,} utterances")
    _check([d for d, _ in word] == plain_dist, "path I2: the oracle's two DPs agree on every distance")
    errors, hits = sum(d for d, _ in word), sum(h for _, h in word)
    n_ref, n_hyp = sum(len(r.split()) for r in refs), sum(len(h.split()) for h in hyps)
    _check(n_ref == I2_WORDS, f"path I2 corpus: {len(refs):,} utterances, {n_ref:,} reference words")
    st = run["states"]
    _check(int(st["WER.errors"]) == errors and int(st["WER.total"]) == n_ref
           and run["update_counts"] == (errors, n_ref)
           and all(int(st[f"{m}.errors"]) == errors and int(st[f"{m}.hits"]) == hits
                   and int(st[f"{m}.total_target"]) == n_ref and int(st[f"{m}.total_pred"]) == n_hyp
                   for m in ("MatchErrorRate", "WordInfoLost", "WordInfoPreserved")),
           f"path I2 word states equal the plain Python DP: {errors:,} errors, {hits:,} hits, {n_ref:,} reference and"
           f" {n_hyp:,} predicted words (WER.update_counts from the card's distances too)")
    chars = [_py_levenshtein(h, r) for h, r in zip(hyps[:I2_CHAR_ORACLE], refs[:I2_CHAR_ORACLE])]
    from metrics_tpu_torch.functional.text import _np_edit_distance

    _check(chars == [_np_edit_distance(list(h), list(r)) for h, r in zip(hyps[:I2_CHAR_ORACLE], refs)],
           f"path I2: the port's character DP equals the plain Python DP on the first {I2_CHAR_ORACLE} utterances")
    cpu = _i2_collection("cpu", dist_sync_on_step=True)
    worst = 0.0
    for step, lo in enumerate(range(0, len(hyps), I2_BATCH)):
        value = cpu(hyps[lo:lo + I2_BATCH], refs[lo:lo + I2_BATCH])
        for k, v in value.items():
            worst = max(worst, _i_close(f"path I2 step {step} {k} vs CPU", run["values"][step][k], v.item(), RTOL_I))
    _i_states_equal("path I2", st, _text_states(cpu))
    n_chars = int(st["CharErrorRate.total_target"])
    oracle = {"WER": errors / n_ref, "CharErrorRate": int(st["CharErrorRate.errors"]) / n_chars,
              "MatchErrorRate": errors / (errors + hits), "WordInfoPreserved": (hits / n_ref) * (hits / n_hyp),
              "WordInfoLost": 1 - (hits / n_ref) * (hits / n_hyp),
              "EditDistance": int(st["EditDistance.total_distance"]) / len(hyps)}
    for k, want in oracle.items():
        worst = max(worst, _i_close(f"path I2 epoch {k} vs oracle", run["epoch"][k], want, RTOL_I))
    _i_close("path I2 WER from the card's distances", run["wer_counts"], errors / n_ref, RTOL_I)
    print(f"  ok: path I2: {len(run['ms'])} steps, every step and epoch value equals the CPU run, the epoch values the"
          f" float64 rates of the oracle's counts (rtol {RTOL_I}; the largest difference {worst:.2f} of the"
          f" tolerance; oracle DPs {oracle_s:.1f} s); epoch {run['epoch']}")
    n_groups = len(_I2_MEMBERS)
    _check(run["updates"] == [n_groups] * len(run["ms"]) and run["reduces"] == [run["step_reduces"]] * len(run["ms"]),
           f"path I2: {n_groups} updates and {run['step_reduces']} all_reduce a step (six singleton groups of int64"
           f" states, as in the JAX package, in the step's packed sync)")
    ms = statistics.median(run["ms"])
    timing = {"ms_per_step": ms, "first_step_ms": run["ms"][0], "epoch_ms": run["epoch_ms"],
              "dp_ms": statistics.median(run["dp_ms"])}
    line = (f"[12] path I2: {len(run['ms'])} steps of {I2_BATCH} utterances: median {ms:.3f} ms/step; epoch compute"
            f" {run['epoch_ms'][1]:.2f} ms; edit_distance_padded {timing['dp_ms']:.3f} ms a batch")
    for key in ("profile", "dp_profile"):
        prof = run.get(key)
        if prof:
            wall = ms if key == "profile" else timing["dp_ms"]
            timing[key] = {"device_ms": prof["device_ms"], "share": prof["device_ms"] / wall, "ops": prof["ops"],
                           "host_syncs": prof["host_syncs"]}
            line += (f"; {'step' if key == 'profile' else 'DP'} profiled: {prof['device_ms']:.3f} ms device"
                     f" ({timing[key]['share']:.0%}), {prof['ops']} operations, {prof['host_syncs']} synchronizing"
                     f" calls {prof['sync_sites'][:3]}")
    print(line)
    return timing


def _ngrams(tokens, n):
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def _oracle_bleu(hyps, refs, n_gram=4):
    """(clipped matches, totals, c, r) from Counter n-grams, and the float64 BLEU made from them."""
    num, den, c, r = [0] * n_gram, [0] * n_gram, 0, 0
    for h, rs in zip(hyps, refs):
        c += len(h)
        r += min((abs(len(x) - len(h)), k, len(x)) for k, x in enumerate(rs))[2]
        for n in range(1, n_gram + 1):
            hc = _ngrams(h, n)
            best = Counter()
            for x in rs:
                best |= _ngrams(x, n)
            num[n - 1] += sum(min(v, best[g]) for g, v in hc.items())
            den[n - 1] += sum(hc.values())
    if min(num) == 0:
        return num, den, c, r, 0.0
    log_p = sum(np.log(a / b) for a, b in zip(num, den)) / n_gram
    return num, den, c, r, (1.0 if c > r else np.exp(1 - r / c)) * np.exp(log_p)


def _oracle_chrf(hyps, refs, order=6, beta=2.0):
    stats = np.zeros((3, order), np.int64)
    for h, r in zip(hyps, refs):
        h, r = "".join(h.split()), "".join(r.split())
        for n in range(1, order + 1):
            hc = Counter(h[i:i + n] for i in range(len(h) - n + 1))
            rc = Counter(r[i:i + n] for i in range(len(r) - n + 1))
            stats[0, n - 1] += sum(min(v, rc[g]) for g, v in hc.items())
            stats[1, n - 1] += sum(hc.values()) if rc else 0
            stats[2, n - 1] += sum(rc.values())
    eff = (stats[1] > 0) & (stats[2] > 0)
    prec = (stats[0][eff] / stats[1][eff]).mean()
    rec = (stats[0][eff] / stats[2][eff]).mean()
    return stats, (1 + beta**2) * prec * rec / (beta**2 * prec + rec)


def check_path_i3(run):
    import torch

    from metrics_tpu_torch.functional.text_sacrebleu import tokenize_sacrebleu

    hyps, refs = run["hyps"], run["refs"]
    st = run["states"]
    t0 = time.perf_counter()
    worst = 0.0
    for name, tok in (("BLEUScore", str.split), ("SacreBLEUScore", lambda s: tokenize_sacrebleu(s, "13a"))):
        num, den, c, r, score = _oracle_bleu([tok(h) for h in hyps], [[tok(x)] for x in refs])
        np.testing.assert_allclose(st[f"{name}.numerator"], num, rtol=RTOL_I_ORACLE, err_msg=f"path I3 {name}")
        _check(st[f"{name}.denominator"].tolist() == den and int(st[f"{name}.trans_len"]) == c
               and int(st[f"{name}.ref_len"]) == r, f"path I3 {name}: n-gram totals {den}, lengths {c:,} / {r:,} equal"
               f" Counter n-grams; clipped matches {num} within rtol {RTOL_I_ORACLE}")
        worst = max(worst, _i_close(f"path I3 {name} vs float64", run["epoch"][name], score, RTOL_I_ORACLE))
    stats, chrf = _oracle_chrf(hyps, refs)
    _check(np.array_equal(st["CHRFScore.stats"], stats), "path I3 CHRFScore statistics equal Counter character"
           " n-grams bit for bit")
    worst = max(worst, _i_close("path I3 CHRFScore vs float64", run["epoch"]["CHRFScore"], chrf, RTOL_I))
    oracle_s = time.perf_counter() - t0
    cpu = _i3_metrics(torch.device("cpu"))
    ter = cpu.pop("TranslationEditRate")
    t0 = time.perf_counter()
    for step, lo in enumerate(range(0, I3_SENTENCES, I3_BATCH)):
        _i3_feed(cpu, hyps[lo:lo + I3_BATCH], refs[lo:lo + I3_BATCH])
        if step < _i3_ter_batches():
            _i3_feed({"TranslationEditRate": ter}, hyps[lo:lo + I3_BATCH], refs[lo:lo + I3_BATCH])
    cpu_s = time.perf_counter() - t0
    _i_states_equal("path I3", {k: v for k, v in st.items() if not k.startswith("Translation")}, _text_states(cpu))
    _i_states_equal(f"path I3 TER after the first {_i3_ter_batches()} batches (cut: the CPU run repeats only"
                    f" these)", run["ter_first"], _text_states({"TranslationEditRate": ter}))
    for name, metric in cpu.items():
        worst = max(worst, _i_close(f"path I3 {name} vs CPU", run["epoch"][name], metric.compute().item(), RTOL_I))
    _check(all(c["all_gather"] == 0 for c in run["epoch_collectives"].values())
           and [c["all_reduce"] for c in run["epoch_collectives"].values()] == [2, 2, 1, 1],
           "path I3 epoch computes sync with one all_reduce per state dtype (BLEU float32 + int64, chrF int64, TER"
           " float32), no gather")
    print(f"  ok: path I3: {I3_SENTENCES:,} sentences; states equal the CPU run, values the float64 oracle (the"
          f" largest difference {worst:.2f} of the tolerance; oracle {oracle_s:.1f} s, CPU run {cpu_s:.1f} s); epoch"
          f" {run['epoch']}")
    timing = {f"{k}_ms_per_step": statistics.median(v) for k, v in run["ms"].items()}
    timing["epoch_ms"] = run["epoch_ms"]
    print("[12] path I3 median ms an update of 64 sentences: " + "; ".join(
        f"{k} {statistics.median(v):.2f} (total {sum(v) / 1e3:.2f} s)" for k, v in run["ms"].items())
        + "; epoch compute ms: " + "; ".join(f"{k} {v:.2f}" for k, v in run["epoch_ms"].items()))
    return timing


_SQUAD_PUNCT = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def _squad_tokens(text):
    text = "".join(ch for ch in text.lower() if ch not in _SQUAD_PUNCT)
    return [w for w in text.split() if w not in _I4_ARTICLES]


def _squad_oracle(preds, answers):
    em = f1 = 0.0
    for p, golds in zip(preds, answers):
        pt_ = _squad_tokens(p)
        best_em = best_f1 = 0.0
        for g in golds:
            gt = _squad_tokens(g)
            best_em = max(best_em, float(pt_ == gt))
            common = sum((Counter(pt_) & Counter(gt)).values())
            if common:
                prec, rec = common / len(pt_), common / len(gt)
                best_f1 = max(best_f1, 2 * prec * rec / (prec + rec))
        em += best_em
        f1 += best_f1
    return {"exact_match": 100 * em / len(preds), "f1": 100 * f1 / len(preds)}


def check_path_i4(run):
    import re

    import torch

    import metrics_tpu_torch as pt
    from metrics_tpu_torch.functional import text_rouge

    hyps, refs = run["hyps"], run["refs"]
    _check(run["min_cells"] >= 50_000, f"path I4: every ROUGE batch holds at least {run['min_cells']:,} LCS cells, so"
           " its LCS ran on the card")

    def tokens(s):
        return [t for t in re.split(r"[^a-z0-9]+", s.lower()) if t]

    pairs = [(tokens(h), tokens(r)) for h, r in zip(hyps, refs)]
    t0 = time.perf_counter()
    oracle_lcs = [_py_lcs(a, b) for a, b in pairs[:I4_LCS_ORACLE]]
    _check(run["lcs"][:I4_LCS_ORACLE] == oracle_lcs, f"path I4: the card's LCS equals the plain Python DP on the first"
           f" {I4_LCS_ORACLE} pairs")
    cpu_lcs = []
    for lo in range(0, I4_PAIRS, I4_BATCH):
        cpu_lcs += text_rouge._lcs_lens(pairs[lo:lo + I4_BATCH], torch.device("cpu"))
    _check(run["lcs"] == cpu_lcs, f"path I4: the card's LCS equals the CPU run's on all {I4_PAIRS:,} pairs")
    sums = {}
    for (a, b), lcs in zip(pairs, run["lcs"]):
        for key, (overlap, pa, pb) in {
            "rouge1": (sum((_ngrams(a, 1) & _ngrams(b, 1)).values()), len(a), len(b)),
            "rouge2": (sum((_ngrams(a, 2) & _ngrams(b, 2)).values()), max(len(a) - 1, 0), max(len(b) - 1, 0)),
            "rougeL": (lcs, len(a), len(b)),
        }.items():
            p, r = (overlap / pa if pa else 0.0), (overlap / pb if pb else 0.0)
            for stat, v in zip(("precision", "recall", "fmeasure"), (p, r, 2 * p * r / (p + r) if p + r else 0.0)):
                sums[f"{key}_{stat}"] = sums.get(f"{key}_{stat}", 0.0) + v
    worst = max(_i_close(f"path I4 {k} vs float64", run["epoch"][k], v / I4_PAIRS, RTOL_I_ORACLE)
                for k, v in sums.items())
    squad = _squad_oracle(run["squad_preds"], run["squad_answers"])
    worst = max(worst, *(_i_close(f"path I4 SQuAD {k} vs float64", run["squad_epoch"][k], v, RTOL_I_ORACLE)
                         for k, v in squad.items()))
    oracle_s = time.perf_counter() - t0
    rouge = pt.ROUGEScore(("rouge1", "rouge2", "rougeL"), device="cpu")
    squad_cpu = pt.SQuAD(device="cpu")
    for lo in range(0, I4_PAIRS, I4_BATCH):
        rouge.update(hyps[lo:lo + I4_BATCH], refs[lo:lo + I4_BATCH])
    for lo in range(0, I4_QUESTIONS, I4_BATCH):
        squad_cpu.update(run["squad_preds"][lo:lo + I4_BATCH], run["squad_answers"][lo:lo + I4_BATCH])
    _i_states_equal("path I4", run["states"], _text_states({"ROUGEScore": rouge, "SQuAD": squad_cpu}))
    _check(run["epoch_collectives"]["all_gather"] == 0 and run["epoch_collectives"]["all_reduce"] == 2,
           "path I4 ROUGE epoch compute: two all_reduce calls (float32 sums, int64 pair count), no gather")
    print(f"  ok: path I4: ROUGE over {I4_PAIRS:,} pairs and SQuAD over {I4_QUESTIONS:,} questions equal the CPU run's"
          f" states and the float64 oracle (rtol {RTOL_I_ORACLE}; the largest difference {worst:.2f} of the tolerance;"
          f" oracle {oracle_s:.1f} s); ROUGE {run['epoch']}; SQuAD {run['squad_epoch']}")
    timing = {"rouge_ms_per_step": statistics.median(run["ms"]), "lcs_ms": statistics.median(run["lcs_ms"]),
              "rouge_epoch_ms": run["epoch_ms"], "squad_ms_per_step": statistics.median(run["squad_ms"]),
              "squad_epoch_ms": run["squad_epoch_ms"]}
    print(f"[12] path I4: ROUGE median {timing['rouge_ms_per_step']:.2f} ms an update of {I4_BATCH} pairs (the LCS on"
          f" the card {timing['lcs_ms']:.2f} ms of a batch), epoch {run['epoch_ms']:.2f} ms; SQuAD"
          f" {timing['squad_ms_per_step']:.2f} ms an update, epoch {run['squad_epoch_ms']:.2f} ms")
    return timing


def check_path_i(result):
    timings = {}
    for part, check in (("I1", check_path_i1), ("I2", check_path_i2), ("I3", check_path_i3), ("I4", check_path_i4)):
        t0 = time.perf_counter()
        timings[part] = check(result[part])
        print(f"    path {part} checks on the host: {time.perf_counter() - t0:.1f} s")
    return timings


# Path J: the pure view, the keyed slab and the wrappers at a multi-tenant deployment's size: per-tenant metrics over
# 10,000 tenants (the JAX package's bench.py:138, KEYED_SLOTS), a heavy-hitter tier over a 1,000,000-key space with
# 256 hot rows and a (4, 1,024) tail (bench.py:163-166), at the port's default sketch grids
J_SLOTS = 10_000
J_STEPS, J_N = 20, 65_536
J_UNSEEN = 16  # tenant ids the Zipf draw never reaches: the empty policy
J_OUT = 32  # out-of-range ids a batch (half -1, half K): the drops
J_CPU_STEPS = 2  # steps the CPU run of J1, J2, J3 and J4 repeats; the numpy oracles hold every step
J_QUANTILE_TENANTS = 8
J3_COHORTS = 1_000
J4_HOT, J4_TAIL, J4_KEYS, J4_TAIL_CHECKS = 256, (4, 1_024), 1_000_000, 64
J5_STEPS, J5_COPIES = 10, 100
J6_EPOCHS, J6_OUTPUTS, J6_WINDOW = 3, 8, 5
J6_ROWS = 2 * E1_N // J6_OUTPUTS  # two of E1's batches a step: 1,048,576 x 8
J_PEAK_BUDGET = 1 << 30  # J1 / J2: peak device bytes a step above what was live before it
# per-tenant AUROC and the bootstrap mean / std from equal counts: float64 math rounded once to float32, against
# float64 numpy over the oracle counts
RTOL_J = 1e-5
RTOL_J_FLOAT = 1e-6  # float32 sums in another order (Running's MSE, MultioutputWrapper's R2)


def _j_tenant_draw(seed, steps, n, num_slots, unseen):
    """Per step ``n`` tenant ids drawn Zipf(1.1) over ``num_slots - unseen`` ranks through a seeded permutation (the
    last ``unseen`` tenants of the permutation are never drawn), with ``J_OUT`` ids out of range (-1 and K) at
    random places; and the unseen tenants."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(num_slots)
    cdf = np.cumsum(np.arange(1, num_slots - unseen + 1, dtype=np.float64) ** -1.1)
    cdf /= cdf[-1]
    draws = []
    for _ in range(steps):
        slots = perm[np.minimum(np.searchsorted(cdf, rng.random_sample(n), side="right"), len(cdf) - 1)]
        bad = rng.choice(n, J_OUT, replace=False)
        slots[bad[: J_OUT // 2]], slots[bad[J_OUT // 2:]] = -1, num_slots
        draws.append(slots.astype(np.int64))
    return draws, np.sort(perm[num_slots - unseen:])


def _j_data():
    """J1 / J2 / J5 / J7 host batches: tenant ids, 30% positive labels with scores sigmoid(N(0, 1) + 1.5 label), and
    request latencies in seconds (lognormal, 20 ms median, sigma 1)."""
    rng = np.random.RandomState(51)
    slots, unseen = _j_tenant_draw(50, J_STEPS, J_N, J_SLOTS, J_UNSEEN)
    batches = []
    for s in slots:
        labels = (rng.random_sample(J_N) < 0.3).astype(np.int64)
        scores = (1 / (1 + np.exp(-(rng.standard_normal(J_N) + 1.5 * labels)))).astype(np.float32)
        latency = (0.02 * np.exp(rng.standard_normal(J_N))).astype(np.float32)
        batches.append({"slots": s, "labels": labels, "scores": scores, "latency": latency})
    return batches, unseen


def _j_keys():
    """J4's keys: Zipf(1.1) over 1,000,000 keys through a seeded permutation, one int key a sample."""
    rng = np.random.RandomState(52)
    perm = rng.permutation(J4_KEYS)
    cdf = np.cumsum(np.arange(1, J4_KEYS + 1, dtype=np.float64) ** -1.1)
    cdf /= cdf[-1]
    return [perm[np.minimum(np.searchsorted(cdf, rng.random_sample(J_N), side="right"), J4_KEYS - 1)]
            for _ in range(J_STEPS)]


def _j_host(value):
    if isinstance(value, dict):
        return {k: _j_host(v) for k, v in value.items()}
    # a copy: states the wrappers update in place must not change a snapshot taken on the CPU
    return value.detach().to("cpu", copy=True).numpy() if hasattr(value, "detach") else value


def _j_counts(metric):
    """{state: host counts} of a metric's current state."""
    return {n: _j_host(v.counts if hasattr(v, "counts") else v) for n, v in metric._current_state().items()}


def _j_bytes(metric):
    return sum((v.counts if hasattr(v, "counts") else v).numel() * (v.counts if hasattr(v, "counts") else v)
               .element_size() for v in metric._current_state().values())


def _j_steps(device, metric, batches, call, on_step=None):
    """Run ``call(metric, batch)`` over ``batches``: the values, ms per step (host clock, synchronized), the
    ``all_reduce`` / ``all_gather`` calls of each step, and the peak device bytes each step allocated above what was
    live before it."""
    import torch

    values, ms, calls, peaks = [], [], [], []
    for i, batch in enumerate(batches):
        if device.type == "cuda":
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        with _CountCollectives() as coll:
            t0 = time.perf_counter()
            values.append(call(metric, batch))
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        calls.append(dict(coll))
        if device.type == "cuda":
            peaks.append(torch.cuda.max_memory_allocated() - base)
        if on_step is not None:
            on_step(i)
    return values, ms, calls, peaks


def _j_summary(label, ms, calls, peaks, profile, state_bytes):
    """The line a part prints, and its timings: ms/step (median), device share, synchronizing calls of a profiled
    step, collective calls a step and the peak above the state."""
    med = statistics.median(ms)
    share = profile["device_ms"] / med if profile and profile["device_ms"] else None
    per_step = {k: calls[-1][k] for k in ("all_reduce", "all_gather")}
    peak = max(peaks) if peaks else None
    line = (f"    {label}: median {med:.3f} ms/step (first {ms[0]:.1f}); {per_step['all_reduce']} all_reduce /"
            f" {per_step['all_gather']} all_gather a step")
    if peak is not None:
        line += f"; peak {peak / 2**20:.1f} MiB above the {state_bytes / 1e6:.1f} MB state"
    if profile:
        device = (f"device {profile['device_ms']:.3f} ms ({100 * share:.1f}%), {profile['ops']:.0f} operations"
                  if profile["device_ms"] else "device time not measured (the profiler's trace held none)")
        line += (f"; profiled step: {device}, {profile['host_syncs']} synchronizing calls {profile['sync_sites'][:3]};"
                 f" top {[(r['name'][:40], round(r['us_per_call'], 1)) for r in profile['top'][:4]]}")
    print(line)
    return {"ms_per_step": med, "first_ms": ms[0], "device_share": share, "host_syncs": profile and profile["host_syncs"],
            "collectives_per_step": per_step, "peak_bytes": peak, "state_bytes": state_bytes,
            "device_ms": profile and profile["device_ms"]}


def _j_profile(step, calls=3):
    """One ``step()`` profiled: device milliseconds and operations from ``torch.profiler`` over ``calls`` calls
    (``None`` where its trace holds no device time: not measured), and the synchronizing CUDA calls of one more."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
    rows = sorted(({"name": e.key, "per_call": e.count / calls, "us_per_call": e.self_device_time_total / calls}
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0), key=lambda r: -r["us_per_call"])
    device_ms = sum(r["us_per_call"] for r in rows) / 1e3
    sites, _ = _host_sync_sites(step)
    return {"device_ms": device_ms if device_ms > 0 else None, "ops": sum(r["per_call"] for r in rows),
            "host_syncs": sum(sites.values()), "sync_sites": sites.most_common(8), "top": rows[:8]}


def run_path_j(device, a_batches):
    """Path J inside the caller's process group: J1-J7 on the card, timed and profiled, with what the checks need
    on the host."""
    import torch
    import torch.distributed as dist

    import metrics_tpu_torch as pt
    from metrics_tpu_torch.observability import counters

    data, unseen = _j_data()
    out = {"data": data, "unseen": unseen}
    to = (lambda x: torch.from_numpy(x).to(device))

    # J1: Keyed(AUROC(approx="sketch")) per tenant, dist_sync_on_step
    def j1_call(m, b):
        return m(b[0], b[1], slot=b[2])

    j1_in = [(to(b["scores"]), to(b["labels"]), to(b["slots"])) for b in data]
    keyed = pt.Keyed(pt.AUROC(approx="sketch", device=device), num_slots=J_SLOTS, dist_sync_on_step=True)
    early = {}
    counters.reset()
    values, ms, calls, peaks = _j_steps(device, keyed, j1_in, j1_call,
                                        on_step=lambda i: early.update(_j_counts(keyed)) if i == J_CPU_STEPS - 1
                                        else None)
    dropped = counters.snapshot()["slab_dropped_samples"]
    unkeyed = pt.AUROC(approx="sketch", device=device, dist_sync_on_step=True)
    with _CountCollectives() as unkeyed_calls:
        unkeyed(j1_in[0][0], j1_in[0][1])
    _sync(device)
    t0 = time.perf_counter()
    with _CountCollectives() as epoch_calls:
        epoch = keyed.compute()
        _sync(device)
    epoch_ms = (time.perf_counter() - t0) * 1e3
    probe = [int(k) for k in np.random.RandomState(53).choice(J_SLOTS, 6, replace=False)] + [int(unseen[0])]
    slot_reads = {k: _j_host(keyed.compute(slot=k)) for k in probe}
    fresh = pt.Keyed(pt.AUROC(approx="sketch", device=device), num_slots=J_SLOTS, dist_sync_on_step=True)
    profile = _j_profile(lambda: j1_call(fresh, j1_in[0])) if device.type == "cuda" else None
    del fresh
    out["J1"] = {"counts": _j_counts(keyed), "early": early, "last_value": _j_host(values[-1]),
                 "epoch": _j_host(epoch), "epoch_ms": epoch_ms, "epoch_calls": dict(epoch_calls),
                 "slot_reads": slot_reads, "dropped": dropped, "unkeyed_calls": dict(unkeyed_calls),
                 "calls": calls, "summary": _j_summary(f"J1 Keyed(AUROC sketch), K={J_SLOTS:,}", ms, calls, peaks, profile,
                                                        _j_bytes(keyed))}
    del keyed, values

    # J2: Keyed(Quantile(q=0.99)): per-tenant p99 request latency
    def j2_call(m, b):
        return m(b[0], slot=b[1])

    j2_in = [(to(b["latency"]), j1[2]) for b, j1 in zip(data, j1_in)]
    keyed = pt.Keyed(pt.Quantile(q=0.99, device=device), num_slots=J_SLOTS, dist_sync_on_step=True)
    early = {}
    values, ms, calls, peaks = _j_steps(device, keyed, j2_in, j2_call,
                                        on_step=lambda i: early.update(_j_counts(keyed)) if i == J_CPU_STEPS - 1
                                        else None)
    epoch = keyed.compute()
    tenants = [int(t) for t in np.random.RandomState(54).choice(
        np.setdiff1d(np.arange(J_SLOTS), unseen), J_QUANTILE_TENANTS, replace=False)]
    tenants[0] = int(np.bincount(np.concatenate([b["slots"][b["slots"] >= 0] for b in data])).argmax())  # the heaviest
    alone = {}
    for t in tenants:
        single = pt.Quantile(q=0.99, device=device)
        for b in data:
            single.update(to(b["latency"][b["slots"] == t]))
        alone[t] = (float(single.compute()), float(epoch[t]), int(sum((b["slots"] == t).sum() for b in data)))
    fresh = pt.Keyed(pt.Quantile(q=0.99, device=device), num_slots=J_SLOTS, dist_sync_on_step=True)
    profile = _j_profile(lambda: j2_call(fresh, j2_in[0])) if device.type == "cuda" else None
    del fresh
    out["J2"] = {"counts": _j_counts(keyed), "early": early, "epoch": _j_host(epoch), "alone": alone,
                 "summary": _j_summary(f"J2 Keyed(Quantile(0.99)), K={J_SLOTS:,}", ms, calls, peaks, profile,
                                       _j_bytes(keyed))}
    del keyed, values, j2_in

    # J3: Keyed(Accuracy()) per cohort over path A's batches
    cohorts = [np.random.RandomState(55 + i).randint(0, J3_COHORTS, A_BATCH).astype(np.int64)
               for i in range(len(a_batches))]

    def j3_call(m, b):
        return m(b[0], b[1], slot=b[2])

    j3_in = [(p, t, to(c)) for (p, t), c in zip(a_batches, cohorts)]
    keyed = pt.Keyed(pt.Accuracy(device=device), num_slots=J3_COHORTS, dist_sync_on_step=True)
    early = {}
    values, ms, calls, peaks = _j_steps(device, keyed, j3_in, j3_call,
                                        on_step=lambda i: early.update(_j_counts(keyed)) if i == J_CPU_STEPS - 1
                                        else None)
    fresh = pt.Keyed(pt.Accuracy(device=device), num_slots=J3_COHORTS, dist_sync_on_step=True)
    profile = _j_profile(lambda: j3_call(fresh, j3_in[0])) if device.type == "cuda" else None
    out["J3"] = {"counts": _j_counts(keyed), "early": early, "cohorts": cohorts, "epoch": _j_host(keyed.compute()),
                 "host": [(_j_host(p), _j_host(t)) for p, t in a_batches],
                 "summary": _j_summary(f"J3 Keyed(Accuracy), {J3_COHORTS:,} cohorts", ms, calls, peaks, profile,
                                       _j_bytes(keyed))}
    del keyed, fresh

    # J4: HeavyHitters(AUROC(approx="sketch")) over a 1,000,000-key space
    keys = _j_keys()

    def j4_call(m, b):
        return m.update(b[0], b[1], key=b[2])

    j4_in = [(j1[0], j1[1], k) for j1, k in zip(j1_in, keys)]
    hh = pt.HeavyHitters(pt.AUROC(approx="sketch", device=device), num_hot_slots=J4_HOT, tail=J4_TAIL)
    early, host_ms = {}, []
    real_resolve = type(hh._table).resolve

    def timed_resolve(table, batch_keys):
        t0 = time.perf_counter()
        try:
            return real_resolve(table, batch_keys)
        finally:
            host_ms.append((time.perf_counter() - t0) * 1e3)

    hh._table.resolve = timed_resolve.__get__(hh._table)
    values, ms, calls, peaks = _j_steps(device, hh, j4_in, j4_call,
                                        on_step=lambda i: early.update(_j_counts(hh)) if i == J_CPU_STEPS - 1
                                        else None)
    del hh._table.resolve
    with _CountCollectives() as epoch_calls:
        hot_values = hh.compute()
        _sync(device)
    stream_keys = np.concatenate(keys)
    seen = np.unique(stream_keys)
    tail_keys = [int(k) for k in np.random.RandomState(56).choice(seen[~np.isin(seen, list(hh._table.keys()))],
                                                                    J4_TAIL_CHECKS, replace=False)]
    records = hh.compute_heavy_hitters()
    fresh = pt.HeavyHitters(pt.AUROC(approx="sketch", device=device), num_hot_slots=J4_HOT, tail=J4_TAIL)
    profile = _j_profile(lambda: j4_call(fresh, j4_in[0])) if device.type == "cuda" else None
    del fresh
    out["J4"] = {"counts": _j_counts(hh), "early": early, "keys": keys, "table": hh._table.state(),
                 "records": [{k: _j_host(v) for k, v in r.items()} for r in records],
                 "tail_reads": {k: hh.tail_estimate(k) for k in tail_keys}, "bound": hh.tail_overcount_bound(),
                 "tail_mass": hh.tail_mass(), "hot_values": _j_host(hot_values), "epoch_calls": dict(epoch_calls),
                 "host_ms": statistics.median(host_ms),
                 "summary": _j_summary(f"J4 HeavyHitters(AUROC sketch), {J4_HOT} hot, {J4_TAIL} tail", ms, calls, peaks,
                                       profile, _j_bytes(hh))}
    del hh

    # J5: BootStrapper(AUROC(approx="sketch"), 100 copies)
    def j5_call(m, b):
        return m(b[0], b[1])

    boot = pt.BootStrapper(pt.AUROC(approx="sketch", device=device), num_bootstraps=J5_COPIES, seed=0, raw=True)
    values, ms, calls, peaks = _j_steps(device, boot, j1_in[:J5_STEPS], j5_call)
    final = boot.compute()
    fresh = pt.BootStrapper(pt.AUROC(approx="sketch", device=device), num_bootstraps=J5_COPIES, seed=0)
    profile = _j_profile(lambda: j5_call(fresh, j1_in[0])) if device.type == "cuda" else None
    del fresh
    out["J5"] = {"counts": _j_host(boot._stacked["hist"].counts), "mode": boot._mode, "final": _j_host(final),
                 "step_values": [_j_host(v) for v in values],
                 "summary": _j_summary(f"J5 BootStrapper(AUROC sketch), {J5_COPIES} copies", ms, calls, peaks, profile,
                                       _j_bytes(boot._template) * J5_COPIES)}
    del boot

    out["J6"] = _run_path_j6(device, a_batches)
    out["J7"] = _run_path_j7(device, j1_in)
    return out


def _run_path_j6(device, a_batches):
    """J6: Running, MetricTracker, ClasswiseWrapper, MinMaxMetric and MultioutputWrapper on the card, each against
    the arithmetic of its unwrapped parts on the card."""
    import torch

    import metrics_tpu_torch as pt

    res = {}
    pairs = _to(device, _e1_batches())

    def run(label, metric, make, batches, call):
        """Step ``metric`` over ``batches``; profile a step of a fresh ``make()``."""
        values, ms, calls, peaks = _j_steps(device, metric, batches, call)
        fresh = make()
        profile = _j_profile(lambda: call(fresh, batches[0]), calls=2) if device.type == "cuda" else None
        return values, _j_summary(label, ms, calls, peaks, profile, 0)

    # Running(MeanSquaredError(), window=5) over E1's pairs: the MSE of the last 5 steps
    make = (lambda: pt.Running(pt.MeanSquaredError(device=device), window=J6_WINDOW))
    values, summary = run("J6 Running(MSE, window=5)", make(), make, pairs, lambda m, b: m(*b))
    window = pt.MeanSquaredError(device=device)
    for p, t in pairs[-J6_WINDOW:]:
        window.update(p, t)
    res["running"] = {"got": float(values[-1]), "want": float(window.compute()), "summary": summary}

    # MetricTracker(Accuracy()) over 3 epochs of path A's batches
    def make_tracker():
        fresh = pt.MetricTracker(pt.Accuracy(device=device))
        fresh.increment()
        return fresh

    tracker = pt.MetricTracker(pt.Accuracy(device=device))
    epochs = np.array_split(np.arange(len(a_batches)), J6_EPOCHS)
    want, ms_all = [], []
    for epoch in epochs:
        tracker.increment()
        plain = pt.Accuracy(device=device)
        values, summary = run("J6 MetricTracker(Accuracy)", tracker, make_tracker, [a_batches[i] for i in epoch],
                              lambda m, b: m(*b))
        for i in epoch:
            plain.update(*a_batches[i])
        want.append(float(plain.compute()))
        ms_all.append(summary)
    best, step = tracker.best_metric(return_step=True)
    res["tracker"] = {"got": _j_host(tracker.compute_all()).tolist(), "want": want, "best": (float(best), step),
                      "summary": ms_all[-1]}

    # ClasswiseWrapper(Precision(num_classes=1000, average=None))
    make = (lambda: pt.ClasswiseWrapper(pt.Precision(num_classes=A_CLASSES, average=None, device=device)))
    classwise = make()
    plain = pt.Precision(num_classes=A_CLASSES, average=None, device=device)
    values, summary = run(f"J6 ClasswiseWrapper(Precision, {A_CLASSES:,} classes)", classwise, make, a_batches,
                          lambda m, b: m(*b))
    for b in a_batches:
        plain.update(*b)
    got = classwise.compute()
    want = _j_host(plain.compute())
    res["classwise"] = {"equal": len(got) == A_CLASSES and all(
        float(got[f"precision_{i}"]) == float(want[i]) or (np.isnan(float(got[f"precision_{i}"])) and np.isnan(want[i]))
        for i in range(A_CLASSES)), "summary": summary}

    # MinMaxMetric(Accuracy()): the extrema of the batch values
    make = (lambda: pt.MinMaxMetric(pt.Accuracy(device=device)))
    minmax = make()
    plain = pt.Accuracy(device=device)
    values, summary = run("J6 MinMaxMetric(Accuracy)", minmax, make, a_batches, lambda m, b: m(*b))
    batch_values = [float(plain(*b)) for b in a_batches]
    final = minmax.compute()
    res["minmax"] = {"got": {k: float(v) for k, v in final.items()},
                     "want": {"min": min(batch_values + [float(plain.compute())]),
                              "max": max(batch_values + [float(plain.compute())]), "raw": float(plain.compute())},
                     "summary": summary}

    # MultioutputWrapper(R2Score(), num_outputs=8) over 1,048,576 x 8 rows from E1's pairs
    rows = [(torch.cat([pairs[2 * i][0], pairs[2 * i + 1][0]]).view(J6_ROWS, J6_OUTPUTS),
             torch.cat([pairs[2 * i][1], pairs[2 * i + 1][1]]).view(J6_ROWS, J6_OUTPUTS)) for i in range(len(pairs) // 2)]
    make = (lambda: pt.MultioutputWrapper(pt.R2Score(device=device), num_outputs=J6_OUTPUTS))
    multi = make()
    values, summary = run("J6 MultioutputWrapper(R2, 8 outputs)", multi, make, rows, lambda m, b: m(*b))
    cols = [pt.R2Score(device=device) for _ in range(J6_OUTPUTS)]
    for p, t in rows:
        for j, col in enumerate(cols):
            col.update(p[:, j], t[:, j])
    res["multioutput"] = {"got": _j_host(multi.compute()).tolist(), "want": [float(c.compute()) for c in cols],
                          "summary": summary}
    return res


def _run_path_j7(device, j1_in):
    """J7: ``AUROC(approx="sketch").pure()``: init, an update a step, a sync over the group, compute; against the
    stateful metric fed the same steps."""
    import torch.distributed as dist

    import metrics_tpu_torch as pt

    metric = pt.AUROC(approx="sketch", device=device)
    pure = metric.pure()
    stateful = pt.AUROC(approx="sketch", device=device)

    state = pure.init()
    ms, calls = [], []
    for b in j1_in:
        with _CountCollectives() as coll:
            t0 = time.perf_counter()
            state = pure.update(state, b[0], b[1])
            synced = pure.sync(state, dist.group.WORLD)
            value = pure.compute(synced)
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        calls.append(dict(coll))
        stateful.update(b[0], b[1])
    profile = None
    if device.type == "cuda":
        profile = _j_profile(lambda: pure.compute(pure.sync(pure.update(pure.init(), j1_in[0][0], j1_in[0][1]),
                                                            dist.group.WORLD)))
    return {"value": float(value), "counts": _j_host(synced["hist"].counts), "stateful": float(stateful.compute()),
            "stateful_counts": _j_host(stateful.hist.counts), "own": int(metric.hist.counts.sum()),
            "summary": _j_summary("J7 AUROC(sketch).pure(): update, sync, compute", ms, calls, [], profile,
                                  _j_bytes(stateful))}


# ---- path J's oracles: numpy bincounts and float64 curve math, no code shared with the port
def _j_hist_oracle(batches, steps, num_slots):
    """(K, 2, B) int64 counts of (tenant, label row, bin) over the first ``steps`` batches, ids out of range left out."""
    total = np.zeros(num_slots * 2 * G_BINS, dtype=np.int64)
    for b in batches[:steps]:
        keep = (b["slots"] >= 0) & (b["slots"] < num_slots)
        flat = (b["slots"] * 2 + np.where(b["labels"] == 1, 0, 1)) * G_BINS + _g_linear_bins(b["scores"], G_BINS)
        total += np.bincount(flat[keep], minlength=total.size)
    return total.reshape(num_slots, 2, G_BINS)


def _j_quantile_oracle(batches, steps, num_slots):
    from metrics_tpu_torch.parallel.qsketch import QSKETCH_ALPHA, QSKETCH_MAX_VALUE, QSKETCH_MIN_VALUE

    grid = (QSKETCH_ALPHA, QSKETCH_MIN_VALUE, QSKETCH_MAX_VALUE)
    nb = 2 * max(int(np.ceil(np.log(grid[2] / grid[1]) / np.log((1 + grid[0]) / (1 - grid[0])))), 1) + 3
    total = np.zeros(num_slots * nb, dtype=np.int64)
    for b in batches[:steps]:
        keep = (b["slots"] >= 0) & (b["slots"] < num_slots)
        total += np.bincount((b["slots"] * nb + _g_q_buckets(b["latency"], *grid))[keep], minlength=total.size)
    return total.reshape(num_slots, nb)


def _j_cpu_keyed(make, names, batches, steps, num_slots):
    """The port's CPU run of a Keyed part over the first ``steps`` batches (``update``; no process group)."""
    import torch

    import metrics_tpu_torch as pt

    keyed = pt.Keyed(make("cpu"), num_slots=num_slots)
    for b in batches[:steps]:
        keyed.update(*(torch.from_numpy(b[n]) for n in names), slot=torch.from_numpy(b["slots"]))
    return _j_counts(keyed)


def _j_states_equal(label, got, want):
    for name, value in want.items():
        if not np.array_equal(got[name], value):
            raise AssertionError(f"{label}: state {name!r} differs ({np.count_nonzero(got[name] != value)} cells)")


def check_path_j(result):
    import metrics_tpu_torch as pt

    data, unseen = result["data"], result["unseen"]
    timings = {}
    print(f"[13] path J: the pure view, the keyed slab and the wrappers; {J_STEPS} steps of {J_N:,} samples over"
          f" {J_SLOTS:,} tenants (Zipf 1.1, {J_UNSEEN} never drawn, {J_OUT} ids out of range a step)")

    # J1
    run = result["J1"]
    timings["J1"] = run["summary"]
    oracle = _j_hist_oracle(data, J_STEPS, J_SLOTS)
    _j_states_equal("J1 slab counts against the numpy (tenant, label, bin) oracle", run["counts"],
                    {"hist": oracle, "keyed_rows": oracle.sum((1, 2))})
    cpu = _j_cpu_keyed(lambda d: pt.AUROC(approx="sketch", device=d), ("scores", "labels"), data, J_CPU_STEPS,
                       J_SLOTS)
    _j_states_equal(f"J1 card against the CPU run after {J_CPU_STEPS} steps", run["early"], cpu)
    _check(True, f"J1: slab counts equal the numpy oracle ({int(oracle.sum()):,} samples in {J_STEPS} steps) and the"
                 f" CPU run after {J_CPU_STEPS} steps, bit for bit")
    occupied = oracle.sum((1, 2)) > 0
    auroc = _g_curves(oracle)[0]
    err = _g_close("J1 per-tenant epoch AUROC against float64", run["epoch"][occupied], auroc[occupied], RTOL_J)
    empty = np.flatnonzero(~occupied)
    _check(np.isnan(run["epoch"][~occupied]).all() and set(unseen.tolist()) <= set(empty.tolist()),
           f"J1: {occupied.sum():,} tenants within rtol {RTOL_J} of float64 AUROC from the oracle counts (max rel"
           f" {err:.2e}); the {len(empty)} empty tenants (the {J_UNSEEN} never drawn among them) are NaN")
    last = _j_hist_oracle(data[-1:], 1, J_SLOTS)
    last_occ = last.sum((1, 2)) > 0
    _g_close("J1 last step's batch values", run["last_value"][last_occ], _g_curves(last)[0][last_occ], RTOL_J)
    for k, value in run["slot_reads"].items():
        if not np.array_equal(np.asarray(value), run["epoch"][k], equal_nan=True):
            raise AssertionError(f"J1 compute(slot={k}) = {value} but compute()[{k}] = {run['epoch'][k]}")
    _check(run["dropped"] == J_STEPS * J_OUT, f"J1: slab_dropped_samples = {run['dropped']} ({J_OUT} a step);"
                                               f" compute(slot=k) equals compute()[k] for {len(run['slot_reads'])}"
                                               f" tenants; the last step's batch values match float64 too")
    per_step = {tuple(sorted(c.items())) for c in run["calls"]}
    _check(per_step == {tuple(sorted(run["unkeyed_calls"].items()))} and run["unkeyed_calls"]["all_reduce"] == 1,
           f"J1: every step's collective calls equal the unkeyed AUROC(approx='sketch')'s ({run['unkeyed_calls']}),"
           f" at K = {J_SLOTS:,}; the epoch compute {run['epoch_calls']}, {run['epoch_ms']:.1f} ms")

    # J2
    run = result["J2"]
    timings["J2"] = run["summary"]
    oracle = _j_quantile_oracle(data, J_STEPS, J_SLOTS)
    _j_states_equal("J2 slab counts against the numpy float64 searchsorted oracle", run["counts"],
                    {"qsketch": oracle, "keyed_rows": oracle.sum(1)})
    cpu = _j_cpu_keyed(lambda d: pt.Quantile(q=0.99, device=d), ("latency",), data, J_CPU_STEPS, J_SLOTS)
    _j_states_equal(f"J2 card against the CPU run after {J_CPU_STEPS} steps", run["early"], cpu)
    for t, (alone, keyed_value, n) in run["alone"].items():
        if alone != keyed_value:
            raise AssertionError(f"J2 tenant {t} ({n} samples): keyed p99 {keyed_value} but alone {alone}")
    heaviest = max(run["alone"].values(), key=lambda a: a[2])
    _check(np.isnan(run["epoch"][oracle.sum(1) == 0]).all(),
           f"J2: counts equal the float64-exact bucket oracle and the CPU run; each of {len(run['alone'])} tenants'"
           f" p99 equals an unkeyed Quantile fed only its values (the heaviest: {heaviest[2]:,} samples, p99"
           f" {heaviest[0]:.6f} s); empty tenants NaN")

    # J3
    run = result["J3"]
    timings["J3"] = run["summary"]
    correct = np.zeros(J3_COHORTS, np.int64)
    total = np.zeros(J3_COHORTS, np.int64)
    for (p, t), c in zip(run["host"], run["cohorts"]):
        correct += np.bincount(c, weights=(np.argmax(p, 1) == t), minlength=J3_COHORTS).astype(np.int64)
        total += np.bincount(c, minlength=J3_COHORTS)
    _j_states_equal("J3 per-cohort correct / total against numpy", run["counts"],
                    {"correct": correct, "total": total, "keyed_rows": total})
    batches = [{"probs": p, "classes": t, "slots": c} for (p, t), c in zip(run["host"], run["cohorts"])]
    cpu = _j_cpu_keyed(lambda d: pt.Accuracy(device=d), ("probs", "classes"), batches, J_CPU_STEPS, J3_COHORTS)
    _j_states_equal(f"J3 card against the CPU run after {J_CPU_STEPS} steps", run["early"], cpu)
    _g_close("J3 per-cohort accuracy", run["epoch"], correct / total, RTOL_J_FLOAT)
    _check(True, f"J3: per-cohort correct / total equal numpy exactly over {correct.sum():,} correct of"
                 f" {total.sum():,}; the vmapped classification input format ran on the card; CPU run equal")

    # J4
    run = result["J4"]
    timings["J4"] = {**run["summary"], "host_resolve_ms": run["host_ms"]}
    keys = np.concatenate(run["keys"])
    scores = np.concatenate([b["scores"] for b in data])
    labels = np.concatenate([b["labels"] for b in data])
    flat = np.where(labels == 1, 0, 1) * G_BINS + _g_linear_bins(scores, G_BINS)
    stream = np.bincount(flat, minlength=2 * G_BINS).reshape(2, G_BINS)
    counts = run["counts"]
    _check(int(counts["hh_rows"].sum()) + run["tail_mass"] == len(keys)
           and np.array_equal(counts["hist"].sum(0) + counts["hist_tail"][0].sum(0), stream)
           and int(counts["hh_tail_rows"][0].sum()) == run["tail_mass"],
           f"J4: hot + tail totals equal the stream's bit for bit ({int(counts['hh_rows'].sum()):,} hot +"
           f" {run['tail_mass']:,} tail samples; the (2, {G_BINS}) histogram too)")
    table = run["table"]
    exact = 0
    for key, slot, residue in zip(table["keys"], table["slots"], table["residue"]):
        if residue:
            continue
        mine = keys == key
        want = np.bincount(flat[mine], minlength=2 * G_BINS).reshape(2, G_BINS)
        if not np.array_equal(counts["hist"][slot], want) or counts["hh_rows"][slot] != mine.sum():
            raise AssertionError(f"J4 exact key {key} (slot {slot}): hot counts differ from the oracle")
        exact += 1
    over = []
    for key, read in run["tail_reads"].items():
        truth = int((keys == key).sum())
        if not truth <= read["count"] <= truth + run["bound"]:
            raise AssertionError(f"J4 tail key {key}: estimate {read['count']} outside [{truth}, {truth} +"
                                 f" {run['bound']:.1f}]")
        over.append(read["count"] - truth)
    _check(exact > 0, f"J4: {exact} of {len(table['keys'])} hot keys are exact and equal the oracle; {len(over)} tail"
                      f" reads within [truth, truth + {run['bound']:.1f}] (overcount max {max(over)}); promotions"
                      f" {int(table['promotions'])}, demotions {int(table['demotions'])}; host resolve"
                      f" {run['host_ms']:.1f} ms/step")
    cpu = pt.HeavyHitters(pt.AUROC(approx="sketch", device="cpu"), num_hot_slots=J4_HOT, tail=J4_TAIL)
    import torch

    for b, k in zip(data[:J_CPU_STEPS], run["keys"][:J_CPU_STEPS]):
        cpu.update(torch.from_numpy(b["scores"]), torch.from_numpy(b["labels"]), key=k.tolist())
    _j_states_equal(f"J4 card against the CPU run after {J_CPU_STEPS} steps", run["early"], _j_counts(cpu))
    _check(run["epoch_calls"]["all_reduce"] == 1, f"J4: card equals the CPU run bit for bit after {J_CPU_STEPS} steps"
                                                  f" (the same host table); the synced compute makes"
                                                  f" {run['epoch_calls']}")

    # J5
    run = result["J5"]
    timings["J5"] = run["summary"]
    rs = np.random.RandomState(0)
    oracle = np.zeros(J5_COPIES * 2 * G_BINS, np.int64)
    for b in data[:J5_STEPS]:
        idx = rs.randint(0, J_N, (J5_COPIES, J_N))
        flat = np.where(b["labels"] == 1, 0, 1) * G_BINS + _g_linear_bins(b["scores"], G_BINS)
        oracle += np.bincount((np.arange(J5_COPIES)[:, None] * 2 * G_BINS + flat[idx]).reshape(-1),
                              minlength=oracle.size)
    oracle = oracle.reshape(J5_COPIES, 2, G_BINS)
    if not np.array_equal(run["counts"], oracle):
        raise AssertionError("J5: per-copy counts differ from the numpy oracle on the same RandomState draws")
    copies = _g_curves(oracle)[0]
    _g_close("J5 raw copies", run["final"]["raw"], copies, RTOL_J)
    _g_close("J5 mean", run["final"]["mean"], copies.mean(), RTOL_J)
    _g_close("J5 std", run["final"]["std"], copies.std(ddof=1), RTOL_J)
    _check(run["mode"] == "stacked", f"J5: {J5_COPIES} copies' counts equal a numpy oracle on the same RandomState"
                                     f" draws bit for bit; mean {run['final']['mean']:.6f} / std"
                                     f" {run['final']['std']:.6f} within rtol {RTOL_J} of float64 (stacked mode)")

    # J6
    run = result["J6"]
    timings["J6"] = {k: v["summary"] for k, v in run.items()}
    _g_close("J6 Running", run["running"]["got"], run["running"]["want"], RTOL_J_FLOAT)
    best = int(np.argmax(run["tracker"]["want"]))
    _check(run["tracker"]["got"] == run["tracker"]["want"] and run["tracker"]["best"][1] == best,
           f"J6: Running(MSE, 5) equals the MSE of the last {J6_WINDOW} steps; MetricTracker's {J6_EPOCHS} epochs"
           f" equal plain Accuracy per epoch exactly, best step {best}")
    mm = run["minmax"]
    _check(run["classwise"]["equal"] and mm["got"] == mm["want"],
           f"J6: ClasswiseWrapper's {A_CLASSES} values equal Precision(average=None) exactly; MinMaxMetric {mm['got']}"
           f" equals the extrema of the plain batch values")
    _g_close("J6 MultioutputWrapper", run["multioutput"]["got"], run["multioutput"]["want"], RTOL_J_FLOAT)
    _check(True, f"J6: MultioutputWrapper(R2, {J6_OUTPUTS}) over {J6_ROWS:,} rows equals 8 R2Score columns"
                 f" (rtol {RTOL_J_FLOAT})")

    # J7
    run = result["J7"]
    timings["J7"] = run["summary"]
    _check(np.array_equal(run["counts"], run["stateful_counts"]) and run["value"] == run["stateful"]
           and run["own"] == 0,
           f"J7: pure init / update / sync / compute equals the stateful metric bit for bit ({run['value']:.6f});"
           f" the metric's own state untouched")

    for part in ("J1", "J2"):
        peak = timings[part]["peak_bytes"]
        if peak is not None:
            _check(peak <= J_PEAK_BUDGET, f"{part}: peak {peak / 2**20:.1f} MiB a step above what was live (the"
                                          f" state and the batches), within {J_PEAK_BUDGET >> 20} MiB")
    return timings


# ---- path K: the windowed plane and the rest of MetricCollection
K_N = 65_536  # events a step of W1-W3: the keyed scenario's batch
W1_STEPS, W1_WINDOW_S, W1_WINDOWS, W1_LATENESS, W1_ADVANCE = 24, 60.0, 4, 180.0, 20.0
W2_STEPS, W2_WINDOW_S, W2_SLIDE_S, W2_WINDOWS, W2_LATENESS, W2_ADVANCE = 20, 6.0, 2.0, 6, 4.0, 1.0
W3_STEPS, W3_HALF_LIFE, W3_ADVANCE, W3_OUT_OF_ORDER = 20, 30.0, 5.0, 0.02
W4_WINDOW_S, W4_WINDOWS, W4_LATENESS, W4_ADVANCE, W4_OUT = 60.0, 4, 120.0, 20.0, 16
W5_DEADLINE, W5_LAG, W5_WINDOWS, W5_N = 0.5, 90.0, 8, 8_192
K_CPU_STEPS = 2  # steps of W1-W4 the CPU run repeats; the numpy oracles hold every step
RTOL_K = 1e-6  # float32 values of equal counts against the card's unwindowed metric: the same math
# W3 against float64: a float32 pairwise sum of 65,536 weighted squared errors a step, rescaled and added 20 times,
# each term a float32 product of a float32 weight; the JAX test's 1e-6 holds 3 samples
RTOL_W3 = 1e-5


def _k_events(seed, steps, advance, late, drop, n=None):
    """Per step ``n`` (default ``K_N``) event times ``step * advance + U(0, advance)``, a share ``late[0]`` of them moved back by
    ``U(*late[1])`` seconds and a share ``drop[0]`` by ``U(*drop[1])``, with 30% positive labels and scores
    sigmoid(N(0, 1) + 1.5 label)."""
    rng = np.random.RandomState(seed)
    n = K_N if n is None else n
    out = []
    for step in range(steps):
        t = step * advance + rng.uniform(0, advance, n)
        u = rng.random_sample(n)
        back = np.zeros(n)
        back[u < late[0]] = rng.uniform(*late[1], int((u < late[0]).sum()))
        far = (u >= late[0]) & (u < late[0] + drop[0])
        back[far] = rng.uniform(*drop[1], int(far.sum()))
        labels = (rng.random_sample(n) < 0.3).astype(np.int64)
        scores = (1 / (1 + np.exp(-(rng.standard_normal(n) + 1.5 * labels)))).astype(np.float32)
        out.append({"t": t - back, "scores": scores, "labels": labels})
    return out


def _k_oracle_route(times, window_s, stride, num_windows, lateness):
    """The open rule written out, independent of the port's router: per step and covering row j (window
    ``floor(t / stride) - j``, j < window_s / stride), the window and whether the event lands there: iff
    ``window * stride + window_s + lateness > watermark`` and ``window > head - num_windows`` (its ring slot still
    holds it), with the watermark the running max of every event so far and the head ``floor(watermark /
    stride)``. Returns the per-step rows, the final head, the dropped events (no row took them), the late
    routings (taken where ``window * stride + window_s <= watermark``) and the oldest window that took one."""
    overlap = int(round(window_s / stride))
    wm, steps, dropped, late, origin = None, [], 0, 0, None
    for t in times:
        wm = float(t.max()) if wm is None else max(wm, float(t.max()))
        head = int(np.floor(wm / stride))
        newest = np.floor_divide(t, stride).astype(np.int64)
        rows, taken = [], np.zeros(t.size, bool)
        for j in range(overlap):
            window = newest - j
            ok = (window * stride + window_s + lateness > wm) & (window > head - num_windows)
            late += int((ok & (window * stride + window_s <= wm)).sum())
            if ok.any():
                origin = int(window[ok].min()) if origin is None else min(origin, int(window[ok].min()))
            rows.append((window, ok))
            taken |= ok
        dropped += int((~taken).sum())
        steps.append(rows)
    return steps, head, dropped, late, origin


def _k_per_window(steps, resident, fold):
    """{window: fold(step index, mask of the step's events the window took)} over the resident windows, every
    covering row of every step."""
    out = {}
    for w in resident:
        parts = []
        for i, rows in enumerate(steps):
            mask = np.zeros(rows[0][0].size, bool)
            for window, ok in rows:
                mask |= ok & (window == w)
            parts.append((i, mask))
        out[w] = fold(parts)
    return out


def run_path_k(device, a_batches):
    """Path K inside the caller's process group: W1-W6 on the card, timed and profiled, with what the checks need
    on the host."""
    import torch
    import torch.distributed as dist

    import metrics_tpu_torch as pt
    from metrics_tpu_torch.observability import counters

    out = {}
    to = (lambda x: torch.from_numpy(x).to(device))

    def early_hook(metric, store):
        return lambda i: store.update(_j_counts(metric)) if i == K_CPU_STEPS - 1 else None

    # W1: Windowed(AUROC(approx="sketch")), the tumbling ring, dist_sync_on_step
    data = _k_events(61, W1_STEPS, W1_ADVANCE, (0.05, (0.0, 150.0)), (0.005, (250.0, 400.0)))
    inputs = [(to(b["scores"]), to(b["labels"]), b["t"]) for b in data]

    def w1_make():
        return pt.Windowed(pt.AUROC(approx="sketch", device=device), window_s=W1_WINDOW_S, num_windows=W1_WINDOWS,
                           allowed_lateness_s=W1_LATENESS, dist_sync_on_step=True)

    def w1_call(m, b):
        return m(b[0], b[1], event_time=b[2])

    w1, early = w1_make(), {}
    counters.reset()
    values, ms, calls, peaks = _j_steps(device, w1, inputs, w1_call, on_step=early_hook(w1, early))
    slab_dropped = counters.snapshot()["slab_dropped_samples"]
    unwindowed = pt.AUROC(approx="sketch", device=device, dist_sync_on_step=True)
    with _CountCollectives() as unwindowed_calls:
        unwindowed(inputs[0][0], inputs[0][1])
    _sync(device)
    resident = w1.resident_windows()
    per_window = {w: float(w1.compute_window(w)) for w in resident}
    with _CountCollectives() as epoch_calls:
        epoch = _j_host(w1.compute())
    # every resident window against an unwindowed metric on the card fed exactly the events the oracle gives it
    steps, *_ = _k_oracle_route([b["t"] for b in data], W1_WINDOW_S, W1_WINDOW_S, W1_WINDOWS, W1_LATENESS)
    alone = {}
    for w, parts in _k_per_window(steps, resident, lambda parts: parts).items():
        fresh = pt.AUROC(approx="sketch", device=device)
        for i, mask in parts:
            if mask.any():
                fresh.update(to(data[i]["scores"][mask]), to(data[i]["labels"][mask]))
        alone[w] = float(fresh.compute())
    everything = pt.AUROC(approx="sketch", device=device)
    for w in resident:
        everything.hist.counts.add_(w1.hist.counts[w % W1_WINDOWS])  # the resident slabs merged by hand
    fresh = w1_make()
    profile = _j_profile(lambda: w1_call(fresh, inputs[0])) if device.type == "cuda" else None
    del fresh
    out["W1"] = {"data": data, "counts": _j_counts(w1), "early": early, "resident": resident,
                 "per_window": per_window, "alone": alone, "epoch": float(epoch),
                 "merged_by_hand": float(everything.compute()), "dropped": w1.dropped_samples, "late": w1.late_samples,
                 "slab_dropped": slab_dropped, "calls": calls, "unwindowed_calls": dict(unwindowed_calls),
                 "epoch_calls": dict(epoch_calls), "head": w1.head_window,
                 "summary": _j_summary(f"W1 Windowed(AUROC sketch), {W1_WINDOWS} x {W1_WINDOW_S:.0f} s tumbling",
                                       ms, calls, peaks, profile, _j_bytes(w1))}
    del w1, values, inputs

    # W2: Windowed(Accuracy()), sliding windows of 6 s every 2 s
    data = _k_events(62, W2_STEPS, W2_ADVANCE, (0.03, (0.0, 4.0)), (0.005, (10.0, 30.0)))
    inputs = [(to(b["scores"]), to(b["labels"]), b["t"]) for b in data]

    def w2_make():
        return pt.Windowed(pt.Accuracy(device=device), window_s=W2_WINDOW_S, slide_s=W2_SLIDE_S,
                           num_windows=W2_WINDOWS, allowed_lateness_s=W2_LATENESS, dist_sync_on_step=True)

    w2, early = w2_make(), {}
    counters.reset()
    values, ms, calls, peaks = _j_steps(device, w2, inputs, w1_call, on_step=early_hook(w2, early))
    slab_dropped = counters.snapshot()["slab_dropped_samples"]
    resident = w2.resident_windows()
    steps, *_ = _k_oracle_route([b["t"] for b in data], W2_WINDOW_S, W2_SLIDE_S, W2_WINDOWS, W2_LATENESS)
    alone = {}
    for w, parts in _k_per_window(steps, resident, lambda parts: parts).items():
        fresh = pt.Accuracy(device=device)
        for i, mask in parts:
            if mask.any():
                fresh.update(to(data[i]["scores"][mask]), to(data[i]["labels"][mask]))
        alone[w] = float(fresh.compute())
    fresh = w2_make()
    profile = _j_profile(lambda: w1_call(fresh, inputs[0])) if device.type == "cuda" else None
    del fresh
    out["W2"] = {"data": data, "counts": _j_counts(w2), "early": early, "resident": resident,
                 "per_window": {w: float(w2.compute_window(w)) for w in resident}, "alone": alone,
                 "epoch": float(w2.compute()), "head": w2.head_window, "dropped": w2.dropped_samples,
                 "late": w2.late_samples, "slab_dropped": slab_dropped,
                 "summary": _j_summary(f"W2 Windowed(Accuracy), {W2_WINDOW_S:.0f} s sliding every {W2_SLIDE_S:.0f} s",
                                       ms, calls, peaks, profile, _j_bytes(w2))}
    del w2, values, inputs

    # W3: Windowed(MeanSquaredError(), decay_half_life_s=30): an exponentially weighted MSE
    rng = np.random.RandomState(63)
    data = []
    for step, b in enumerate(_k_events(64, W3_STEPS, W3_ADVANCE, (W3_OUT_OF_ORDER, (0.0, 60.0)), (0.0, (0.0, 0.0)))):
        target = np.exp(rng.standard_normal(K_N)).astype(np.float32)
        preds = (target * np.exp(0.1 * rng.standard_normal(K_N))).astype(np.float32)
        data.append({"t": b["t"], "preds": preds, "target": target})
    inputs = [(to(b["preds"]), to(b["target"]), b["t"]) for b in data]

    def w3_make():
        return pt.Windowed(pt.MeanSquaredError(device=device), decay_half_life_s=W3_HALF_LIFE, dist_sync_on_step=True)

    w3, early = w3_make(), {}
    values, ms, calls, peaks = _j_steps(device, w3, inputs, w1_call, on_step=early_hook(w3, early))
    fresh = w3_make()
    profile = _j_profile(lambda: w1_call(fresh, inputs[0])) if device.type == "cuda" else None
    del fresh
    out["W3"] = {"data": data, "counts": _j_counts(w3), "early": early, "value": float(w3.compute()),
                 "watermark": w3.watermark, "dropped": w3.dropped_samples,
                 "summary": _j_summary(f"W3 Windowed(MSE), decay half-life {W3_HALF_LIFE:.0f} s", ms, calls, peaks,
                                       profile, _j_bytes(w3))}
    del w3, values, inputs

    # W4: Windowed(Keyed(Accuracy(), 1,000)): per-cohort windows over path A's batches
    rng = np.random.RandomState(65)
    perm = rng.permutation(J3_COHORTS)
    cdf = np.cumsum(np.arange(1, J3_COHORTS + 1, dtype=np.float64) ** -1.1)
    cdf /= cdf[-1]
    host = [(_j_host(p), _j_host(t)) for p, t in a_batches]
    data = []
    for step in range(len(a_batches)):
        cohorts = perm[np.minimum(np.searchsorted(cdf, rng.random_sample(A_BATCH), side="right"), J3_COHORTS - 1)]
        bad = rng.choice(A_BATCH, W4_OUT, replace=False)
        cohorts[bad[: W4_OUT // 2]], cohorts[bad[W4_OUT // 2:]] = -1, J3_COHORTS
        t = step * W4_ADVANCE + rng.uniform(0, W4_ADVANCE, A_BATCH)
        u = rng.random_sample(A_BATCH)
        t[u < 0.05] -= rng.uniform(0.0, 100.0, int((u < 0.05).sum()))
        far = (u >= 0.05) & (u < 0.055)
        t[far] -= rng.uniform(250.0, 400.0, int(far.sum()))
        data.append({"t": t, "cohorts": cohorts.astype(np.int64), "classes": host[step][0].argmax(1),
                     "target": host[step][1], "probs": host[step][0] if step < K_CPU_STEPS else None})
    inputs = [(p, t, to(d["cohorts"]), d["t"]) for (p, t), d in zip(a_batches, data)]

    def w4_make():
        return pt.Windowed(pt.Keyed(pt.Accuracy(device=device), J3_COHORTS), window_s=W4_WINDOW_S,
                           num_windows=W4_WINDOWS, allowed_lateness_s=W4_LATENESS, dist_sync_on_step=True)

    def w4_call(m, b):
        return m(b[0], b[1], slot=b[2], event_time=b[3])

    w4, early = w4_make(), {}
    counters.reset()
    values, ms, calls, peaks = _j_steps(device, w4, inputs, w4_call, on_step=early_hook(w4, early))
    slab_dropped = counters.snapshot()["slab_dropped_samples"]
    resident = w4.resident_windows()
    steps, *_ = _k_oracle_route([d["t"] for d in data], W4_WINDOW_S, W4_WINDOW_S, W4_WINDOWS, W4_LATENESS)
    alone = {}
    for w, parts in _k_per_window(steps, resident, lambda parts: parts).items():
        fresh = pt.Keyed(pt.Accuracy(device=device), J3_COHORTS)
        for i, mask in parts:
            if mask.any():
                keep = to(np.flatnonzero(mask))
                fresh.update(a_batches[i][0].index_select(0, keep), a_batches[i][1].index_select(0, keep),
                             slot=to(data[i]["cohorts"][mask]))
        alone[w] = _j_host(fresh.compute())
    fresh = w4_make()
    profile = _j_profile(lambda: w4_call(fresh, inputs[0])) if device.type == "cuda" else None
    del fresh
    out["W4"] = {"data": data, "counts": _j_counts(w4), "early": early, "resident": resident,
                 "per_window": {w: _j_host(w4.compute_window(w)) for w in resident}, "alone": alone,
                 "head": w4.head_window, "dropped": w4.dropped_samples, "late": w4.late_samples,
                 "slab_dropped": slab_dropped,
                 "summary": _j_summary(f"W4 Windowed(Keyed(Accuracy), {J3_COHORTS:,} cohorts)", ms, calls, peaks,
                                       profile, _j_bytes(w4))}
    del w4, values

    out["W5"] = _run_path_w5(device)
    out["W6"] = _run_path_w6(device, a_batches)
    return out


def _run_path_w5(device):
    """W5: two in-process participants of one ``WatermarkAgreement(deadline_s=0.5)``, one 90 s behind, each a
    ``Windowed(AUROC(approx="sketch"))`` ring of 8 windows (a ring sized for the skew, so the windows the agreed
    clock holds open are still resident) fed batches of 8,192 events."""
    import torch

    import metrics_tpu_torch as pt
    from metrics_tpu_torch.observability import counters

    data = _k_events(66, 3, W1_ADVANCE, (0.0, (0.0, 0.0)), (0.0, (0.0, 0.0)), n=W5_N)
    to = (lambda x: torch.from_numpy(x).to(device))
    agreement = pt.WatermarkAgreement(deadline_s=W5_DEADLINE, label="path K W5")

    def ring(**kw):
        return pt.Windowed(pt.AUROC(approx="sketch", device=device), window_s=W1_WINDOW_S, num_windows=W5_WINDOWS,
                           allowed_lateness_s=W1_LATENESS, **kw)

    fast, slow, lone = ring(agreement=agreement, rank="fast"), ring(agreement=agreement, rank="slow"), ring()
    base = 300.0  # the fast rank's clock: window 5 of 60 s
    b = data[0]
    fast.update(to(b["scores"]), to(b["labels"]), event_time=base + b["t"])
    lone.update(to(b["scores"]), to(b["labels"]), event_time=base + b["t"])
    slow.update(to(b["scores"]), to(b["labels"]), event_time=base - W5_LAG + b["t"])
    res = {"fast_wm": fast.watermark, "slow_wm": slow.watermark, "agreed": agreement.agreed()}
    # events 200-220 s behind the fast rank's clock: closed by its local clock (window end + 180 s of lateness
    # lies behind it), open by the agreed one, and their ring slots still hold their windows
    b = data[1]
    late_t = fast.watermark - 220.0 + b["t"] % 20.0
    before = (fast.dropped_samples, fast.late_samples, int(fast.windowed_rows.sum()))
    fast.update(to(b["scores"]), to(b["labels"]), event_time=late_t)
    lone.update(to(b["scores"]), to(b["labels"]), event_time=late_t)
    res["held_open"] = {"fast_dropped": fast.dropped_samples - before[0], "fast_late": fast.late_samples - before[1],
                        "fast_rows": int(fast.windowed_rows.sum()) - before[2], "lone_dropped": lone.dropped_samples,
                        "n": int(late_t.size), "agreed": agreement.agreed(), "close": fast.close_watermark,
                        "local_closed": int((np.floor_divide(late_t, W1_WINDOW_S) * W1_WINDOW_S + W1_WINDOW_S
                                             + W1_LATENESS <= fast.watermark).sum()),
                        "agreed_late": int((np.floor_divide(late_t, W1_WINDOW_S) * W1_WINDOW_S + W1_WINDOW_S
                                            <= agreement.agreed()).sum())}
    # the slow rank stops reporting: past the deadline it is excluded, and it rejoins on its next advance
    stragglers = counters.snapshot()["wm_stragglers"]
    time.sleep(W5_DEADLINE + 0.2)
    b = data[2]
    fast.update(to(b["scores"]), to(b["labels"]), event_time=fast.watermark + 1.0 + b["t"] % 5.0)
    res["excluded"] = {"agreed": agreement.agreed(), "fast_wm": fast.watermark, "excluded": agreement.excluded(),
                       "degraded": fast.agreement_degraded, "stragglers": counters.snapshot()["wm_stragglers"]
                       - stragglers}
    slow.update(to(b["scores"]), to(b["labels"]), event_time=slow.watermark + 10.0 + b["t"] % 5.0)
    res["rejoined"] = {"agreed": agreement.agreed(), "slow_wm": slow.watermark, "excluded": agreement.excluded(),
                       "degraded": fast.agreement_degraded}
    return res


def _run_path_w6(device, a_batches):
    """W6: the main collection's pure view over path A's batches (init, update, sync over the group, compute a
    step), ``forward_batched`` over the stacked batches and ``clone(prefix="b_")``."""
    import torch
    import torch.distributed as dist

    col = _main_collection(device, dist_sync_on_step=True)
    pure = col.pure()
    state = pure.init()
    entries = sorted(state)
    ms, calls, values = [], [], []
    for p, t in a_batches:
        with _CountCollectives() as coll:
            t0 = time.perf_counter()
            state = pure.update(state, p, t)
            synced = pure.sync(state, dist.group.WORLD)
            values.append({k: float(v) for k, v in pure.compute(synced).items()})
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        calls.append(dict(coll))
    buckets = {((v.counts if hasattr(v, "counts") else v).dtype, col[k]._reductions[n])
               for k, s in state.items() for n, v in s.items()}
    stepper = _main_collection(device, dist_sync_on_step=True)
    step_values = []
    with _CountCollectives() as step_calls:
        step_values.append({k: float(v) for k, v in stepper(*a_batches[0]).items()})
    for p, t in a_batches[1:]:
        step_values.append({k: float(v) for k, v in stepper(p, t).items()})
    epoch_loop = {k: float(v) for k, v in stepper.compute().items()}
    profile = None
    if device.type == "cuda":
        profile = _j_profile(lambda: pure.compute(pure.sync(pure.update(pure.init(), *a_batches[0]),
                                                            dist.group.WORLD)))
    preds = torch.stack([p for p, _ in a_batches])
    target = torch.stack([t for _, t in a_batches])
    batched = _main_collection(device, dist_sync_on_step=True)
    _sync(device)
    t0 = time.perf_counter()
    stacked = batched.forward_batched(preds, target)
    _sync(device)
    batched_ms = (time.perf_counter() - t0) * 1e3
    stacked_bytes = preds.numel() * preds.element_size() + target.numel() * target.element_size()
    del preds, target
    clone = batched.clone(prefix="b_")
    return {"entries": entries, "values": values, "calls": calls, "buckets": len(buckets),
            "step_calls": dict(step_calls), "step_values": step_values, "epoch_loop": epoch_loop,
            "pure_state_own": int(col["F1"].tp.sum()),
            "batched": {k: _j_host(v).tolist() for k, v in stacked.items()}, "batched_ms": batched_ms,
            "stacked_bytes": stacked_bytes, "batched_epoch": {k: float(v) for k, v in batched.compute().items()},
            "clone_epoch": {k: float(v) for k, v in clone.compute().items()},
            "summary": _j_summary("W6 MetricCollection.pure(): update, sync, compute", ms, calls, [], profile, 0)}


def _k_cpu_run(make, call_inputs, steps):
    """The port's CPU run of a part over its first ``steps`` batches (``update``; no process group)."""
    metric = make("cpu")
    for args, kw in call_inputs[:steps]:
        metric.update(*args, **kw)
    return _j_counts(metric)


def _k_states_equal(label, got, want, rtol=None):
    for name, value in want.items():
        if rtol is not None and np.issubdtype(np.asarray(value).dtype, np.floating):
            np.testing.assert_allclose(got[name], value, rtol=rtol, atol=0, err_msg=f"{label}: {name}")
        elif not np.array_equal(got[name], value):
            raise AssertionError(f"{label}: state {name!r} differs ({np.count_nonzero(got[name] != value)} cells)")


def check_path_k(result):
    import torch

    import metrics_tpu_torch as pt

    timings = {}
    print(f"[14] path K: the windowed plane (W1-W5) and the rest of MetricCollection (W6); {K_N:,} events a step")

    # W1: counts per window against the oracle router and a numpy bincount
    run = result["W1"]
    timings["W1"] = run["summary"]
    data = run["data"]
    steps, head, dropped, late, origin = _k_oracle_route([b["t"] for b in data], W1_WINDOW_S, W1_WINDOW_S,
                                                         W1_WINDOWS, W1_LATENESS)
    resident = tuple(range(max(origin, head - W1_WINDOWS + 1), head + 1))

    def hist_fold(parts):
        total = np.zeros(2 * G_BINS, np.int64)
        for i, mask in parts:
            b = data[i]
            flat = np.where(b["labels"] == 1, 0, 1) * G_BINS + _g_linear_bins(b["scores"], G_BINS)
            total += np.bincount(flat[mask], minlength=2 * G_BINS)
        return total.reshape(2, G_BINS)

    oracle = _k_per_window(steps, resident, hist_fold)
    _check(run["resident"] == resident and run["head"] == head and len(resident) == W1_WINDOWS,
           f"W1: resident windows {resident} (head {head}) equal the oracle router's")
    for w in resident:
        slot = w % W1_WINDOWS
        if not (np.array_equal(run["counts"]["hist"][slot], oracle[w])
                and run["counts"]["windowed_rows"][slot] == oracle[w].sum()):
            raise AssertionError(f"W1 window {w} (slot {slot}): counts differ from the oracle")
    _check(run["dropped"] == dropped and run["late"] == late and run["slab_dropped"] == dropped,
           f"W1: every window's (label, bin) counts equal the oracle's bit for bit; dropped {dropped:,}"
           f" (slab_dropped_samples {run['slab_dropped']:,}), late routings {late:,}")
    cpu = _k_cpu_run(lambda d: pt.Windowed(pt.AUROC(approx="sketch", device=d), window_s=W1_WINDOW_S,
                                           num_windows=W1_WINDOWS, allowed_lateness_s=W1_LATENESS),
                     [((torch.from_numpy(b["scores"]), torch.from_numpy(b["labels"])), {"event_time": b["t"]})
                      for b in data], K_CPU_STEPS)
    _k_states_equal(f"W1 card against the CPU run after {K_CPU_STEPS} steps", run["early"], cpu)
    for w in resident:
        if run["per_window"][w] != run["alone"][w]:
            raise AssertionError(f"W1 compute_window({w}) = {run['per_window'][w]} but the window's events alone"
                                 f" give {run['alone'][w]}")
    per_step = {tuple(sorted(c.items())) for c in run["calls"]}
    _check(per_step == {tuple(sorted(run["unwindowed_calls"].items()))} and run["unwindowed_calls"]["all_reduce"] == 1
           and run["epoch"] == run["merged_by_hand"],
           f"W1: compute_window(w) of each resident window equals AUROC(approx='sketch') fed that window's events on"
           f" the card; compute() {run['epoch']:.6f} equals the resident slabs merged; card equal to the CPU run;"
           f" every step's collective calls equal the unwindowed metric's ({run['unwindowed_calls']})")

    # W2: sliding windows, every covering row
    run = result["W2"]
    timings["W2"] = run["summary"]
    data = run["data"]
    steps, head, dropped, late, origin = _k_oracle_route([b["t"] for b in data], W2_WINDOW_S, W2_SLIDE_S,
                                                         W2_WINDOWS, W2_LATENESS)
    resident = tuple(range(max(origin, head - W2_WINDOWS + 1), head + 1))

    def acc_fold(parts):
        correct = total = 0
        for i, mask in parts:
            b = data[i]
            correct += int(((b["scores"] >= np.float32(0.5)).astype(np.int64) == b["labels"])[mask].sum())
            total += int(mask.sum())
        return correct, total

    oracle = _k_per_window(steps, resident, acc_fold)
    _check(run["resident"] == resident and run["head"] == head, f"W2: resident windows {resident} equal the oracle's")
    for w in resident:
        slot = w % W2_WINDOWS
        got = (int(run["counts"]["correct"][slot]), int(run["counts"]["total"][slot]),
               int(run["counts"]["windowed_rows"][slot]))
        if got != (*oracle[w], oracle[w][1]):
            raise AssertionError(f"W2 window {w}: correct / total / rows {got}, oracle {oracle[w]}")
        if run["per_window"][w] != run["alone"][w]:
            raise AssertionError(f"W2 compute_window({w}) {run['per_window'][w]} != alone {run['alone'][w]}")
    rows = sum(int(ok.sum()) for s in steps for _, ok in s)
    cpu = _k_cpu_run(lambda d: pt.Windowed(pt.Accuracy(device=d), window_s=W2_WINDOW_S, slide_s=W2_SLIDE_S,
                                           num_windows=W2_WINDOWS, allowed_lateness_s=W2_LATENESS),
                     [((torch.from_numpy(b["scores"]), torch.from_numpy(b["labels"])), {"event_time": b["t"]})
                      for b in data], K_CPU_STEPS)
    _k_states_equal(f"W2 card against the CPU run after {K_CPU_STEPS} steps", run["early"], cpu)
    _check(run["dropped"] == dropped and run["late"] == late and run["slab_dropped"] == dropped
           and run["epoch"] == run["per_window"][head - 2],
           f"W2: every window's correct / total equal the oracle's over its {W2_WINDOWS} ring rows ({rows:,} routings"
           f" of {W2_STEPS * K_N:,} events, {rows / (W2_STEPS * K_N):.3f} a event); dropped {dropped:,}, late"
           f" {late:,}; compute() is the trailing full-span window {head - 2}; CPU run equal")

    # W3: the decayed MSE against float64
    run = result["W3"]
    timings["W3"] = run["summary"]
    data = run["data"]
    t = np.concatenate([b["t"] for b in data])
    wm = float(t.max())
    err = np.concatenate([(b["preds"].astype(np.float64) - b["target"]) ** 2 for b in data])
    weight = 0.5 ** ((wm - t) / W3_HALF_LIFE)
    want = float((weight * err).sum() / weight.sum())
    rel = abs(run["value"] - want) / abs(want)
    cpu = _k_cpu_run(lambda d: pt.Windowed(pt.MeanSquaredError(device=d), decay_half_life_s=W3_HALF_LIFE),
                     [((torch.from_numpy(b["preds"]), torch.from_numpy(b["target"])), {"event_time": b["t"]})
                      for b in data], K_CPU_STEPS)
    _k_states_equal(f"W3 card against the CPU run after {K_CPU_STEPS} steps", run["early"], cpu, rtol=RTOL_K)
    _check(rel <= RTOL_W3 and run["watermark"] == wm and run["dropped"] == 0,
           f"W3: decayed MSE {run['value']:.7f} within rtol {RTOL_W3} of the float64 closed form {want:.7f} (rel"
           f" {rel:.2e}) over {t.size:,} events, {W3_OUT_OF_ORDER:.0%} out of order; CPU run within rtol {RTOL_K}")

    # W4: per-window, per-cohort counts
    run = result["W4"]
    timings["W4"] = run["summary"]
    data = run["data"]
    steps, head, dropped, late, origin = _k_oracle_route([d["t"] for d in data], W4_WINDOW_S, W4_WINDOW_S,
                                                         W4_WINDOWS, W4_LATENESS)
    resident = tuple(range(max(origin, head - W4_WINDOWS + 1), head + 1))

    def cohort_fold(parts):
        correct, total, rows = (np.zeros(J3_COHORTS, np.int64) for _ in range(3))
        taken = 0
        for i, mask in parts:
            d = data[i]
            inside = mask & (d["cohorts"] >= 0) & (d["cohorts"] < J3_COHORTS)
            c = d["cohorts"][inside]
            correct += np.bincount(c, weights=(d["classes"] == d["target"])[inside], minlength=J3_COHORTS).astype(
                np.int64)
            total += np.bincount(c, minlength=J3_COHORTS)
            taken += int(mask.sum())
        return correct, total, taken

    oracle = _k_per_window(steps, resident, cohort_fold)
    for w in resident:
        slot = w % W4_WINDOWS
        correct, total, taken = oracle[w]
        c = run["counts"]
        if not (np.array_equal(c["correct"][slot], correct) and np.array_equal(c["total"][slot], total)
                and np.array_equal(c["keyed_rows"][slot], total) and c["windowed_rows"][slot] == taken):
            raise AssertionError(f"W4 window {w}: per-cohort counts differ from the oracle")
        if not np.array_equal(run["per_window"][w], run["alone"][w], equal_nan=True):
            raise AssertionError(f"W4 compute_window({w}) differs from Keyed(Accuracy) fed the window's events")
    misrouted = sum(int(((d["cohorts"] < 0) | (d["cohorts"] >= J3_COHORTS)).sum()) for d in data)
    cpu = _k_cpu_run(lambda d: pt.Windowed(pt.Keyed(pt.Accuracy(device=d), J3_COHORTS), window_s=W4_WINDOW_S,
                                           num_windows=W4_WINDOWS, allowed_lateness_s=W4_LATENESS),
                     [((torch.from_numpy(d["probs"]), torch.from_numpy(d["target"])),
                       {"slot": torch.from_numpy(d["cohorts"]), "event_time": d["t"]}) for d in data[:K_CPU_STEPS]],
                     K_CPU_STEPS)
    _k_states_equal(f"W4 card against the CPU run after {K_CPU_STEPS} steps", run["early"], cpu)
    _check(run["resident"] == resident and run["dropped"] == dropped and run["late"] == late
           and run["slab_dropped"] == dropped + misrouted,
           f"W4: (window, cohort) correct / total equal numpy bit for bit over {len(resident)} windows x"
           f" {J3_COHORTS:,} cohorts; compute_window(w) equals Keyed(Accuracy) fed the window's events; dropped"
           f" {dropped:,} too late + {misrouted} cohort ids out of range = slab_dropped_samples"
           f" {run['slab_dropped']:,}; CPU run equal")

    # W5: the agreement
    run = result["W5"]
    held = run["held_open"]
    _check(run["agreed"] == run["slow_wm"] and held["fast_dropped"] == 0 and held["fast_rows"] == held["n"]
           and held["local_closed"] == held["n"] and held["lone_dropped"] == held["n"]
           and held["fast_late"] == held["agreed_late"],
           f"W5: with the slow rank {W5_LAG:.0f} s behind, the agreed clock {run['agreed']:.1f} holds windows open:"
           f" {held['n']:,} events the fast rank's own clock had closed land (a lone ring drops all of them); late"
           f" verdicts follow the agreed clock ({held['fast_late']:,} late)")
    ex, back = run["excluded"], run["rejoined"]
    _check(ex["excluded"] == ("slow",) and ex["degraded"] and ex["stragglers"] == 1 and ex["agreed"] == ex["fast_wm"]
           and back["excluded"] == () and not back["degraded"] and back["agreed"] == ex["agreed"],
           f"W5: past the {W5_DEADLINE} s deadline the silent rank is excluded (wm_stragglers +1, degraded, agreed"
           f" {ex['agreed']:.1f} = the fast rank's clock) and rejoins on its next advance (its clock"
           f" {back['slow_wm']:.1f}; the agreed high-water stays {back['agreed']:.1f})")

    # W6: the collection's pure view, forward_batched and clone
    run = result["W6"]
    timings["W6"] = {**run["summary"], "forward_batched_ms": run["batched_ms"]}
    per_step = {c["all_reduce"] for c in run["calls"]}
    worst = 0.0
    loop_epoch = run["epoch_loop"]
    for k, v in run["values"][-1].items():
        worst = max(worst, abs(v - loop_epoch[k]))
        if not np.isclose(v, loop_epoch[k], rtol=RTOL_CLASS, atol=0):
            raise AssertionError(f"W6 pure compute {k} = {v} but the stateful collection gives {loop_epoch[k]}")
    _check(run["entries"] == ["Accuracy", "F1"] and per_step == {run["buckets"]} and run["buckets"] == 1
           and run["pure_state_own"] == 0 and run["step_calls"]["all_reduce"] == run["buckets"],
           f"W6: init_state has {len(run['entries'])} entries (the compute groups); update -> sync -> compute makes"
           f" {run['buckets']} all_reduce a step, one per (dtype, op) bucket of the whole collection, as the stateful"
           f" step's packed sync does ({run['step_calls']['all_reduce']}); its epoch equals the stateful"
           f" collection's (max abs diff {worst:.2e})")
    for k, series in run["batched"].items():
        want = [s[k] for s in run["step_values"]]
        if series != want:
            raise AssertionError(f"W6 forward_batched {k}: {series[:3]}... but the forward loop gives {want[:3]}...")
    _check(run["batched_epoch"] == run["epoch_loop"]
           and run["clone_epoch"] == {f"b_{k}": v for k, v in run["batched_epoch"].items()},
           f"W6: forward_batched over {A_STEPS} stacked batches ({run['stacked_bytes'] / 1e6:.0f} MB) gives path A's"
           f" per-step values and epoch bit for bit in {run['batched_ms']:.1f} ms; clone(prefix='b_') the same"
           f" values under new keys")
    return timings


# ---- path L: the guarded and deferred sync plane, at path A's size (4,096 x 1,000, 20 steps) and W1's (65,536
# events a step), in the script's one-rank NCCL group; L6 in two Gloo processes on the host
L_GUARD_STEPS = 8  # path A steps of each L2 fault run (the unfaulted run is the first 8 steps of L1's)
L3_POISON_STEP = 12  # the step before which L3 inserts its NaN-poisoned batch
L4_CHECKPOINT, L4_REPLAY_FROM = 10, 7
L6_DEADLINE, L6_LAG = 3.0, 90.0  # a deadline well above the processes' scheduling skew
# L3's float32 slab sums of two runs on the card: the same terms (up to ~200,000 a cell), added by atomics in another
# order, 4 sqrt(n) float32 ulps apart at most in practice; one batch more or less moves a cell by ~4%
RTOL_L3 = 1e-4


def _l_values(values):
    """Per-step values of a collection as host floats (a float32 .item() each: bit for bit)."""
    return [{k: v.item() for k, v in step.items()} for step in values]


def _l_lagged(device, a_batches, lag):
    """Path A's collection with ``sync_lag=lag`` on every member: per-step values, ms per step, collective calls a
    step, the epoch after the drain, and each member's chosen lag for ``"auto"``."""
    col = _main_collection(device, dist_sync_on_step=True)
    for m in col.values():
        m.sync_lag = lag
    values, ms, calls, _ = _j_steps(device, col, a_batches, lambda c, b: c(*b))
    with _CountCollectives() as epoch_calls:
        epoch = {k: v.item() for k, v in col.compute().items()}
    chosen = {k: m._lag_controller.lag for k, m in col.items() if m._lag_controller is not None}
    return {"values": _l_values(values), "ms": ms, "calls": calls, "epoch": epoch, "epoch_calls": dict(epoch_calls),
            "chosen": chosen}


def _l_host_syncs(device, fn):
    """The synchronizing CUDA calls ``fn()`` makes (torch's sync debug mode; 0 off the card), and its result."""
    if device.type != "cuda":
        return 0, fn()
    sites, out = _host_sync_sites(fn)
    return sum(sites.values()), out


def _l_guarded(device, batches, guard, specs, expect=None):
    """L2: path A's collection under ``guard`` and a chaos schedule: values, epoch, fault counters, ms per step,
    collective calls a step and the synchronizing calls of its last step; or, with ``expect`` (an exception type),
    the seconds until it raised that type."""
    from metrics_tpu_torch.observability import counters
    from metrics_tpu_torch.parallel import faults, sync

    counters.reset()
    col = _main_collection(device, dist_sync_on_step=True)
    old = sync.set_sync_guard(guard)
    try:
        with faults.chaos(*[faults.FaultSpec(**s) for s in specs]), _CountCollectives() as calls:
            t0 = time.perf_counter()
            if expect is not None:
                try:
                    col(*batches[0])
                except expect as err:
                    return {"raised": type(err).__name__, "s": time.perf_counter() - t0}
                return {"raised": None}
            values = [col(*b) for b in batches[:-1]]
            syncs, last = _l_host_syncs(device, lambda: col(*batches[-1]))
            values.append(last)
            _sync(device)
            wall = (time.perf_counter() - t0) * 1e3 / len(batches)
            per_step = {k: v / len(batches) for k, v in calls.items()}
            epoch = {k: v.item() for k, v in col.compute().items()}
    finally:
        sync.set_sync_guard(old)
    return {"values": _l_values(values), "epoch": epoch, "faults": counters.snapshot()["faults"], "ms": wall,
            "calls": per_step, "host_syncs": syncs}


def _l3_make(kind, device, policy=None):
    import metrics_tpu_torch as pt

    if kind == "W1":
        m = pt.Windowed(pt.MeanSquaredError(device=device), window_s=W1_WINDOW_S, num_windows=W1_WINDOWS,
                        allowed_lateness_s=W1_LATENESS)
    else:
        m = pt.Keyed(pt.MeanSquaredError(device=device), num_slots=J_SLOTS)
    m.check_finite = policy
    return m


def _l3_run(kind, device, inputs, policy=None, poison=None):
    """Feed ``inputs`` (``(preds, target, key)`` a step) through ``forward``; ``poison`` (a batch) goes in before
    step ``L3_POISON_STEP``. Returns the metric, the ms of each step, and the state just before and just after the
    poisoned batch (host copies)."""
    m = _l3_make(kind, device, policy)
    ms, around = [], {}
    for i, (p, t, key) in enumerate(inputs):
        if poison is not None and i == L3_POISON_STEP:
            around["before"] = _j_counts(m)
            _l3_call(kind, m, *poison)
            around["after"] = _j_counts(m)
        t0 = time.perf_counter()
        _l3_call(kind, m, p, t, key)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return m, ms, around


def _l3_call(kind, m, p, t, key):
    return m(p, t, event_time=key) if kind == "W1" else m(p, t, slot=key)


def _l3_inputs(device):
    """W1's events (score as the prediction of a float label) and J1's tenant ids over the same predictions, with
    each one's NaN-poisoned batch: the step before the poisoned one's events (its times: no window opens) with every
    seventh prediction NaN."""
    import torch

    to = (lambda x: torch.from_numpy(x).to(device))
    events = _k_events(61, W1_STEPS, W1_ADVANCE, (0.05, (0.0, 150.0)), (0.005, (250.0, 400.0)))
    tenants, _ = _j_data()
    out = {}
    for kind in ("W1", "J1"):
        steps = []
        for i, e in enumerate(events):
            key = e["t"] if kind == "W1" else to(tenants[i % len(tenants)]["slots"])
            steps.append((to(e["scores"]), to(e["labels"].astype(np.float32)), key))
        p, t, key = steps[L3_POISON_STEP - 1]
        bad = p.clone()
        bad[::7] = float("nan")
        out[kind] = (steps, (bad, t, key))
    return out


def _l6_worker(rank, port, out):
    """One of L6's two Gloo processes: a ``Windowed(AUROC(approx="sketch"))`` ring joined to a process-local
    ``WatermarkAgreement``; rank 1's clock runs ``L6_LAG`` seconds behind rank 0's. The two processes call
    ``exchange()`` at the same points."""
    import torch
    import torch.distributed as dist

    import metrics_tpu_torch as pt
    from metrics_tpu_torch.observability import counters

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
    try:
        data = _k_events(66 + rank, 3, W1_ADVANCE, (0.0, (0.0, 0.0)), (0.0, (0.0, 0.0)), n=W5_N)
        agreement = pt.WatermarkAgreement(deadline_s=L6_DEADLINE, label=f"path L L6 rank {rank}")
        me = "fast" if rank == 0 else "slow"

        def ring(**kw):
            return pt.Windowed(pt.AUROC(approx="sketch", device="cpu"), window_s=W1_WINDOW_S, num_windows=W5_WINDOWS,
                               allowed_lateness_s=W1_LATENESS, **kw)

        def feed(m, b, times):
            m.update(torch.from_numpy(b["scores"]), torch.from_numpy(b["labels"]), event_time=times)

        m, lone = ring(agreement=agreement, rank=me), ring()
        base = 300.0 - L6_LAG * rank
        feed(m, data[0], base + data[0]["t"])
        feed(lone, data[0], base + data[0]["t"])
        agreement.exchange().result()
        res = {"wm": m.watermark, "agreed": agreement.agreed()}
        if rank == 0:
            # events 200-220 s behind this rank's clock: closed by its local clock, open by the agreed one
            late_t = m.watermark - 220.0 + data[1]["t"] % 20.0
            before = (m.dropped_samples, int(m.windowed_rows.sum()))
            feed(m, data[1], late_t)
            feed(lone, data[1], late_t)
            res["held_open"] = {"dropped": m.dropped_samples - before[0], "rows": int(m.windowed_rows.sum()) - before[1],
                                "n": int(late_t.size), "lone_dropped": lone.dropped_samples}
        stragglers = counters.snapshot()["wm_stragglers"]
        time.sleep(L6_DEADLINE + 0.3)  # rank 1's participant is silent past the deadline
        if rank == 0:
            feed(m, data[2], m.watermark + 1.0 + data[2]["t"] % 5.0)
        agreement.exchange().result()
        res["silent"] = {"agreed": agreement.agreed(), "wm": m.watermark, "excluded": list(agreement.excluded()),
                         "stragglers": counters.snapshot()["wm_stragglers"] - stragglers}
        if rank == 1:
            feed(m, data[2], m.watermark + 10.0 + data[2]["t"] % 5.0)  # the silent rank advances again
        agreement.exchange().result()
        res["rejoined"] = {"agreed": agreement.agreed(), "wm": m.watermark, "excluded": list(agreement.excluded()),
                           "exchanges": agreement.exchanges}
        with open(out, "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def _run_path_l6():
    """L6: two Gloo processes of this script (``--l6-worker``), killed if they outlive their timeout."""
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        outs = [os.path.join(tmp, f"l6_{r}.json") for r in range(2)]
        env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--l6-worker", str(r), str(port), outs[r]],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        t0 = time.perf_counter()
        try:
            logs = [p.communicate(timeout=240)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        if [p.returncode for p in procs] != [0, 0]:
            raise AssertionError(f"L6 workers failed: {[p.returncode for p in procs]} {logs}")
        results = []
        for path in outs:
            with open(path) as f:
                results.append(json.load(f))
    return {"ranks": results, "s": time.perf_counter() - t0}


def run_path_l(device, a_batches):
    """Path L inside the caller's process group: L1-L5 on the card, timed, with what the checks need on the host;
    L6 in two Gloo processes."""
    import torch

    import metrics_tpu_torch as pt
    from metrics_tpu_torch.observability import counters
    from metrics_tpu_torch.parallel import faults, sync
    from metrics_tpu_torch.utils.exceptions import StateCorruptionError, SyncTimeoutError

    out = {}
    # L1: lag-k against the synchronous run in this call
    out["L1"] = {f"lag{k}": _l_lagged(device, a_batches, k) for k in (0, 1, 2)}
    out["L1"]["auto"] = _l_lagged(device, a_batches, "auto")
    profiles = {}
    for k in (0, 2) if device.type == "cuda" else ():
        col = _main_collection(device, dist_sync_on_step=True)
        for m in col.values():
            m.sync_lag = k
        it = iter(a_batches * 2)
        profiles[k] = _j_profile(lambda: col(*next(it)))
    out["L1"]["profiles"] = profiles

    # L2: the guard on the card, every schedule on the collection's sync
    batches = a_batches[:L_GUARD_STEPS]
    out["L2"] = {
        "drop2": _l_guarded(device, batches, sync.SyncGuard(max_retries=2, backoff_s=0.01),
                            [dict(kind="drop", call=1, times=2)]),
        "corrupt": _l_guarded(device, batches, sync.SyncGuard(max_retries=2, backoff_s=0.01, check_finite=True),
                              [dict(kind="corrupt", call=0, times=1)]),
        "degrade": _l_guarded(device, batches, sync.SyncGuard(deadline_s=5.0, max_retries=1, backoff_s=0.01,
                                                              policy="degrade"),
                              [dict(kind="drop", rate=1.0, times=10**6)]),
        "raise": _l_guarded(device, batches, sync.SyncGuard(max_retries=1, backoff_s=0.01),
                            [dict(kind="drop", call=0, times=99)], expect=SyncTimeoutError),
        "deadline": _l_guarded(device, batches, sync.SyncGuard(deadline_s=5.0), []),
    }

    # L3: integrity over W1's and J1's streams (float-state inners), and J1 itself with a NaN batch
    l3 = {}
    for kind, (steps, poison) in _l3_inputs(device).items():
        counters.reset()
        clean, clean_ms, _ = _l3_run(kind, device, steps)
        quarantined, _, around = _l3_run(kind, device, steps, policy="quarantine", poison=poison)
        part = {"clean": _j_counts(clean), "quarantined": _j_counts(quarantined), "ms": clean_ms, **around,
                "quarantined_updates": counters.snapshot()["faults"]["quarantined_updates"]}
        raising = _l3_make(kind, device, "raise")
        try:
            _l3_call(kind, raising, *poison)
            part["raise"] = None
        except StateCorruptionError as err:
            part["raise"] = type(err).__name__
        guarded = _l3_make(kind, device, "quarantine")
        _l3_call(kind, guarded, *steps[0])
        with _CountCollectives() as calls:
            part["host_syncs"], _ = _l_host_syncs(device, lambda: _l3_call(kind, guarded, *steps[1]))
        part["calls"] = dict(calls)
        state = faults.corrupt_pytree(clean._current_state(), fraction=0.25)
        rows = next(n for n in state if n.endswith("_rows"))
        state[rows] = state[rows].clone()
        state[rows][:3] = torch.iinfo(state[rows].dtype).max - 1
        part["card_counts"] = [int(c) for c in pt.state_integrity_counts(state)]
        part["cpu_counts"] = [int(c) for c in pt.state_integrity_counts({k: v.cpu() for k, v in state.items()})]
        l3[kind] = part
    j1 = pt.Keyed(pt.AUROC(approx="sketch", device=device), num_slots=J_SLOTS)
    j1.check_finite = "raise"
    steps, poison = _l3_inputs(device)["J1"]
    j1(poison[0], poison[1].long(), slot=poison[2])  # NaN scores into a sketch: the binning drops them
    l3["J1_sketch_counts"] = [int(c) for c in pt.state_integrity_counts(j1._current_state())]
    out["L3"] = l3

    # L4: checkpoint at step 10, restore, replay from step 7 with guarded_update
    unbroken = _main_collection(device, dist_sync_on_step=True)
    unbroken.persistent(True)
    checkpoint = None
    for i, b in enumerate(a_batches):
        unbroken.update(*b)
        if i + 1 == L4_CHECKPOINT:
            checkpoint = unbroken.state_dict()
    want = {k: v.item() for k, v in unbroken.compute().items()}
    restored = _main_collection(device, dist_sync_on_step=True)
    restored.persistent(True)
    restored.load_state_dict(checkpoint)
    t0 = time.perf_counter()
    applied = [restored.guarded_update(i, *a_batches[i]) for i in range(L4_REPLAY_FROM, A_STEPS)]
    _sync(device)
    replay_ms = (time.perf_counter() - t0) * 1e3
    got = {k: v.item() for k, v in restored.compute().items()}
    acc = _main_collection(device)["Accuracy"]
    acc.load_state_dict({k.split(".", 1)[1]: v for k, v in checkpoint.items() if k.startswith("Accuracy.")})
    try:
        acc.guarded_update(L4_CHECKPOINT - 1, *a_batches[L4_CHECKPOINT], span_end=L4_CHECKPOINT + 1)
        straddle = None
    except ValueError as err:
        straddle = str(err)
    out["L4"] = {"want": want, "got": got, "applied": applied, "watermark": restored.epoch_watermark,
                 "straddle": straddle, "replay_ms": replay_ms}

    # L5: the deferred pure view; the live state is written in place after dispatch
    col = _main_collection(device)
    pure = col.pure()
    state = pure.update(pure.init(), *a_batches[0])
    state = pure.update(state, *a_batches[1])
    want = pure.sync(state)
    with _CountCollectives() as dispatch_calls:
        t0 = time.perf_counter()
        dispatch_syncs, handle = _l_host_syncs(device, lambda: col.sync_state(state, deferred=True))
        dispatch_ms = (time.perf_counter() - t0) * 1e3
    for entry in state.values():
        for value in entry.values():
            value.add_(7)  # in place, while the collective may still run
    t0 = time.perf_counter()
    fence_syncs, got = _l_host_syncs(device, handle.result)
    fence_ms = (time.perf_counter() - t0) * 1e3
    out["L5"] = {"equal": all(torch.equal(got[k][n], want[k][n]) for k in want for n in want[k]),
                 "values_equal": {k: v.item() for k, v in pure.compute(got).items()}
                 == {k: v.item() for k, v in pure.compute(want).items()},
                 "dispatch_calls": dict(dispatch_calls), "dispatch_ms": dispatch_ms, "fence_ms": fence_ms,
                 "watermark": handle.watermark, "host_syncs": (dispatch_syncs, fence_syncs)}

    # L6: the agreement across two processes
    out["L6"] = _run_path_l6()
    return out


def check_path_l(result):
    timings = {}
    print(f"[15] path L: the guarded and deferred sync plane at path A's size ({A_BATCH} x {A_CLASSES}, {A_STEPS}"
          f" steps) and W1's ({K_N:,} events a step)")

    # L1
    run = result["L1"]
    sync_run = run["lag0"]
    for k in (1, 2):
        lag = run[f"lag{k}"]
        want = [sync_run["values"][i - k] if i >= k else None for i in range(A_STEPS)]
        _check(all(lag["values"][i] == want[i] for i in range(k, A_STEPS)) and lag["epoch"] == sync_run["epoch"],
               f"L1 sync_lag={k}: every step from {k} on equals the synchronous run's value {k} steps back bit for"
               f" bit, and the epoch compute() after the drain equals the synchronous epoch")
    _check(run["auto"]["epoch"] == sync_run["epoch"], "L1 sync_lag='auto': the epoch equals the synchronous epoch")
    for k, label in ((0, "synchronous"), (1, "sync_lag=1"), (2, "sync_lag=2"), ("auto", "sync_lag='auto'")):
        part = run[k if k == "auto" else f"lag{k}"]
        per_step = part["calls"][-1]
        timings[f"L1_{label}"] = {"ms_per_step": statistics.median(part["ms"]), "all_reduce_per_step":
                                  per_step["all_reduce"]}
        print(f"    L1 {label}: median {statistics.median(part['ms']):.3f} ms/step (first {part['ms'][0]:.1f});"
              f" {per_step['all_reduce']} all_reduce / {per_step['all_gather']} all_gather a step;"
              f" epoch {part['epoch_calls']}" + (f"; chosen lag {part['chosen']}" if k == "auto" else ""))
    for k, prof in run["profiles"].items():
        device = f"{prof['device_ms']:.3f} device ms" if prof["device_ms"] else "device time not measured"
        print(f"    L1 profiled step, sync_lag={k}: {device}, {prof['ops']:.0f} operations,"
              f" {prof['host_syncs']} synchronizing calls {prof['sync_sites'][:3]}")
        timings[f"L1_lag{k}_host_syncs"] = prof["host_syncs"]
    timings["L1_auto_lag"] = run["auto"]["chosen"]

    # L2
    clean = run["lag0"]["values"][:L_GUARD_STEPS]
    l2 = result["L2"]
    zero = {"sync_retries": 0, "sync_deadline_exceeded": 0, "degraded_computes": 0, "quarantined_updates": 0}
    _check(l2["drop2"]["values"] == clean and l2["drop2"]["faults"] == dict(zero, sync_retries=2),
           "L2: a transient drop x2 records sync_retries 2 and gives values bit-equal to the unfaulted run")
    _check(l2["corrupt"]["values"] == clean and l2["corrupt"]["faults"] == dict(zero, sync_retries=1),
           "L2: a corrupt payload under check_finite=True is retried once, values bit-equal")
    _check(l2["degrade"]["values"] == clean and l2["degrade"]["faults"]["degraded_computes"] >= L_GUARD_STEPS,
           f"L2: a persistent drop under policy='degrade' gives local-only values (one rank: the synced ones),"
           f" degraded_computes {l2['degrade']['faults']['degraded_computes']}, {l2['degrade']['ms']:.1f} ms/step")
    _check(l2["raise"].get("raised") == "SyncTimeoutError",
           f"L2: a persistent drop under policy='raise' raises SyncTimeoutError ({l2['raise'].get('s', 0):.2f} s)")
    _check(l2["deadline"]["values"] == clean and l2["deadline"]["faults"] == zero,
           f"L2: the deadline path (async NCCL work, polled) gives the unfaulted values at"
           f" {l2['deadline']['ms']:.3f} ms/step")
    for name, part in l2.items():
        if "calls" in part:
            print(f"    L2 {name}: {part['ms']:.3f} ms/step; {part['calls']['all_reduce']:g} all_reduce /"
                  f" {part['calls']['all_gather']:g} all_gather a step (epoch excluded); {part['host_syncs']}"
                  f" synchronizing calls in its last step; faults {part['faults']}")
    timings["L2_ms_per_step"] = {k: v.get("ms") for k, v in l2.items()}

    # L3
    for kind, label in (("W1", "Windowed(MeanSquaredError()) over W1's stream"),
                        ("J1", f"Keyed(MeanSquaredError(), {J_SLOTS:,}) over J1's tenants")):
        part = result["L3"][kind]
        _k_states_equal(f"L3 {kind} at the poisoned batch", part["after"], part["before"])
        _k_states_equal(f"L3 {kind} after the stream", part["quarantined"], part["clean"], rtol=RTOL_L3)
        _check(part["quarantined_updates"] == 1,
               f"L3 {label}: check_finite='quarantine' drops the NaN-poisoned batch: the slabs after it are bit-equal"
               f" to the slabs before it, and after the stream equal the run without it (counts exactly, float32 sums"
               f" to rtol {RTOL_L3}); quarantined_updates + 1 ({statistics.median(part['ms']):.3f} ms/step)")
        _check(part["raise"] == "StateCorruptionError", f"L3 {label}: check_finite='raise' raises StateCorruptionError")
        _check(part["card_counts"] == part["cpu_counts"] and min(part["card_counts"]) > 0,
               f"L3 {kind}: state_integrity_counts of a corrupted state on the card {part['card_counts']} equal the"
               f" CPU's")
        print(f"    L3 {kind}: {statistics.median(part['ms']):.3f} ms/step (check_finite off); a quarantine-policy step"
              f" makes {part['calls']['all_reduce']} all_reduce / {part['calls']['all_gather']} all_gather and"
              f" {part['host_syncs']} synchronizing calls")
        timings[f"L3_{kind}_ms_per_step"] = statistics.median(part["ms"])
    _check(result["L3"]["J1_sketch_counts"] == [0, 0],
           "L3 J1 Keyed(AUROC sketch): NaN scores leave the integer sketch counts clean (the binning drops them),"
           " so check_finite has nothing to quarantine there")

    # L4
    l4 = result["L4"]
    replayed = A_STEPS - L4_REPLAY_FROM
    _check(l4["got"] == l4["want"] and l4["applied"] == [False] * (L4_CHECKPOINT - L4_REPLAY_FROM)
           + [True] * (A_STEPS - L4_CHECKPOINT) and l4["watermark"] == A_STEPS,
           f"L4: restored at step {L4_CHECKPOINT}, replayed from step {L4_REPLAY_FROM} with guarded_update"
           f" ({replayed} calls, {l4['replay_ms']:.1f} ms): steps {L4_REPLAY_FROM}-{L4_CHECKPOINT - 1} no-ops, the"
           f" epoch equals the unbroken run bit for bit")
    _check(l4["straddle"] is not None and "straddles the epoch watermark" in l4["straddle"],
           "L4: a span straddling the watermark raises ValueError")

    # L5
    l5 = result["L5"]
    _check(l5["equal"] and l5["values_equal"] and l5["dispatch_calls"]["all_reduce"] == 1,
           f"L5: MetricCollection.pure()'s sync_state(deferred=True) enters one all_reduce at dispatch"
           f" ({l5['dispatch_ms']:.3f} ms) and resolves ({l5['fence_ms']:.3f} ms) to the synchronous result although"
           f" the live state was written in place after dispatch")
    print(f"    L5: synchronizing calls at dispatch {l5['host_syncs'][0]}, at result() {l5['host_syncs'][1]}")
    timings["L5"] = {"dispatch_ms": l5["dispatch_ms"], "fence_ms": l5["fence_ms"]}

    # L6
    fast, slow = result["L6"]["ranks"]
    _check(fast["agreed"] == slow["agreed"] == slow["wm"] < fast["wm"] - L6_LAG + W1_ADVANCE,
           f"L6: two Gloo processes agree on the minimum, the slow rank's clock {slow['wm']:.1f} (fast"
           f" {fast['wm']:.1f})")
    held = fast["held_open"]
    _check(held["dropped"] == 0 and held["rows"] == held["n"] and held["lone_dropped"] > 0,
           f"L6: {held['n']} events 200-220 s behind the fast rank's clock stay in their windows under the agreed"
           f" clock (a ring without the agreement drops {held['lone_dropped']})")
    _check(slow["silent"]["excluded"] == ["slow"] and slow["silent"]["stragglers"] == 1
           and fast["silent"]["agreed"] == fast["silent"]["wm"],
           "L6: the silent rank is excluded past its deadline (wm_stragglers + 1) and the fast rank's agreed clock"
           " advances to its own")
    _check(slow["rejoined"]["excluded"] == [] and fast["rejoined"]["exchanges"] == slow["rejoined"]["exchanges"] == 3
           and slow["rejoined"]["agreed"] > slow["agreed"],
           f"L6: the silent rank rejoins on its next advance; 3 exchange rounds on each process"
           f" ({result['L6']['s']:.1f} s with the workers' start)")
    return timings


# ---- path M: the topology-aware and sparse sync planes, at J1's, J4's and W1's sizes in the script's one-rank NCCL
# group; M6 in four Gloo processes on the host (2 slices of 2)
M_STEPS = 20
M_TOUCH = M_CAPACITY = 64  # the JAX package's bench.py sparse scenario: SPARSE_TOUCH = SPARSE_CAPACITY = 64
M_WIDE = 1_000  # slots of the step that must fall back
M_CPU_STEPS = 2  # steps of M1 the CPU run repeats
M2_STEPS, M3_STEPS = 10, 12  # J4's and W1's first steps (J4's host table is ~90% of its step)
M6_WORLD, M6_SLICES, M6_SLOTS, M6_ROUNDS, M6_N = 4, 2, 1_000, 5, 4_096
RTOL_M6 = 1e-6  # float32 sums of 4 terms, two stages against one


def _m1_data():
    """M1's steps: ``J_N`` events over ``M_TOUCH`` hot tenants drawn anew each step, then one step over ``M_WIDE``
    tenants (the fallback) and one step with no events (the skip); J1's label and score model."""
    rng = np.random.RandomState(71)
    steps = []
    for i in range(M_STEPS + 2):
        n = 0 if i == M_STEPS + 1 else J_N
        width = M_WIDE if i == M_STEPS else M_TOUCH
        hot = rng.choice(J_SLOTS, width, replace=False)
        labels = (rng.random_sample(n) < 0.3).astype(np.int64)
        scores = (1 / (1 + np.exp(-(rng.standard_normal(n) + 1.5 * labels)))).astype(np.float32)
        steps.append({"slots": hot[rng.randint(0, width, n)].astype(np.int64), "labels": labels, "scores": scores})
    return steps


def _m_state_equal(a, b):
    import torch

    return all(torch.equal(_m_payload(a[k]), _m_payload(b[k])) for k in a)


def _m_payload(value):
    return value.counts if hasattr(value, "counts") else value


def _m_round(device, plane, state, touched=None):
    """One sparse round, timed (host clock, synchronized before and after), with the counters it records and the
    peak device bytes it allocates above what was live before it."""
    import torch

    from metrics_tpu_torch.observability import counters

    if device.type == "cuda":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    counters.reset()
    counters.enable()
    t0 = time.perf_counter()
    merged = plane.sync(state, touched=touched)
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    snap = counters.snapshot()
    counters.disable()
    peak = torch.cuda.max_memory_allocated() - base if device.type == "cuda" else None
    return merged, {"ms": ms, "calls": snap["calls_by_kind"], "bytes": snap["bytes_by_kind_dtype"],
                    "sync_bytes": snap["sync_bytes"], "sparse": snap["sparse"], "peak": peak}


def _m6_worker(rank, port, out):
    """One of M6's four Gloo processes (2 slices of 2): the two-stage sum and gather against the flat plane, the
    slice-leader gather, ``buffer_all_gather`` and sparse rounds over a ``Keyed(AUROC sketch, 1,000)`` fed this rank's
    own slots, flat and two-level, with the counters each records."""
    import torch
    import torch.distributed as dist

    import metrics_tpu_torch as pt
    from metrics_tpu_torch.observability import counters
    from metrics_tpu_torch.parallel import sync
    from metrics_tpu_torch.parallel.buffer import PaddedBuffer, buffer_all_gather
    from metrics_tpu_torch.parallel.slab import slab_touched_mask

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=M6_WORLD, rank=rank)
    try:
        h = pt.parallel.hierarchical_mesh(slices=M6_SLICES)
        rng = np.random.RandomState(80 + rank)

        def counted(fn):
            counters.reset()
            counters.enable()
            try:
                result = fn()
            finally:
                snap = counters.snapshot()
                counters.disable()
            return result, {k: snap[k] for k in ("calls_by_crossing", "bytes_by_crossing", "calls_by_kind")}

        state = {"n": torch.from_numpy(rng.randint(-2**40, 2**40, 1000)),
                 "f": torch.from_numpy(rng.rand(1000).astype(np.float32)),
                 "cat": [torch.from_numpy(rng.rand(rank + 1, 3).astype(np.float32))]}
        red = {"n": "sum", "f": "sum", "cat": "cat"}
        hier, _ = counted(lambda: sync.all_reduce_state(state, red, group=h))
        flat, _ = counted(lambda: sync.all_reduce_state(state, red))
        sub, sub_red = {"n": state["n"], "f": state["f"]}, {"n": "sum", "f": "sum"}
        _, hier_counted = counted(lambda: sync.all_reduce_state(sub, sub_red, group=h))
        _, flat_counted = counted(lambda: sync.all_reduce_state(sub, sub_red))
        res = {"int_equal": torch.equal(hier["n"], flat["n"]),
               "float_rel": float(((hier["f"] - flat["f"]).abs() / flat["f"].abs()).max()),
               "cat_equal": torch.equal(hier["cat"], flat["cat"]), "cat_rows": int(hier["cat"].shape[0]),
               "grid": [list(g) for g in h.grid], "hier_counters": hier_counted, "flat_counters": flat_counted}
        hh = pt.parallel.HostHierarchy(tuple(r // (M6_WORLD // M6_SLICES) for r in range(M6_WORLD)))
        replicated = {"x": torch.full((4,), float(rank // (M6_WORLD // M6_SLICES) + 1))}
        lead, lead_counted = counted(lambda: sync.host_gather(replicated, {"x": "sum"}, slice_leaders=hh))
        res["leader"] = {"x": lead["x"].tolist(), "counters": lead_counted}
        buf = PaddedBuffer(torch.from_numpy(rng.rand(6, 2).astype(np.float32)), torch.tensor(rank + 1))
        bh, bf = buffer_all_gather(buf, h), buffer_all_gather(buf)
        res["buffer"] = {"equal": torch.equal(bh.data, bf.data) and int(bh.count) == int(bf.count),
                         "count": int(bh.count), "capacity": int(bh.data.shape[0])}
        for label, group in (("flat", None), ("hier", h)):
            keyed = pt.Keyed(pt.AUROC(approx="sketch", device="cpu"), num_slots=M6_SLOTS)
            plane = keyed.sparse_plane(group, capacity=M_CAPACITY)
            own = np.arange(rank * (M6_SLOTS // M6_WORLD), (rank + 1) * (M6_SLOTS // M6_WORLD))
            rounds = []
            for _ in range(M6_ROUNDS):
                slots = torch.from_numpy(rng.choice(own, 8, replace=False)[rng.randint(0, 8, M6_N)])
                labels = torch.from_numpy((rng.random_sample(M6_N) < 0.3).astype(np.int64))
                keyed.update(torch.from_numpy(rng.rand(M6_N).astype(np.float32)), labels, slot=slots)
                current = keyed._current_state()
                merged, calls = counted(lambda: plane.sync(current, touched=slab_touched_mask(slots, M6_SLOTS)))
                rounds.append({"equal": _m_state_equal(merged, sync.all_reduce_state(current, keyed._reductions)),
                               "calls": calls["calls_by_kind"], "crossings": calls["calls_by_crossing"]})
            res[label] = {"rounds": rounds, "modes": [plane.rounds, plane.fallbacks, plane.skips]}
        with open(out, "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def _start_m6():
    """M6's four Gloo processes of this script (``--m6-worker``), started now, on the CPU."""
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(__file__)), prefix="_m6_")
    outs = [os.path.join(tmp, f"m6_{r}.json") for r in range(M6_WORLD)]
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--m6-worker", str(r), str(port), outs[r]],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(M6_WORLD)]
    return {"procs": procs, "outs": outs, "tmp": tmp, "t0": time.perf_counter()}


def _finish_m6(started):
    """Wait for M6's processes (killed if they outlive their timeout) and read their results."""
    import shutil

    procs = started["procs"]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    try:
        if [p.returncode for p in procs] != [0] * M6_WORLD:
            raise AssertionError(f"M6 workers failed: {[p.returncode for p in procs]} {logs}")
        results = []
        for path in started["outs"]:
            with open(path) as f:
                results.append(json.load(f))
    finally:
        shutil.rmtree(started["tmp"], ignore_errors=True)
    return {"ranks": results, "s": time.perf_counter() - started["t0"]}


def run_path_m(device, a_batches):
    """Path M inside the caller's process group: M1-M5 and M7 on the card, timed, with what the checks need on the
    host; M6 in four Gloo processes started first and read last."""
    import torch

    import metrics_tpu_torch as pt
    from metrics_tpu_torch.functional.classification.auroc import _auroc_compute, _auroc_update
    from metrics_tpu_torch.observability import counters
    from metrics_tpu_torch.parallel import sync
    from metrics_tpu_torch.parallel.deferred import deferred_sparse_sync
    from metrics_tpu_torch.parallel.slab import slab_touched_mask

    m6 = _start_m6()
    out = {}
    to = (lambda x: torch.from_numpy(x).to(device))

    # M1: J1's Keyed(AUROC(approx="sketch"), 10,000) through its sparse plane, one hinted round a step
    data = _m1_data()
    keyed = pt.Keyed(pt.AUROC(approx="sketch", device=device), num_slots=J_SLOTS)
    _sync(device)
    before = torch.cuda.memory_allocated() if device.type == "cuda" else 0
    plane = keyed.sparse_plane(capacity=M_CAPACITY)
    _sync(device)
    plane_bytes = (torch.cuda.memory_allocated() - before) if device.type == "cuda" else None
    rounds, early, dense_equal = [], None, []
    for i, b in enumerate(data):
        slots = to(b["slots"])
        if b["slots"].size:
            keyed.update(to(b["scores"]), to(b["labels"]), slot=slots)
        state = keyed._current_state()
        merged, stats = _m_round(device, plane, state, touched=slab_touched_mask(slots, J_SLOTS))
        stats["mode"] = (plane.rounds, plane.fallbacks, plane.skips)
        rounds.append(stats)
        dense_equal.append(_m_state_equal(merged, sync.all_reduce_state(state, keyed._reductions)))
        if i == M_CPU_STEPS - 1:
            early = {k: _j_host(_m_payload(v)) for k, v in merged.items()}
    counters.reset()
    counters.enable()
    state = keyed._current_state()
    dense_ms = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        sync.all_reduce_state(state, keyed._reductions)
        _sync(device)
        dense_ms.append((time.perf_counter() - t0) * 1e3)
    dense_bytes = counters.snapshot()["sync_bytes"] // 3
    counters.disable()
    profiles = {}
    if device.type == "cuda":  # a sparse round (the last step's hint again: 64 rows of zero deltas) and a dense sync
        mask = slab_touched_mask(to(data[M_STEPS - 1]["slots"]), J_SLOTS)
        profiles["sparse"] = _j_profile(lambda: plane.sync(state, touched=mask))
        profiles["dense"] = _j_profile(lambda: sync.all_reduce_state(state, keyed._reductions))
    syncs = {}
    if device.type == "cuda":  # the synchronizing calls of one more round of each mode
        for mode, width in (("sparse", M_TOUCH), ("fallback", M_WIDE), ("skip", 0)):
            rng = np.random.RandomState(72 + width)
            n = J_N if width else 0
            ids = rng.choice(J_SLOTS, max(width, 1), replace=False)[rng.randint(0, max(width, 1), n)]
            if n:
                keyed.update(to(rng.rand(n).astype(np.float32)), to(rng.randint(0, 2, n)), slot=to(ids))
            mask = slab_touched_mask(to(ids.astype(np.int64)), J_SLOTS)
            sites, _ = _host_sync_sites(lambda: plane.sync(keyed._current_state(), touched=mask))
            syncs[mode] = {"calls": sum(sites.values()), "sites": sites.most_common(4)}
    out["M1"] = {"rounds": rounds, "dense_equal": dense_equal, "early": early, "plane_bytes": plane_bytes,
                 "state_bytes": _j_bytes(keyed), "dense_ms": dense_ms, "dense_bytes": dense_bytes, "syncs": syncs,
                 "profiles": profiles}

    # M4: deferred_sparse_sync over M1's state, one more step of M_TOUCH tenants
    rng = np.random.RandomState(73)
    ids = to(rng.choice(J_SLOTS, M_TOUCH, replace=False)[rng.randint(0, M_TOUCH, J_N)].astype(np.int64))
    keyed.update(to(rng.rand(J_N).astype(np.float32)), to(rng.randint(0, 2, J_N)), slot=ids)
    state = keyed._current_state()
    want = sync.all_reduce_state(state, keyed._reductions)
    _sync(device)
    t0 = time.perf_counter()
    handle = deferred_sparse_sync(plane, state, touched=slab_touched_mask(ids, J_SLOTS), watermark=M_STEPS)
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    got = handle.result()
    _sync(device)
    fence_ms = (time.perf_counter() - t0) * 1e3
    deferred_equal = _m_state_equal(got, want)
    after = plane.sync(keyed._current_state())  # a synchronous round after it: nothing changed, a skip
    out["M4"] = {"equal": deferred_equal, "after_equal": _m_state_equal(after, want), "dispatch_ms": dispatch_ms,
                 "fence_ms": fence_ms, "watermark": handle.watermark, "mode": (plane.rounds, plane.fallbacks,
                                                                             plane.skips)}
    del plane, keyed, merged, state, want, got, after
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # M2: J4's HeavyHitters(AUROC sketch) over 1,000,000 keys through its sparse plane (capacity: the hot tier)
    keys = _j_keys()[:M2_STEPS]
    rng = np.random.RandomState(74)
    hh = pt.HeavyHitters(pt.AUROC(approx="sketch", device=device), num_hot_slots=J4_HOT, tail=J4_TAIL)
    hplane = hh.sparse_plane(capacity=J4_HOT)
    m2 = []
    for k in keys:
        labels = (rng.random_sample(J_N) < 0.3).astype(np.int64)
        scores = (1 / (1 + np.exp(-(rng.standard_normal(J_N) + 1.5 * labels)))).astype(np.float32)
        hh.update(to(scores), to(labels), key=k)
        state = hh._current_state()
        merged, stats = _m_round(device, hplane, state)
        stats["equal"] = _m_state_equal(merged, sync.all_reduce_state(state, hh._reductions))
        stats["mode"] = (hplane.rounds, hplane.fallbacks, hplane.skips)
        m2.append(stats)
    out["M2"] = {"rounds": m2, "dense_names": list(hplane._dense_names), "state_bytes": _j_bytes(hh)}
    del hplane, hh

    # M3: W1's Windowed(AUROC sketch, 60 s, 4 windows, 180 s lateness) stream through its sparse plane
    events = _k_events(61, M3_STEPS, W1_ADVANCE, (0.05, (0.0, 150.0)), (0.005, (250.0, 400.0)))
    win = pt.Windowed(pt.AUROC(approx="sketch", device=device), window_s=W1_WINDOW_S, num_windows=W1_WINDOWS,
                      allowed_lateness_s=W1_LATENESS)
    wplane = win.sparse_plane()
    m3 = []
    for e in events:
        win.update(to(e["scores"]), to(e["labels"]), event_time=e["t"])
        state = win._current_state()
        merged, stats = _m_round(device, wplane, state)
        stats["equal"] = _m_state_equal(merged, sync.all_reduce_state(state, win._reductions))
        m3.append(stats)
    out["M3"] = {"rounds": m3, "capacity": wplane.capacity, "state_bytes": _j_bytes(win)}
    del wplane, win

    # M5: path A's collection with a one-rank MeshHierarchy as every member's group, against the flat run
    h = pt.parallel.hierarchical_mesh()
    flat_col = _main_collection(device, dist_sync_on_step=True)
    hier_col = _main_collection(device, dist_sync_on_step=True, process_group=h)
    m5 = {"equal": [], "calls": [], "crossings": None, "ms": [], "step_reduces": _packed_step_reduces(flat_col)}
    for b in a_batches:
        want = {k: v.item() for k, v in flat_col(*b).items()}
        counters.reset()
        counters.enable()
        with _CountCollectives() as calls:
            t0 = time.perf_counter()
            got = {k: v.item() for k, v in hier_col(*b).items()}
            m5["ms"].append((time.perf_counter() - t0) * 1e3)
        m5["crossings"] = counters.snapshot()["calls_by_crossing"]
        counters.disable()
        m5["equal"].append(got == want)
        m5["calls"].append(dict(calls))
    m5["epoch_equal"] = ({k: v.item() for k, v in hier_col.compute().items()}
                         == {k: v.item() for k, v in flat_col.compute().items()})
    out["M5"] = m5

    # M7: auroc over path C's first batch inside and outside the deferred-check window
    p, t = (to(x) for x in _curve_batches(1, C_N)[0])

    def outside():
        preds, target, mode = _auroc_update(p, t)
        return _auroc_compute(preds, target, mode, pos_label=1)

    m7 = {}
    for label, fn in (("window", lambda: pt.functional.auroc(p, t, pos_label=1)), ("no_window", outside)):
        fn()
        _sync(device)
        t0 = time.perf_counter()
        value = fn()
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        sites, _ = _host_sync_sites(fn) if device.type == "cuda" else (Counter(), None)
        m7[label] = {"value": value.item(), "ms": ms, "syncs": sum(sites.values()), "sites": sites.most_common(4)}
    errors = {}
    for label, target in (("all_positive", torch.ones_like(t)), ("all_negative", torch.zeros_like(t))):
        for form, fn in (("window", lambda y: pt.functional.auroc(p, y, pos_label=1)),
                         ("no_window", lambda y: _auroc_compute(*_auroc_update(p, y), pos_label=1))):
            try:
                fn(target)
                errors[(label, form)] = None
            except ValueError as err:
                errors[(label, form)] = str(err)
    m7["errors"] = {f"{a}/{b}": v for (a, b), v in errors.items()}
    out["M7"] = m7
    out["M6"] = _finish_m6(m6)
    return out


def _m_rounds_line(label, rounds):
    ms = [r["ms"] for r in rounds]
    return (f"median {statistics.median(ms):.3f} ms a round (first {ms[0]:.1f}); collectives a round"
            f" {rounds[-1]['calls']}; bytes a round {rounds[-1]['sync_bytes']:,}")


def check_path_m(result):
    import torch

    import metrics_tpu_torch as pt
    from metrics_tpu_torch.parallel.slab import slab_touched_mask

    timings = {}
    print(f"[16] path M: the topology-aware and sparse sync planes at J1's ({J_SLOTS:,} tenants), J4's and W1's sizes;"
          f" {J_N:,} events a step over {M_TOUCH} hot tenants, capacity {M_CAPACITY}")

    # M1
    m1 = result["M1"]
    rounds = m1["rounds"]
    sparse = rounds[:M_STEPS]
    modes = [r["mode"] for r in rounds]
    _check(modes == [(i + 1, 0, 0) for i in range(M_STEPS)] + [(M_STEPS + 1, 1, 0), (M_STEPS + 2, 1, 1)],
           f"M1: {M_STEPS} sparse rounds of {M_TOUCH} touched tenants, then a {M_WIDE}-tenant step that falls back and an"
           " empty step that skips")
    _check(all(m1["dense_equal"]), "M1: every round's merged view equals the dense bucketed all_reduce of the same"
           " state bit for bit")
    _check(all(r["calls"] == {"psum": 1, "all_gather": 1} for r in sparse)
           and rounds[M_STEPS + 1]["calls"] == {"psum": 1}
           and rounds[M_STEPS]["calls"].get("psum", 0) >= 2 and "all_gather" not in rounds[M_STEPS]["calls"],
           f"M1: collectives a round: {sparse[-1]['calls']} sparse, {rounds[M_STEPS + 1]['calls']} skip,"
           f" {rounds[M_STEPS]['calls']} fallback (the bitmap and the dense plane's buckets)")
    _check(all(r["sparse"]["rows"] == M_TOUCH for r in sparse), f"M1: {M_TOUCH} union rows a sparse round")
    cpu = pt.Keyed(pt.AUROC(approx="sketch", device="cpu"), num_slots=J_SLOTS)
    cplane = cpu.sparse_plane(capacity=M_CAPACITY)
    for b in _m1_data()[:M_CPU_STEPS]:
        slots = torch.from_numpy(b["slots"])
        cpu.update(torch.from_numpy(b["scores"]), torch.from_numpy(b["labels"]), slot=slots)
        merged = cplane.sync(cpu._current_state(), touched=slab_touched_mask(slots, J_SLOTS))
    _j_states_equal(f"M1 merged view against the CPU run after {M_CPU_STEPS} rounds", m1["early"],
                    {k: _j_host(_m_payload(v)) for k, v in merged.items()})
    med = statistics.median(r["ms"] for r in sparse)
    row_bytes = sparse[-1]["sync_bytes"]
    print(f"    M1 sparse: {_m_rounds_line('M1', sparse)} (bitmap {sparse[-1]['bytes'].get('psum:int64', 0):,} B,"
          f" header + rows {sparse[-1]['bytes'].get('all_gather:uint8', 0):,} B) against the dense plane's"
          f" {m1['dense_bytes']:,} B in {statistics.median(m1['dense_ms']):.3f} ms; fallback round"
          f" {rounds[M_STEPS]['ms']:.3f} ms, skip round {rounds[M_STEPS + 1]['ms']:.3f} ms")
    peak = max(r["peak"] for r in sparse) if sparse[0]["peak"] is not None else None

    def mib(x):
        return "not measured" if x is None else f"{x / 2**20:.1f} MiB"

    print(f"    M1 memory: the plane's two copies {mib(m1['plane_bytes'])} above the {m1['state_bytes'] / 1e6:.1f} MB"
          f" slab; a sparse round's peak {mib(peak)} above what was live; a fallback round's"
          f" {mib(rounds[M_STEPS]['peak'])}")
    for mode, s in m1["syncs"].items():
        print(f"    M1 synchronizing calls, one {mode} round: {s['calls']} {s['sites']}")
    for label, prof in m1["profiles"].items():
        device = f"{prof['device_ms']:.3f} device ms" if prof["device_ms"] else "device time not measured"
        print(f"    M1 profiled {label} round: {device}, {prof['ops']:.0f} operations; top"
              f" {[(r['name'][:40], round(r['us_per_call'], 1)) for r in prof['top'][:5]]}")
    timings["M1"] = {"ms_per_round": med, "bytes_per_round": row_bytes, "dense_bytes": m1["dense_bytes"],
                     "dense_ms": statistics.median(m1["dense_ms"]), "fallback_ms": rounds[M_STEPS]["ms"],
                     "skip_ms": rounds[M_STEPS + 1]["ms"], "plane_bytes": m1["plane_bytes"], "round_peak_bytes": peak,
                     "device_ms": {k: v["device_ms"] for k, v in m1["profiles"].items()},
                     "host_syncs": {k: v["calls"] for k, v in m1["syncs"].items()}}

    # M2
    m2 = result["M2"]
    _check(all(r["equal"] for r in m2["rounds"]) and all(r["mode"][1] == 0 for r in m2["rounds"]),
           f"M2 HeavyHitters(AUROC sketch, {J4_HOT}, {J4_TAIL}): hot and tail counts equal the dense sync bit for bit"
           f" every round, no fallback at capacity {J4_HOT}")
    _check(set(m2["dense_names"]) == {"AUROC_hist_tail", "hh_tail_rows"} or all(
        n.endswith("_tail") or n == "hh_tail_rows" for n in m2["dense_names"]),
        f"M2: the tails {m2['dense_names']} are dense residuals")
    _check(all(r["calls"] == {"psum": 1, "all_gather": 1} for r in m2["rounds"]),
           "M2: the tails' deltas ride the bitmap collective: one all_reduce and one all_gather a round")
    rows = [r["sparse"]["rows"] for r in m2["rounds"]]
    print(f"    M2: {_m_rounds_line('M2', m2['rounds'])}; union rows a round {rows}; state {m2['state_bytes']:,} B")
    timings["M2"] = {"ms_per_round": statistics.median(r["ms"] for r in m2["rounds"]), "rows": rows,
                     "bytes_per_round": m2["rounds"][-1]["sync_bytes"]}

    # M3
    m3 = result["M3"]
    rows = [r["sparse"]["rows"] for r in m3["rounds"]]
    _check(all(r["equal"] for r in m3["rounds"]) and m3["capacity"] == W1_WINDOWS and max(rows) <= W1_WINDOWS,
           f"M3 Windowed(AUROC sketch) over W1's stream: every window's counts equal the dense sync bit for bit; rows"
           f" exchanged a round {rows} (at most the ring's {W1_WINDOWS})")
    print(f"    M3: {_m_rounds_line('M3', m3['rounds'])}; state {m3['state_bytes']:,} B")
    timings["M3"] = {"ms_per_round": statistics.median(r["ms"] for r in m3["rounds"]), "rows": rows}

    # M4
    m4 = result["M4"]
    _check(m4["equal"] and m4["after_equal"] and m4["watermark"] == M_STEPS,
           f"M4: deferred_sparse_sync over M1's state dispatches ({m4['dispatch_ms']:.3f} ms, the state's copy"
           f" included) and fences ({m4['fence_ms']:.3f} ms); result() equals the dense sync, and the synchronous round"
           " after it too")
    timings["M4"] = {"dispatch_ms": m4["dispatch_ms"], "fence_ms": m4["fence_ms"]}

    # M5
    m5 = result["M5"]
    per_step = m5["calls"][-1]["all_reduce"]
    _check(all(m5["equal"]) and m5["epoch_equal"] and all(c["all_reduce"] == m5["step_reduces"] for c in m5["calls"])
           and set(m5["crossings"]) == {"ici"},
           f"M5: path A's collection with a one-rank MeshHierarchy equals the flat run bit for bit every step and at the"
           f" epoch, with {per_step} all_reduce a step (the flat step's packed sync makes {m5['step_reduces']}), counted"
           f" at {m5['crossings']}"
           f" ({statistics.median(m5['ms']):.3f} ms/step)")
    timings["M5_ms_per_step"] = statistics.median(m5["ms"])

    # M6
    ranks = result["M6"]["ranks"]
    payload = 1000 * 8 + 1000 * 4
    for r, res in enumerate(ranks):
        _check(res["int_equal"] and res["float_rel"] <= RTOL_M6 and res["cat_equal"] and res["cat_rows"] == 10
               and res["grid"] == [[0, 1], [2, 3]],
               f"M6 rank {r}: the two-stage sum equals the flat sum (int64 bit for bit, float32 within {RTOL_M6}) and the"
               f" gather comes back in flat rank order")
        _check(res["hier_counters"]["bytes_by_crossing"] == {"ici": payload, "dcn": payload}
               and res["flat_counters"]["bytes_by_crossing"] == {"world": payload * (M6_WORLD - 1)},
               f"M6 rank {r}: bytes by crossing equal the JAX package's formula, payload x (fanout - 1):"
               f" {res['hier_counters']['bytes_by_crossing']} two-stage, {res['flat_counters']['bytes_by_crossing']}"
               " flat")
        _check(res["leader"]["x"] == [3.0] * 4 and res["leader"]["counters"]["bytes_by_crossing"] == {"dcn": 16},
               f"M6 rank {r}: slice_leader_gather keeps one copy a slice, counted at dcn with slice fanout")
        _check(res["buffer"]["equal"] and res["buffer"]["count"] == 10 and res["buffer"]["capacity"] == 24,
               f"M6 rank {r}: buffer_all_gather two-level equals flat")
        for label, per_round in (("flat", 2), ("hier", 4)):
            part = res[label]
            _check(all(x["equal"] for x in part["rounds"]) and part["modes"] == [M6_ROUNDS, 0, 0]
                   and all(sum(x["calls"].values()) == per_round for x in part["rounds"]),
                   f"M6 rank {r} {label}: {M6_ROUNDS} sparse rounds over Keyed(AUROC sketch, {M6_SLOTS:,}) with each rank's"
                   f" own slots equal the flat dense sync bit for bit, {per_round} collectives a round")
    print(f"    M6: four Gloo processes, {result['M6']['s']:.1f} s with their start")

    # M7
    m7 = result["M7"]
    _check(m7["window"]["value"] == m7["no_window"]["value"],
           f"M7: auroc over path C's first batch: {m7['window']['syncs']} synchronizing calls inside the window"
           f" ({m7['window']['ms']:.3f} ms), {m7['no_window']['syncs']} outside ({m7['no_window']['ms']:.3f} ms);"
           " equal values")
    errors = m7["errors"]
    _check(errors["all_positive/window"] == errors["all_positive/no_window"] and "No negative" in errors[
        "all_positive/window"] and errors["all_negative/window"] == errors["all_negative/no_window"]
           and "No positive" in errors["all_negative/window"],
           "M7: an all-positive and an all-negative target raise the same errors inside and outside the window")
    print(f"    M7 synchronizing call sites: window {m7['window']['sites']}, outside {m7['no_window']['sites']}")
    timings["M7"] = {k: {"syncs": m7[k]["syncs"], "ms": m7[k]["ms"]} for k in ("window", "no_window")}
    return timings


# ---------------------------------------------------------------- path N: the sharded epoch
N2_CAPACITY = A_STEPS * A_BATCH  # path A's epoch: 81,920 rows of 1,000 classes
N5_SKEW_ROWS, N5_SKEW_BUCKET = 4_096, 1_024  # the skewed regroup: 4,096 rows of one query into 1,024-row buckets
N6_WORLD, N6_SLICES = 4, 2
N6_N = 65_536  # global rows of N6's ring and regroup runs: 16,384 a rank
N6_CLASSES = 16
N6_KENDALL = 4_096  # Kendall's global rows: 1,024 a rank
N6_QUERIES = 2_048
N6_A_STEPS, N6_A_BATCH = 4, 512  # class_sharded: path A's collection (1,000 classes) over 4 steps of 512
RTOL_N = 1e-5  # sharded against gathered and float64 oracles: float32 sums in another order (N1, N2, N4 Spearman)
RTOL_N6 = 1e-6  # N6's ranks against one process's unsharded port


class _NoGather:
    """Inside: the port's ``buffer_values``, ``buffer_all_gather`` and ``host_gather`` raise when called."""

    def __enter__(self):
        import metrics_tpu_torch.core.metric as pmetric
        import metrics_tpu_torch.parallel.buffer as pbuffer
        import metrics_tpu_torch.parallel.sync as psync

        def boom(*_a, **_k):
            raise AssertionError("path N: the sharded compute called a gather of the epoch")

        self.saved = [(mod, name, getattr(mod, name)) for mod, name in
                      ((pbuffer, "buffer_values"), (pbuffer, "buffer_all_gather"), (psync, "host_gather"),
                       (pmetric, "host_gather"))]
        for mod, name, _ in self.saved:
            setattr(mod, name, boom)

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _n_epoch(collection, device, sharded):
    """One collection's epoch ``compute()``, uncached: its collectives by kind (the port's counters) and
    synchronizing calls (torch's sync debug mode) in a first call, its peak device bytes above what was live
    before it, and two timed calls. A sharded collection computes with the gather functions raising."""
    import torch

    from metrics_tpu_torch.observability import counters

    def fresh():
        for m in collection.values():
            m._computed = None
        return collection.compute()

    owns = [m._states_own_sync() for m in collection.values()]
    import contextlib

    guard = _NoGather if sharded else contextlib.nullcontext
    _sync(device)
    base = torch.cuda.memory_allocated() if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    counters.reset()
    counters.enable()
    try:
        with guard():
            if device.type == "cuda":
                sites, values = _host_sync_sites(fresh)
            else:
                sites, values = Counter(), fresh()
            _sync(device)
    finally:
        snap = counters.snapshot()
        counters.disable()
    peak = torch.cuda.max_memory_allocated() - base if device.type == "cuda" else None
    ms = []
    with guard():
        for _ in range(2):
            t0 = time.perf_counter()
            fresh()
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
    return {"values": values, "ms": ms, "peak_bytes": peak, "calls": dict(snap["calls_by_kind"]),
            "syncs": sum(sites.values()), "sync_sites": sites.most_common(6), "owns_sync": owns}


def _n_placed(collection):
    from metrics_tpu_torch.parallel import row_sharded

    return collection.device_put(row_sharded())


def _n_feed(collection, batches):
    for batch in batches:
        collection.update(*batch)
    return collection


def _n_prc_oracle(scores, target):
    """The precision / recall curve in float64 numpy, sklearn's orientation: thresholds ascending, cut at full
    recall, (1, 0) appended."""
    uniq, inverse = np.unique(scores, return_inverse=True)
    pos = np.bincount(inverse, weights=target, minlength=len(uniq))[::-1]
    neg = np.bincount(inverse, minlength=len(uniq))[::-1] - pos
    tp, fp = np.cumsum(pos), np.cumsum(neg)
    stop = int(np.argmax(tp >= tp[-1])) + 1
    precision = np.concatenate([(tp / (tp + fp))[:stop][::-1], [1.0]])
    recall = np.concatenate([(tp / tp[-1])[:stop][::-1], [0.0]])
    return precision, recall, uniq[::-1][:stop][::-1]


def run_path_n(device, a_batches, path_c, path_e, path_f):
    """Path N inside the caller's process group: N1-N5 and N7 on the card, each sharded epoch beside the gathered
    compute of the same rows; N6 in four Gloo processes started first and read last (killed if a part fails)."""
    import shutil

    started = _start_n6()
    try:
        out = _run_path_n_card(device, a_batches, path_c, path_e, path_f)
    except BaseException:
        for proc in started["procs"]:
            proc.kill()
            proc.wait()
        shutil.rmtree(started["tmp"], ignore_errors=True)
        raise
    out["N6"] = _finish_n6(started)
    return out


def _run_path_n_card(device, a_batches, path_c, path_e, path_f):
    """N1-N5 and N7 on the card."""
    import torch

    import metrics_tpu_torch as pt
    from metrics_tpu_torch.observability import counters
    from metrics_tpu_torch.parallel import batch_sharded, class_sharded, hierarchical_mesh, row_sharded

    out = {}
    t0 = time.perf_counter()
    # N1: path C's epoch, placed with row_sharded(), beside path C's gathered capacity-mode collection
    c_batches = _to(device, path_c["host"])
    gathered = path_c["runs"]["capacity"]["collection"]
    sharded = _n_feed(_n_placed(_curve_collection(device, capacity=C_CAPACITY)), c_batches)
    out["N1"] = {"gathered": _n_epoch(gathered, device, False), "sharded": _n_epoch(sharded, device, True),
                 "path_c_epoch": path_c["runs"]["capacity"]["epoch"], "host": path_c["host"]}
    sharded.reset()  # N7: the placement is applied again to the fresh buffers
    _n_feed(sharded, c_batches[:1])
    out["N7_reset"] = {"capacity": sharded["AUROC"].preds.capacity, "owns": sharded["AUROC"]._states_own_sync(),
                       "placement": type(sharded["AUROC"]._placement).__name__}
    del sharded
    out["N1"]["s"] = time.perf_counter() - t0

    # N2: 1,000-class AUROC and AP (macro) over path A's 20 steps, gathered and on the ring
    t0 = time.perf_counter()

    def n2(**kw):
        return pt.MetricCollection([pt.AUROC(num_classes=A_CLASSES, average="macro", device=device, **kw),
                                    pt.AveragePrecision(num_classes=A_CLASSES, device=device, **kw)])

    gathered = _n_feed(n2(capacity=N2_CAPACITY), a_batches)
    out["N2"] = {"gathered": _n_epoch(gathered, device, False)}
    del gathered
    sharded = _n_feed(_n_placed(n2(capacity=N2_CAPACITY)), a_batches)
    out["N2"]["sharded"] = _n_epoch(sharded, device, True)
    del sharded
    absent = pt.AUROC(num_classes=4, average=None, device=device, capacity=1_024)
    absent.device_put(row_sharded())
    gen = torch.Generator(device=device).manual_seed(15)
    absent.update(torch.softmax(torch.randn(512, 4, generator=gen, device=device), 1),
                  torch.randint(0, 3, (512,), generator=gen, device=device))  # class 3 never occurs
    with _NoGather():
        out["N2"]["absent"] = [float(x) for x in absent.compute()]
    out["N2"]["s"] = time.perf_counter() - t0

    # N3: ROC and PrecisionRecallCurve of path C's first batch through the curve engine
    t0 = time.perf_counter()
    curves = _n_feed(_n_placed(pt.MetricCollection([pt.ROC(pos_label=1, device=device, capacity=C_N),
                                                    pt.PrecisionRecallCurve(pos_label=1, device=device,
                                                                            capacity=C_N)])), c_batches[:1])
    n3 = _n_epoch(curves, device, True)
    n3["values"] = {k: tuple(x.cpu().numpy() for x in v) for k, v in n3["values"].items()}
    out["N3"] = n3
    del curves
    out["N3"]["s"] = time.perf_counter() - t0

    # N4: E3's Spearman and Kendall epochs on the ring
    t0 = time.perf_counter()
    out["N4"] = {}
    for kind, cls, (steps, n), seed in (("Spearman", pt.SpearmanCorrcoef, E3_SPEARMAN, 9),
                                        ("Kendall", pt.KendallRankCorrCoef, E3_KENDALL, 10)):
        run = path_e["E3"][f"{kind} capacity"]
        col = _n_feed(_n_placed(pt.MetricCollection([cls(device=device, capacity=steps * n)])),
                      _to(device, run["host"]))
        out["N4"][kind] = {"gathered": _n_epoch(run["collection"], device, False),
                           "sharded": _n_epoch(col, device, True), "host": run["host"],
                           "path_e_epoch": run["epoch"]}
    out["N4"]["s"] = time.perf_counter() - t0

    # N5: path F's retrieval epoch through the regroup, beside path F's gathered capacity-mode collection
    t0 = time.perf_counter()
    f_run = path_f["runs"]["capacity"]
    sharded = _n_feed(_n_placed(_f_collection(device, capacity=F_CAPACITY)), _to(device, path_f["host"]))
    out["N5"] = {"gathered": _n_epoch(f_run["collection"], device, False), "sharded": _n_epoch(sharded, device, True),
                 "path_f_epoch": f_run["epoch"]}
    del sharded
    skew = pt.RetrievalMRR(device=device, capacity=N5_SKEW_ROWS)
    skew.regroup_capacity = N5_SKEW_BUCKET
    skew.device_put(row_sharded())
    skew.update(torch.zeros(N5_SKEW_ROWS, dtype=torch.int64, device=device),
                torch.rand(N5_SKEW_ROWS, generator=gen, device=device),
                torch.ones(N5_SKEW_ROWS, dtype=torch.int64, device=device))
    try:
        with _NoGather():
            skew.compute()
        out["N5"]["skew"] = "no error"
    except RuntimeError as err:
        out["N5"]["skew"] = str(err)
    out["N5"]["s"] = time.perf_counter() - t0

    # N7: device_put of a device on a CPU-built collection, batch_sharded on one rank, class_sharded on a
    # one-rank hierarchy (path A's collection: counts bit-equal to the unplaced one)
    t0 = time.perf_counter()
    moved = _curve_collection("cpu", capacity=C_N)
    moved.device_put(device)
    place = batch_sharded(device=device)
    for batch in c_batches[:1]:
        moved.update(*place(batch))
    out["N7"] = {"moved_device": str(moved["AUROC"].preds.data.device), "target": str(moved["AUROC"].device),
                 "moved": moved.compute(),
                 "batch_equal": all(torch.equal(a, b) for a, b in zip(place(c_batches[0]), c_batches[0]))}
    h = hierarchical_mesh(slices=1)
    placed, plain = _main_collection(device), _main_collection(device)
    placed.device_put(class_sharded(h))
    counters.reset()
    counters.enable()
    try:
        for batch in a_batches[:2]:
            placed.update(*batch)
            plain.update(*batch)
        synced = {k: placed[k]._synced_state() for k in placed}
    finally:
        calls = dict(counters.snapshot()["calls_by_kind"])
        counters.disable()
    want = {k: plain[k]._synced_state() for k in plain}
    out["N7"]["class_counts_equal"] = all(torch.equal(synced[k][n], want[k][n]) for k in synced for n in synced[k])
    out["N7"]["class_calls"] = calls
    out["N7"]["class_values"] = (placed.compute(), plain.compute())
    out["N7"]["s"] = time.perf_counter() - t0
    return out


def _n6_data():
    """N6's global rows, the same in each of its processes and here: tied binary scores, 16-class
    probabilities, a tied pair for the rank metrics, retrieval rows over 2,048 query ids, and path A's
    collection's batches at 1,000 classes."""
    import torch

    rng = np.random.RandomState(615)
    d = {"p": np.round(rng.rand(N6_N), 2).astype(np.float32), "t": (rng.rand(N6_N) < 0.3).astype(np.int64)}
    d["pm"] = torch.softmax(torch.from_numpy(rng.randn(N6_N, N6_CLASSES).astype(np.float32)), 1).numpy()
    d["tm"] = rng.randint(0, N6_CLASSES, N6_N).astype(np.int64)
    d["x"] = np.round(rng.rand(N6_N), 3).astype(np.float32)
    d["y"] = np.round(d["x"] + 0.5 * rng.randn(N6_N), 3).astype(np.float32)
    d["idx"] = rng.randint(0, N6_QUERIES, N6_N).astype(np.int64)
    d["rp"] = rng.rand(N6_N).astype(np.float32)
    d["rt"] = (rng.rand(N6_N) < 0.2).astype(np.int64)
    d["a"] = [(torch.softmax(torch.from_numpy(rng.randn(N6_A_BATCH, A_CLASSES).astype(np.float32)), 1).numpy(),
               rng.randint(0, A_CLASSES, N6_A_BATCH)) for _ in range(N6_A_STEPS)]
    return d


def _n6_worker(rank, port, out):
    """One of N6's four Gloo processes: the ring (3 hops flat, 1 two-level) for binary and per-class AUROC / AP,
    the curve, Spearman and Kendall; the regroup (4 destinations, two stages two-level) for RetrievalMAP / MRR;
    ``class_sharded`` over 2 x 2 for path A's collection; each with the counters it records."""
    import torch
    import torch.distributed as dist

    import metrics_tpu_torch as pt
    from metrics_tpu_torch.observability import counters
    from metrics_tpu_torch.parallel import batch_sharded, class_sharded
    from metrics_tpu_torch.parallel import sharded_epoch as se

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=N6_WORLD, rank=rank)
    try:
        h = pt.parallel.hierarchical_mesh(slices=N6_SLICES)
        d = _n6_data()
        m = N6_N // N6_WORLD
        b = {k: torch.from_numpy(v[rank * m:(rank + 1) * m]) for k, v in d.items() if k != "a"}
        res = {"grid": [list(g) for g in h.grid]}

        def run(name, fn):
            counters.reset()
            counters.enable()
            t0 = time.perf_counter()
            try:
                value = fn()
            finally:
                snap = counters.snapshot()
                counters.disable()
            host = [x.tolist() for x in value] if isinstance(value, tuple) else value.tolist()
            res[name] = {"value": host, "ms": (time.perf_counter() - t0) * 1e3,
                         "calls": dict(snap["calls_by_kind"]), "crossings": dict(snap["calls_by_crossing"])}

        onehot = (b["tm"][:, None] == torch.arange(N6_CLASSES)).to(torch.int32)
        k = N6_KENDALL // N6_WORLD
        for tag, g in (("flat", None), ("hier", h)):
            run(f"{tag}/auroc", lambda: se.sharded_auroc(b["p"], b["t"], g))
            run(f"{tag}/ap", lambda: se.sharded_average_precision(b["p"], b["t"], g))
            run(f"{tag}/auroc_classes", lambda: se.sharded_auroc_matrix(b["pm"], onehot, g))
            run(f"{tag}/ap_classes", lambda: se.sharded_average_precision_matrix(b["pm"], onehot, g))
            run(f"{tag}/curve", lambda: se.sharded_clf_curve_matrix(b["p"][None, :], b["t"].float()[None, :],
                                                                    torch.ones(1, m), g))
            run(f"{tag}/spearman", lambda: se.sharded_spearman(b["x"], b["y"], g))
            kx = torch.from_numpy(d["x"][rank * k:(rank + 1) * k])
            ky = torch.from_numpy(d["y"][rank * k:(rank + 1) * k])
            run(f"{tag}/kendall", lambda: se.sharded_kendall(kx, ky, g))
            for name, make in (("map", lambda: pt.RetrievalMAP(device="cpu")),
                               ("mrr", lambda: pt.RetrievalMRR(device="cpu"))):
                run(f"{tag}/{name}", lambda: se.sharded_retrieval_sums(make(), b["idx"], b["rp"], b["rt"], g))
        col = _main_collection("cpu")
        col.device_put(class_sharded(h))
        place = batch_sharded(h.dcn)
        counters.reset()
        counters.enable()
        for preds, target in d["a"]:
            col.update(*place((torch.from_numpy(preds), torch.from_numpy(target))))
        synced = {name: {n: v.tolist() for n, v in col[name]._synced_state().items()} for name in col}
        values = {name: float(v) for name, v in col.compute().items()}
        snap = counters.snapshot()
        counters.disable()
        res["class"] = {"synced": synced, "values": values, "calls": dict(snap["calls_by_kind"]),
                        "bytes": dict(snap["bytes_by_crossing"])}
        with open(out, "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def _start_n6():
    """N6's four Gloo processes of this script (``--n6-worker``), started now, on the CPU."""
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(__file__)), prefix="_n6_")
    outs = [os.path.join(tmp, f"n6_{r}.json") for r in range(N6_WORLD)]
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--n6-worker", str(r), str(port), outs[r]],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(N6_WORLD)]
    return {"procs": procs, "outs": outs, "tmp": tmp, "t0": time.perf_counter()}


def _finish_n6(started):
    """Wait for N6's processes (killed if they outlive their timeout) and read their results."""
    import shutil

    procs = started["procs"]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    try:
        if [p.returncode for p in procs] != [0] * N6_WORLD:
            raise AssertionError(f"N6 workers failed: {[p.returncode for p in procs]} {logs}")
        results = []
        for path in started["outs"]:
            with open(path) as f:
                results.append(json.load(f))
    finally:
        shutil.rmtree(started["tmp"], ignore_errors=True)
    return {"ranks": results, "s": time.perf_counter() - started["t0"]}


def _n_line(label, part):
    return (f"{label}: epoch compute {part['ms'][0]:.2f} / {part['ms'][1]:.2f} ms, peak {part['peak_bytes']} B above"
            f" the state, collectives {part['calls']}, synchronizing calls {part['syncs']} {part['sync_sites']}")


def _n_values(values):
    return {k: (float(v) if not isinstance(v, (list, tuple)) else [float(x) for x in v]) for k, v in values.items()}


def _n_class_oracle(a_batches):
    """Per-class AUROC and AP of path A's epoch in float64 numpy (path C's rank and step-integral oracle a class)."""
    p = np.concatenate([b[0].cpu().numpy() for b in a_batches]).astype(np.float64)
    t = np.concatenate([b[1].cpu().numpy() for b in a_batches])
    auroc, ap = [], []
    for c in range(p.shape[1]):
        a_c, p_c, _, _, _ = _curve_oracle(p[:, c], (t == c).astype(np.float64))
        auroc.append(a_c)
        ap.append(p_c)
    return float(np.mean(auroc)), np.array(ap)


def check_path_n(result, a_batches):
    """Each sharded epoch against its gathered compute and a float64 oracle; no gather, no fallback; N6's ranks
    against one process's unsharded port and the collectives against the port's formula."""
    import scipy.stats

    import metrics_tpu_torch as pt
    from metrics_tpu_torch.utils.prints import _WARN_ONCE_SEEN

    timings = {}
    fallbacks = [m for m in _WARN_ONCE_SEEN if "fall back to the gathered" in m]
    _check(not fallbacks, f"path N: no gather fallback warned ({fallbacks})")

    n1 = result["N1"]
    auroc, ap, _, _, _ = _curve_oracle(np.concatenate([s for s, _ in n1["host"]]),
                                       np.concatenate([t for _, t in n1["host"]]))
    s, g = _n_values(n1["sharded"]["values"]), _n_values(n1["gathered"]["values"])
    for k, want in (("AUROC", auroc), ("AveragePrecision", ap)):
        _check(np.isclose(s[k], want, rtol=RTOL_N, atol=0) and np.isclose(s[k], g[k], rtol=RTOL_N, atol=0)
               and np.isclose(s[k], float(n1["path_c_epoch"][k]), rtol=RTOL_N, atol=0),
               f"path N1 {k} on the ring = {s[k]:.7f}: the gathered {g[k]:.7f} and the oracle {want:.7f} (rtol {RTOL_N})")
    calls = n1["sharded"]["calls"]
    _check(all(n1["sharded"]["owns_sync"]) and not {"all_gather", "coalesced_gather"} & set(calls),
           f"path N1: both members own their sync; 0 gather collectives ({calls}); no call into the gather functions")
    print(f"[17] path N1 (path C's epoch, {C_STEPS * C_N} rows, capacity {C_CAPACITY}):")
    print("    " + _n_line("gathered", n1["gathered"]))
    print("    " + _n_line("row-sharded", n1["sharded"]))
    timings["N1"] = {k: {x: n1[k][x] for x in ("ms", "peak_bytes", "calls", "syncs")} for k in ("gathered", "sharded")}

    n2 = result["N2"]
    macro, ap_classes = _n_class_oracle(a_batches)
    s, g = _n_values(n2["sharded"]["values"]), _n_values(n2["gathered"]["values"])
    _check(np.isclose(s["AUROC"], macro, rtol=RTOL_N, atol=0) and np.isclose(s["AUROC"], g["AUROC"], rtol=RTOL_N,
                                                                                   atol=0),
           f"path N2 macro AUROC over {A_CLASSES} classes = {s['AUROC']:.7f}: gathered {g['AUROC']:.7f}, oracle {macro:.7f}")
    _check(np.allclose(s["AveragePrecision"], ap_classes, rtol=RTOL_N, atol=0)
           and np.allclose(s["AveragePrecision"], g["AveragePrecision"], rtol=RTOL_N, atol=0),
           f"path N2 AP of each of the {A_CLASSES} classes within rtol {RTOL_N} of the gathered compute and the oracle")
    absent = n2["absent"]
    _check(np.isnan(absent[3]) and not np.isnan(absent[:3]).any(), f"path N2: an absent class gives nan ({absent})")
    print("    " + _n_line("N2 gathered", n2["gathered"]))
    print("    " + _n_line("N2 row-sharded", n2["sharded"]))
    timings["N2"] = {k: {x: n2[k][x] for x in ("ms", "peak_bytes", "calls", "syncs")} for k in ("gathered", "sharded")}

    n3 = result["N3"]
    scores0, target0 = n1["host"][0]
    _, _, thr0, fpr0, tpr0 = _curve_oracle(scores0, target0)
    fpr, tpr, thr, count = n3["values"]["ROC"]
    c = int(count)
    _check(c == len(thr0) + 1 and np.array_equal(thr[1:c], thr0.astype(np.float32)) and thr[0] == thr0[0] + 1,
           f"path N3 ROC on the ring: exactly the oracle's {len(thr0)} distinct thresholds (max + 1 first)")
    _check(np.allclose(fpr[:c], fpr0, rtol=RTOL_CURVE, atol=0) and np.allclose(tpr[:c], tpr0, rtol=RTOL_CURVE, atol=0),
           f"path N3 ROC: fpr / tpr within rtol {RTOL_CURVE} of the oracle")
    precision, recall, thp, count = n3["values"]["PrecisionRecallCurve"]
    c = int(count)
    o_p, o_r, o_t = _n_prc_oracle(scores0, target0)
    _check(c == len(o_t) and np.array_equal(thp[:c], o_t.astype(np.float32))
           and np.allclose(precision[:c + 1], o_p, rtol=RTOL_CURVE, atol=0)
           and np.allclose(recall[:c + 1], o_r, rtol=RTOL_CURVE, atol=0),
           f"path N3 PrecisionRecallCurve: {c} thresholds, precision / recall within rtol {RTOL_CURVE} of the oracle")
    print("    " + _n_line("N3 ROC + PRC", n3))
    timings["N3"] = {x: n3[x] for x in ("ms", "peak_bytes", "calls", "syncs")}

    timings["N4"] = {}
    for kind, fn, rtol in (("Spearman", scipy.stats.spearmanr, RTOL_E), ("Kendall", scipy.stats.kendalltau,
                                                                          RTOL_KENDALL)):
        run = result["N4"][kind]
        key = next(iter(run["sharded"]["values"]))
        got = float(run["sharded"]["values"][key])
        p = np.concatenate([x for x, _ in run["host"]])
        t = np.concatenate([y for _, y in run["host"]])
        want = fn(p, t).statistic
        gathered = float(run["path_e_epoch"][key])
        _check(np.isclose(got, gathered, rtol=rtol, atol=0) and np.isclose(got, want, rtol=rtol, atol=0),
               f"path N4 {kind} on the ring over {len(p)} rows = {got:.7g}: E3's gathered {gathered:.7g},"
               f" scipy {want:.7g} (rtol {rtol})")
        print("    " + _n_line(f"N4 {kind} gathered", run["gathered"]))
        print("    " + _n_line(f"N4 {kind} row-sharded", run["sharded"]))
        timings["N4"][kind] = {k: {x: run[k][x] for x in ("ms", "peak_bytes", "calls", "syncs")}
                               for k in ("gathered", "sharded")}

    n5 = result["N5"]
    s, f = _n_values(n5["sharded"]["values"]), _n_values(n5["path_f_epoch"])
    worst = max(abs(s[k] - f[k]) / max(abs(f[k]), 1e-30) for k in f)
    _check(all(np.isclose(s[k], f[k], rtol=RTOL_F, atol=0) for k in f),
           f"path N5: the eight retrieval values through the regroup equal path F's gathered epoch (rtol {RTOL_F};"
           f" max rel diff {worst:.3g})")
    calls = n5["sharded"]["calls"]
    _check(calls.get("all_to_all") == 4 * 8 and not {"all_gather", "coalesced_gather"} & set(calls),
           f"path N5: one all_to_all a payload, 4 a member, 32 in all; no gather ({calls}); 0 rows dropped")
    _check("regroup_capacity" in n5["skew"], f"path N5: the skewed run raised: {n5['skew'][:90]}")
    print("    " + _n_line("N5 gathered", n5["gathered"]))
    print("    " + _n_line("N5 row-sharded", n5["sharded"]))
    timings["N5"] = {k: {x: n5[k][x] for x in ("ms", "peak_bytes", "calls", "syncs")} for k in ("gathered", "sharded")}

    n7 = result["N7"]
    moved = _n_values(n7["moved"])
    auroc0, ap0, _, _, _ = _curve_oracle(scores0, target0)
    _check(n7["moved_device"] == n7["target"] != "cpu" and np.isclose(moved["AUROC"], auroc0, rtol=RTOL_ORACLE, atol=0)
           and np.isclose(moved["AveragePrecision"], ap0, rtol=RTOL_ORACLE, atol=0) and n7["batch_equal"],
           f"path N7: device_put(cuda) moved a CPU-built collection ({n7['moved_device']}); batch_sharded on one rank"
           " keeps the batch")
    _check(result["N7_reset"]["capacity"] == C_CAPACITY and result["N7_reset"]["owns"],
           f"path N7: after reset() the {result['N7_reset']['placement']} placement holds (capacity"
           f" {result['N7_reset']['capacity']}, the ring owns the sync)")
    placed, plain = (_n_values(v) for v in n7["class_values"])
    _check(n7["class_counts_equal"] and all(np.isclose(placed[k], plain[k], rtol=RTOL_CLASS, atol=0) for k in plain),
           f"path N7: class_sharded on a one-rank hierarchy: synced counts bit-equal, values equal ({n7['class_calls']})")

    n6 = result["N6"]
    d = _n6_data()
    ref = {}
    for name, make, args in (
            ("auroc", lambda: pt.AUROC(pos_label=1, device="cpu"), ("p", "t")),
            ("ap", lambda: pt.AveragePrecision(pos_label=1, device="cpu"), ("p", "t")),
            ("auroc_classes", lambda: pt.AUROC(num_classes=N6_CLASSES, average=None, device="cpu"), ("pm", "tm")),
            ("ap_classes", lambda: pt.AveragePrecision(num_classes=N6_CLASSES, device="cpu"), ("pm", "tm")),
            ("spearman", lambda: pt.SpearmanCorrcoef(device="cpu"), ("x", "y")),
            ("map", lambda: pt.RetrievalMAP(device="cpu"), ("idx", "rp", "rt")),
            ("mrr", lambda: pt.RetrievalMRR(device="cpu"), ("idx", "rp", "rt"))):
        metric = make()
        metric.update(*(_torch_of(d[a]) for a in args))
        value = metric.compute()
        ref[name] = [float(x) for x in value] if isinstance(value, list) else float(value)
    kendall = pt.KendallRankCorrCoef(device="cpu")
    kendall.update(_torch_of(d["x"][:N6_KENDALL]), _torch_of(d["y"][:N6_KENDALL]))
    ref["kendall"] = float(kendall.compute())
    roc = pt.ROC(pos_label=1, device="cpu")
    roc.update(_torch_of(d["p"]), _torch_of(d["t"]))
    ref_fpr, ref_tpr, ref_thr = (x.numpy() for x in roc.compute())
    worst = 0.0
    for r, res in enumerate(n6["ranks"]):
        for tag in ("flat", "hier"):
            for name, want in ref.items():
                got = np.asarray(res[f"{tag}/{name}"]["value"], dtype=np.float64)
                got = got[0] if name in ("map", "mrr") else got
                if not np.allclose(got, want, rtol=RTOL_N6, atol=0):
                    raise AssertionError(f"path N6 rank {r} {tag} {name}: {got} vs the unsharded port {want}")
                worst = max(worst, float(np.max(np.abs(got - np.asarray(want)) / np.abs(np.asarray(want)))))
            fps, tps, thr, counts = (np.asarray(x) for x in res[f"{tag}/curve"]["value"])
            k = int(counts[0])
            if not (k == len(ref_thr) - 1 and np.array_equal(thr[0, :k], ref_thr[1:])
                    and np.allclose(fps[0, :k] / fps[0, k - 1], ref_fpr[1:], rtol=RTOL_N6, atol=0)
                    and np.allclose(tps[0, :k] / tps[0, k - 1], ref_tpr[1:], rtol=RTOL_N6, atol=0)):
                raise AssertionError(f"path N6 rank {r} {tag}: the curve's {k} points differ from the unsharded ROC's")
            hops = N6_WORLD - 1 if tag == "flat" else N6_WORLD // N6_SLICES - 1
            calls = res[f"{tag}/auroc"]["calls"]
            want_calls = {"ppermute": hops, "psum": 1} if tag == "flat" else {"all_gather": 1, "ppermute": hops,
                                                                                  "psum": 2}
            if calls != want_calls or res[f"{tag}/mrr"]["calls"].get("all_to_all") != (4 if tag == "flat" else 8):
                raise AssertionError(f"path N6 rank {r} {tag}: collectives {calls}, regroup"
                                     f" {res[f'{tag}/mrr']['calls']}, not the port's formula")
    print(f"  ok: path N6, {N6_WORLD} Gloo processes ({n6['s']:.1f} s): every ring, curve and regroup value of every"
          f" rank, flat and 2 x 2, within rtol {RTOL_N6} of one process's unsharded port (max rel diff {worst:.3g});"
          f" a flat ring {N6_WORLD - 1} ppermute + 1 psum, two-level 1 all_gather + 1 ppermute + 2 psum; a regroup"
          " 4 all_to_all flat, 8 two-level")
    plain = _main_collection("cpu")
    for preds, target in d["a"]:
        plain.update(_torch_of(preds), _torch_of(target))
    # one process fed every row: its local counts are the epoch's
    want_synced = {name: {n: getattr(plain[name], n).tolist() for n in plain[name]._defaults} for name in plain}
    want_values = {k: float(v) for k, v in plain.compute().items()}
    for r, res in enumerate(n6["ranks"]):
        cls = res["class"]
        if cls["synced"] != want_synced or not all(np.isclose(cls["values"][k], want_values[k], rtol=RTOL_N6, atol=0)
                                                   for k in want_values):
            raise AssertionError(f"path N6 rank {r}: class_sharded counts or values differ from the unsharded run")
    print(f"  ok: path N6 class_sharded over 2 x 2 on every rank: the synced int64 counts of path A's collection"
          f" ({N6_A_STEPS} x {N6_A_BATCH} x {A_CLASSES}) bit-equal to one process's unsharded collection, values within"
          f" rtol {RTOL_N6} ({n6['ranks'][0]['class']['calls']})")
    timings["N6"] = {"s": n6["s"], "ring_ms": {tag: n6["ranks"][0][f"{tag}/auroc"]["ms"] for tag in ("flat", "hier")},
                     "regroup_ms": {tag: n6["ranks"][0][f"{tag}/mrr"]["ms"] for tag in ("flat", "hier")},
                     "class_bytes": n6["ranks"][0]["class"]["bytes"]}
    print(f"    path N: N1 {result['N1']['s']:.1f} s, N2 {result['N2']['s']:.1f} s, N3 {result['N3']['s']:.1f} s,"
          f" N4 {result['N4']['s']:.1f} s, N5 {result['N5']['s']:.1f} s, N7 {result['N7']['s']:.1f} s on the card;"
          f" N6 {n6['s']:.1f} s in its processes; N6 ring / regroup ms (rank 0) {timings['N6']['ring_ms']} /"
          f" {timings['N6']['regroup_ms']}")
    return timings


# --------------------------------------------------------------------------- path O: observability
O_B_STEPS = 4  # O2: path B's first steps under the profiler
O4_STEPS = 6  # O4: W1's first steps under the lifecycle ledger
O_LABEL = "path-o/W1"  # O4's lifecycle_label
# the keys of the JAX package's counters snapshot (metrics_tpu/observability/counters.py snapshot()), which the
# port's must carry, written out here: this script imports nothing of the JAX package
O_SNAPSHOT_KEYS = (
    "bytes_by_crossing", "bytes_by_kind_dtype", "calls_by_crossing", "calls_by_kind", "collective_calls", "deferred",
    "deferred_depth", "evicted_mass_dropped", "faults", "fleet_shards", "fused_step_cache", "gather_skips",
    "group_cache", "heavy_hitters", "ingest_program_cache", "launch_cache", "lifecycle", "publish_staleness",
    "retention", "selfmeter", "service_health", "slab_dropped_samples", "slab_slots", "sparse", "state_bytes",
    "states_synced", "step_cache", "sync_bytes", "watermark_agreement", "watermark_lag", "wm_exchange_calls",
    "wm_stragglers",
)
O_UPDATE_PHASES = ("collection.group_update", "metric.update", "metric.forward")  # where a step's K1 launches land
# the device-track scopes K1's kernels may lie in: the track gives a kernel to its innermost scope, and a fused
# forward's update runs inside metric.forward_update
O_UPDATE_SCOPES = (*O_UPDATE_PHASES, "metric.forward_update")
# the port's own step spans: no fence of their own (a step's root, the host-only lockstep walk, and the batch delta
# that the enclosing metric.forward fences)
O_UNFENCED = ("collection.forward", "collection.lockstep", "metric.forward_update")
O1_ORDER = ("off", "spans", "fenced", "fenced", "spans", "off")


def _o_phase_counts(collection, steps):
    """The span counts path A's collection records over ``steps`` forwards and one epoch ``compute()``: per step one
    ``collection.group_update`` a shared compute group, one ``collection.step_sync`` a packed sync
    (``MetricCollection._step_sync_packs``), one ``metric.forward`` a singleton group, one ``metric.sync_state`` a
    member outside every pack, one ``metric.compute`` a member; at the epoch one ``collection.host_sync`` a shared
    group, the singletons' own sync and every member's compute. The port's own: one ``collection.forward`` a step, a
    ``collection.lockstep`` check and record a step and the epoch sync's check, one ``metric.forward_update`` a step a
    singleton on the fused forward."""
    groups = list(collection.compute_groups.values())
    shared = sum(1 for g in groups if len(g) > 1)
    singles = sum(1 for g in groups if len(g) == 1)
    fused = sum(1 for g in groups if len(g) == 1 and collection[g[0]]._fusable)
    members = sum(len(g) for g in groups)
    packs = collection._step_sync_packs(collection._eager_shared_groups())
    alone = members - sum(len(p) for p in packs)
    counts = {"collection.group_update": steps * shared, "collection.step_sync": steps * len(packs),
              "metric.forward": steps * singles, "metric.sync_state": steps * alone + singles,
              "metric.compute": (steps + 1) * members, "collection.host_sync": shared, "collection.compute": 1,
              "collection.forward": steps, "collection.lockstep": 2 * steps + 1, "metric.forward_update": steps * fused}
    return {name: n for name, n in counts.items() if n}


def _o_leg(device, a_batches, leg, trace_dir):
    """One O1 leg: path A's collection over every batch and an epoch ``compute()`` with observability ``leg``."""
    import metrics_tpu_torch.observability as obs
    from metrics_tpu_torch.ops.binned import binned_counts_cuda

    step_reduces = _packed_step_reduces(_main_collection(device, dist_sync_on_step=True))
    obs.disable()
    obs.reset()
    if leg == "spans":
        obs.enable()
    elif leg == "fenced":
        obs.enable(device_time=True)
    try:
        col = _main_collection(device, dist_sync_on_step=True)
        binned_counts_cuda.launches = 0
        with _CountCollectives() as step_calls:
            values, ms = _run_steps(col, a_batches)
        launches = binned_counts_cuda.launches
        with _CountCollectives() as epoch_calls:
            epoch = col.compute()
        _sync(device)
        out = {"values": values, "epoch": epoch, "ms": ms, "launches": launches, "step_calls": dict(step_calls),
               "step_reduces": step_reduces,
               "epoch_calls": dict(epoch_calls), "want_spans": _o_phase_counts(col, len(a_batches)),
               "groups": {rep: list(m) for rep, m in col.compute_groups.items()}}
        if leg != "off":
            records = obs.records()
            path = os.path.join(trace_dir, f"o1_{leg}.json")
            obs.write_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
            out.update(spans=dict(Counter(r.name for r in records)), n_records=len(records),
                       chrome_x=sum(1 for e in doc["traceEvents"] if e["ph"] == "X"), summary=obs.summarize(records),
                       table=obs.device_time_table(records), snapshot=obs.counters_snapshot())
        else:
            out.update(n_records=len(obs.records()), snapshot=obs.counters_snapshot())
        return out
    finally:
        obs.disable()
        obs.reset()


def _o3_worker(out):
    """O3, a child process with the build directory warm: compile telemetry over one path-B step, run twice."""
    import torch

    import metrics_tpu_torch.observability as obs

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(18)
    target = torch.rand(B_N, generator=gen, device=dev) < 0.3
    batch = (torch.sigmoid(torch.randn(B_N, generator=gen, device=dev) + 1.5 * target), target.to(torch.int64))
    col = _binned_collection(dev)
    obs.enable(compile_events=True)
    spans = []
    for step in range(2):
        col(*batch)
        torch.cuda.synchronize()
        spans.append([[r.name, r.attrs] for r in obs.records() if r.name in O_UPDATE_PHASES])
        obs.trace.clear()
    result = {"spans": spans, "compile": obs.compile_snapshot()}
    obs.disable()
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


def _start_o3():
    """O3's child process (``--o3-worker``), started now; K1 is built already, so its load is a cache hit."""
    import tempfile

    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(__file__)), prefix="_o3_")
    out = os.path.join(tmp, "o3.json")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--o3-worker", out],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return {"proc": proc, "out": out, "tmp": tmp, "t0": time.perf_counter()}


def _finish_o3(started):
    import shutil

    proc = started["proc"]
    try:
        log = proc.communicate(timeout=300)[0]
    finally:
        proc.kill()
    try:
        if proc.returncode != 0:
            raise AssertionError(f"O3 worker failed ({proc.returncode}): {log}")
        with open(started["out"]) as f:
            result = json.load(f)
    finally:
        shutil.rmtree(started["tmp"], ignore_errors=True)
    result["s"] = time.perf_counter() - started["t0"]
    return result


def _o_kernel_scopes(trace_path):
    """From a ``torch.profiler`` Chrome trace: the device-track update scopes and K1's kernels, each kernel with the
    update scope it lies in (``None`` outside every one)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    scopes = [e for e in events if e.get("ph") == "X" and e.get("cat") == "gpu_user_annotation"
              and e.get("name") in O_UPDATE_SCOPES]
    kernels = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
                      and "count_kernel" in e.get("name", "")), key=lambda e: e["ts"])
    inside = []
    for k in kernels:
        owner = [s["name"] for s in scopes if s["ts"] <= k["ts"] and k["ts"] + k["dur"] <= s["ts"] + s["dur"] + 1.0]
        inside.append(owner[0] if owner else None)
    return {"scopes": Counter(s["name"] for s in scopes), "kernels": len(kernels), "inside": inside}


def run_path_o(device, a_batches, b_batches):
    """Path O inside the caller's process group: O1 path A under the planes (off, spans and counters, fenced), O2
    path B's first steps under the profiler, O3 the compile telemetry child, O4 the lifecycle ledger and the deferred
    epoch. Returns what ``check_path_o`` holds."""
    import tempfile
    import shutil

    import torch

    import metrics_tpu_torch as pt
    import metrics_tpu_torch.observability as obs
    from metrics_tpu_torch.ops.binned import binned_counts_cuda

    o3 = _start_o3() if device.type == "cuda" else None
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(__file__)), prefix="_o_")
    out = {}
    try:
        # O1: the three legs in turns, forward then backward, so a drift of the host's speed in the call falls on
        # each leg alike
        t0 = time.perf_counter()
        out["O1"] = {"runs": [(leg, _o_leg(device, a_batches, leg, tmp)) for leg in O1_ORDER]}
        out["O1"]["s"] = time.perf_counter() - t0

        # O2: path B's first steps, fenced, under a torch.profiler session
        t0 = time.perf_counter()
        steps = b_batches[:O_B_STEPS]
        col = _binned_collection(device, dist_sync_on_step=True)
        plain = _binned_collection(device, dist_sync_on_step=True)
        plain_values, _ = _run_steps(plain, steps)
        obs.disable()
        obs.reset()
        obs.enable(device_time=True)
        step_launches = []
        prof_dir = os.path.join(tmp, "prof")
        try:
            binned_counts_cuda.launches = 0
            obs.start_trace(prof_dir)
            try:
                values, ms = _run_steps(col, steps, on_step=lambda i: step_launches.append(binned_counts_cuda.launches))
            finally:
                trace_path = obs.stop_trace()
            launches = binned_counts_cuda.launches
            records = obs.records()
            table = obs.device_time_table(records)
            update_device_ms = [r.attrs["device_ms"] for r in records if r.name in O_UPDATE_PHASES]
            profiled = obs.devtime.from_profiler_trace(prof_dir)
        finally:
            obs.disable()
            obs.reset()
        states_equal = all(torch.equal(getattr(col[k], n), getattr(plain[k], n)) for k in col for n in col[k]._defaults)
        out["O2"] = {"values": values, "plain_values": plain_values, "ms": ms, "launches": launches,
                     "step_launches": step_launches, "table": table, "update_device_ms": update_device_ms,
                     "groups": {rep: list(m) for rep, m in col.compute_groups.items()},
                     "profiled": profiled, "states_equal": states_equal, "cuda": device.type == "cuda",
                     "scopes": _o_kernel_scopes(trace_path) if device.type == "cuda" else None,
                     "s": time.perf_counter() - t0}
        del col, plain

        # O4: W1's ring under the ledger, the publish stages stamped as a serving loop would, and the deferred epoch
        t0 = time.perf_counter()
        data = _k_events(61, O4_STEPS, W1_ADVANCE, (0.05, (0.0, 150.0)), (0.005, (250.0, 400.0)))
        to = (lambda x: torch.from_numpy(x).to(device))
        obs.enable()
        try:
            w1 = pt.Windowed(pt.AUROC(approx="sketch", device=device), window_s=W1_WINDOW_S, num_windows=W1_WINDOWS,
                             allowed_lateness_s=W1_LATENESS, dist_sync_on_step=True)
            w1.lifecycle_label = O_LABEL
            for b in data:
                w1(to(b["scores"]), to(b["labels"]), event_time=b["t"])
            opened = obs.LEDGER.ledgers(O_LABEL)
            # a serving loop's publish of every closed window: closed, sync_started, sync_done, published
            closed = [w for w in w1.resident_windows() if (w + 1) * W1_WINDOW_S <= w1._watermark]
            published = {}
            for w in closed:
                obs.lifecycle.stamp(O_LABEL, w, "closed")
                obs.lifecycle.stamp(O_LABEL, w, "sync_started")
                published[w] = float(w1.compute_window(w))
                obs.lifecycle.stamp(O_LABEL, w, "sync_done")
                obs.lifecycle.stamp(O_LABEL, w, "published")
            snap = obs.counters_snapshot()
        finally:
            obs.disable()
            obs.reset()
        routes, *_ = _k_oracle_route([b["t"] for b in data], W1_WINDOW_S, W1_WINDOW_S, W1_WINDOWS, W1_LATENESS)
        touched = sorted({int(w) for rows in routes for window, ok in rows for w in np.unique(window[ok])})

        sync_col = _main_collection(device, dist_sync_on_step=True)
        deferred_col = _main_collection(device, dist_sync_on_step=True)
        deferred_col.deferred_epoch_sync = True
        for batch in a_batches:
            sync_col(*batch)
            deferred_col(*batch)
        with _CountCollectives() as sync_calls:
            sync_epoch = sync_col.compute()
        with _CountCollectives() as deferred_calls:
            deferred_epoch = deferred_col.compute()
        _sync(device)
        out["O4"] = {"opened": opened, "touched": touched, "closed": closed, "published": published,
                     "lifecycle": snap["lifecycle"], "selfmeter": snap["selfmeter"],
                     "staleness": snap["publish_staleness"], "sync_epoch": sync_epoch,
                     "deferred_epoch": deferred_epoch, "sync_calls": dict(sync_calls),
                     "deferred_calls": dict(deferred_calls), "s": time.perf_counter() - t0}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["O3"] = _finish_o3(o3) if o3 is not None else None
    return out


def check_path_o(result, a_values, a_epoch, a_ms, b_values):
    """Path O's checks; returns its timings."""
    import torch

    o1 = result["O1"]
    for leg, run in o1["runs"]:
        for i, (got, want) in enumerate(zip(run["values"], a_values)):
            if set(got) != set(want) or not all(torch.equal(got[k], want[k]) for k in want):
                raise AssertionError(f"path O1 {leg}: step {i} values differ from path A's")
        if not all(torch.equal(run["epoch"][k], a_epoch[k]) for k in a_epoch):
            raise AssertionError(f"path O1 {leg}: epoch values differ from path A's")
        _check(run["launches"] == 0, f"path O1 {leg}: no K1 launch on path A (read {run['launches']})")
        groups = len(run["groups"])
        _check(run["step_calls"]["all_reduce"] == run["step_reduces"] * len(a_values)
               and run["epoch_calls"]["all_reduce"] == groups,
               f"path O1 {leg}: {run['step_reduces']} all_reduce a step, the packed sync's ({run['step_calls']}), and"
               f" one a compute group at the epoch ({run['epoch_calls']})")
    first = {}
    for leg, run in o1["runs"]:
        first.setdefault(leg, run)
    _check(all(run["n_records"] == 0 and run["snapshot"]["collective_calls"] == 0
               for leg, run in o1["runs"] if leg == "off"), "path O1 off: nothing recorded while observability is off")
    print(f"  ok: path O1 per-step values and the epoch bit-equal to path A's in every leg ({', '.join(O1_ORDER)}),"
          f" {len(first['off']['groups'])} compute groups {first['off']['groups']}")
    for leg, run in o1["runs"]:
        if leg == "off":
            continue
        if run["spans"] != run["want_spans"]:
            raise AssertionError(f"path O1 {leg}: span counts {run['spans']}, expected {run['want_spans']}")
        _check(run["chrome_x"] == run["n_records"], f"path O1 {leg}: write_chrome_trace loads with one X event a span"
               f" ({run['chrome_x']})")
        snap = run["snapshot"]
        _check(tuple(sorted(snap)) == O_SNAPSHOT_KEYS, f"path O1 {leg}: counters_snapshot() has the JAX schema's keys")
        groups = len(run["groups"])
        _check(snap["calls_by_kind"].get("psum") == run["step_reduces"] * len(a_values) + groups,
               f"path O1 {leg}: counters count the packed sync's all_reduce a step and one a compute group at the"
               f" epoch ({snap['calls_by_kind']})")
        _check(run["summary"]["metric.sync_state"]["state_bytes"] > 0 and snap["state_bytes"],
               f"path O1 {leg}: summarize() has state_bytes ({run['summary']['metric.sync_state']['state_bytes']})"
               f" and the gauge {snap['state_bytes']}")
    fenced = first["fenced"]
    phases = [row for name, row in fenced["summary"].items()
              if name.startswith(("collection.", "metric.")) and name not in O_UNFENCED]
    _check(all(row["device_ms"] > 0 for row in phases),
           "path O1 fenced: every phase span of summarize() carries device_ms")
    table = fenced["table"]
    for rep, members in fenced["groups"].items():
        cols = {"update", "sync"} if len(members) > 1 else {"forward", "sync"}
        _check(cols <= set(table.get(rep, {})), f"path O1 fenced: device_time_table() row {rep} has {sorted(cols)}"
               f" ({sorted(table.get(rep, {}))})")
    # each leg's median over steps 2-20 of both its runs, and each run's own median
    ms = {leg: statistics.median([x for lg, run in o1["runs"] if lg == leg for x in run["ms"][1:]])
          for leg in ("off", "spans", "fenced")}
    runs_ms = [(leg, round(statistics.median(run["ms"][1:]), 3)) for leg, run in o1["runs"]]
    spread = (min(a_ms[1:]), max(a_ms[1:]))
    off_in = spread[0] <= ms["off"] <= spread[1]
    print(f"  path O1 ms/step (median of steps 2-{len(a_values)} of both runs of a leg): off {ms['off']:.3f}, spans and"
          f" counters {ms['spans']:.3f} ({ms['spans'] - ms['off']:+.3f}, {100 * (ms['spans'] / ms['off'] - 1):+.1f}%),"
          f" fenced {ms['fenced']:.3f} ({ms['fenced'] - ms['off']:+.3f}, {100 * (ms['fenced'] / ms['off'] - 1):+.1f}%);"
          f" runs in order {runs_ms}; path A's steps 2-{len(a_values)} in this call {spread[0]:.3f}-{spread[1]:.3f} ms"
          f" (off median {'inside' if off_in else 'outside'})")
    print(f"  ok: path O1 span counts {first['spans']['spans']}; one X event a span; the counters' keys are the JAX"
          f" schema's; fenced device_time_table {{{', '.join(f'{k}: {sorted(v)}' for k, v in table.items())}}}")

    o2 = result["O2"]
    for i, (got, want) in enumerate(zip(o2["values"], b_values)):
        if not all(torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"path O2: step {i} values differ from path B's")
    _check(o2["states_equal"] and all(torch.equal(a[k], b[k]) for a, b in zip(o2["values"], o2["plain_values"])
                                      for k in a),
           "path O2: the counts bit-equal to path B's on the same steps run without observability")
    per_step = 2 if o2["cuda"] else 0  # a CPU rehearsal runs K1's plain version
    _check(o2["step_launches"] == [per_step * (i + 1) for i in range(O_B_STEPS)] and
           o2["launches"] == per_step * O_B_STEPS,
           f"path O2: K1 launched exactly {per_step} times a step ({o2['step_launches']})")
    phase = [p for p in O_UPDATE_PHASES if o2["profiled"].get(p, 0.0) > 0.0]
    _check(bool(phase), f"path O2: from_profiler_trace has an update phase with device ms ({o2['profiled']})")
    if o2["scopes"] is not None:
        # the launch count above is the wrapper's; the profiler may leave a kernel of a session unrecorded (7 of 8
        # in two whole-script runs on the card, 8 of 8 when path O ran alone), so the trace is held to what it holds
        inside = o2["scopes"]["inside"]
        _check(len(inside) >= 1 and all(x is not None for x in inside),
               f"path O2: every K1 count_kernel the trace holds ({len(inside)} of {o2['launches']} launched) lies"
               f" inside an update scope on the device timeline ({Counter(inside)})")
    print(f"  ok: path O2, {O_B_STEPS} steps of path B fenced under torch.profiler: {o2['launches']} K1 launches,"
          f" counts bit-equal; profiler phases {{{', '.join(f'{k}: {v:.4f}' for k, v in o2['profiled'].items())}}} ms;"
          f" fenced update device ms {[round(x, 4) for x in o2['update_device_ms']]};"
          f" K1 inside {Counter(o2['scopes']['inside']) if o2['scopes'] else None}")

    o3 = result["O3"]
    if o3 is not None:
        first, second = o3["spans"]
        _check(bool(first) and first[0][1].get("compiled") == "yes"
               and all(a.get("compiled") == "no" for _n, a in first[1:] + second),
               f"path O3: the first update span compiled=yes, every later one compiled=no ({first} / {second})")
        _check(o3["compile"]["compile_cache"] == {"hits": 1, "misses": 0} and o3["compile"]["compile_events"] == 1,
               f"path O3: one cache hit, no miss ({o3['compile']})")
        print(f"  ok: path O3 ({o3['s']:.1f} s, child process): {o3['compile']}; first span {first[0]}")

    o4 = result["O4"]
    _check(sorted(o4["opened"]) == o4["touched"] and all(
        e["first_event"] <= e["last_event"] and "first_event" in e for e in o4["opened"].values()),
        f"path O4: the ledger stamps first_event / last_event for every window the batches open"
        f" ({sorted(o4['opened'])} vs {o4['touched']})")
    life = o4["lifecycle"].get(O_LABEL)
    _check(life is not None and life["windows_stamped"] == len(o4["closed"]) and o4["closed"],
           f"path O4: the lifecycle gauge counts every published window ({life}, {len(o4['closed'])} closed)")
    meter = o4["selfmeter"].get(O_LABEL, {})
    _check({"ingest", "close", "dispatch", "sync", "publish", "e2e"} <= set(meter)
           and meter["e2e"]["count"] == len(o4["closed"]) and O_LABEL in o4["staleness"],
           f"path O4: SELFMETER summaries of every stage in counters_snapshot() ({sorted(meter)})")
    _check(all(torch.equal(o4["deferred_epoch"][k], o4["sync_epoch"][k]) for k in o4["sync_epoch"])
           and all(torch.equal(o4["sync_epoch"][k], a_epoch[k]) for k in a_epoch)
           and o4["deferred_calls"] == o4["sync_calls"],
           f"path O4: deferred_epoch_sync's epoch equals the synchronous one and path A's, with the same collectives"
           f" ({o4['deferred_calls']} / {o4['sync_calls']})")
    print(f"  ok: path O4 ({o4['s']:.1f} s): {len(o4['opened'])} windows stamped, {len(o4['closed'])} published,"
          f" e2e p99 {meter['e2e']['p99_ms']:.3f} ms; deferred epoch {o4['deferred_calls']}")
    return {"ms_per_step": ms, "O1_runs_ms": runs_ms, "O2_update_device_ms": o2["update_device_ms"],
            "O2_profiled_ms": o2["profiled"], "O2_ms_per_step": statistics.median(o2["ms"]),
            "s": {k: result[k]["s"] for k in ("O2", "O4")},
            "O1_s": o1["s"], "O3": None if o3 is None else o3["compile"]}


# ---- path P: the serving plane at W1's size (24 batches of 65,536 events into a served Windowed(AUROC sketch)
# ring), bench.py's fleet topology and retention ladder, G5's Zipf keys
P_LABEL = "path-p/P1"
P2_STEPS, P2_BATCH = 4, 512  # W1's first 4 steps in batches of 512 events, so spans form under coalesce_max_samples
P3_PREEMPT_CALL, P3_STALL_CALL, P3_STALL_S, P3_LATE_CALL, P3_LATE_S = 9, 5, 0.2, 3, 300.0  # beyond W1's 180 s
P4_SHARDS, P4_WINDOW_S, P4_WINDOWS, P4_LATENESS = 8, 10.0, 4, 20.0  # bench.py:193-205's fleet topology
P4_BATCHES, P4_BATCH, P4_KILL_CALL = 96, 8_192, 4
P4_HH_STEPS, P4_HH_HOT, P4_HH_TAIL, P4_HH_TOP = 2, 256, (4, 1_024), 16  # G5's first 2 steps; J4's two tiers
P5_LADDER = ((W1_WINDOW_S, 4), (4 * W1_WINDOW_S, 4), (16 * W1_WINDOW_S, 8))  # bench.py:282-288's shape, W1's stride


def _p_hist_fold(data):
    """The (label, bin) counts of the events a window took, by a numpy ``bincount`` (check_path_k's fold)."""
    def fold(parts):
        total = np.zeros(2 * G_BINS, np.int64)
        for i, mask in parts:
            b = data[i]
            flat = np.where(b["labels"] == 1, 0, 1) * G_BINS + _g_linear_bins(b["scores"], G_BINS)
            total += np.bincount(flat[mask], minlength=2 * G_BINS)
        return total.reshape(2, G_BINS)

    return fold


def _p_w1(device):
    import metrics_tpu_torch as pt

    # no dist_sync_on_step: the ingest thread enters no collective; each publish syncs on one thread
    return pt.Windowed(pt.AUROC(approx="sketch", device=device), window_s=W1_WINDOW_S, num_windows=W1_WINDOWS,
                       allowed_lateness_s=W1_LATENESS)


def _p_records(svc):
    return [{k: r[k] for k in ("window", "value", "merged", "degraded", "final", "dropped_samples")}
            for r in svc.publications]


def _p_serve(svc, inputs, depths=None):
    """Submit every batch by seq, then flush; returns the host seconds. ``depths`` gets the queue depth after
    each submit (the producer's view of the ingress queue)."""
    t0 = time.perf_counter()
    for i, (s, y, t) in enumerate(inputs):
        svc.submit(s, y, event_time=t, seq=i)
        if depths is not None:
            depths.append(svc._queue.qsize())
    svc.flush(300.0)
    return time.perf_counter() - t0


def _p_e2e(obs, svc):
    """The lifecycle ledger's close -> publish ms of each window the service published."""
    return [obs.LEDGER.latencies(svc.label, r["window"]).get("e2e") for r in svc.publications]


def _p_partial_counts(partials):
    return {int(p["window"]): (np.asarray(p["state"]["hist"].counts), float(np.asarray(p["rows"])), p["final"])
            for p in partials}


def _p_g5_keys(steps):
    """The first ``steps`` steps of G5's keys (``_g_keys``'s draw, without its count-min hashing)."""
    rng = np.random.default_rng(14)
    cdf = np.cumsum(np.arange(1, G5_KEYS + 1, dtype=np.float64) ** -1.1)
    return [np.searchsorted(cdf, rng.random(G5_N) * cdf[-1]).astype(np.int64) for _ in range(steps)]


def _p_fleet_stream():
    """P4's tenant batches: tenants balanced over the shards by the stable hash, times ``i * 2.5 + U(0, 2.5)``
    with a fifth of the events up to 8 s late (inside the 20 s lateness), scores and 30% positive labels."""
    from metrics_tpu_torch.serving import shard_for_key

    keys, per, j = [], {s: 0 for s in range(P4_SHARDS)}, 0
    while any(v < P4_BATCHES // P4_SHARDS for v in per.values()):
        key, j = f"tenant-{j}", j + 1
        s = shard_for_key(key, P4_SHARDS)
        if per[s] < P4_BATCHES // P4_SHARDS:
            per[s] += 1
            keys.append(key)
    rng = np.random.RandomState(64)
    out = []
    for i in range(P4_BATCHES):
        t = i * 2.5 + rng.uniform(0, 2.5, P4_BATCH)
        t = np.where(rng.rand(P4_BATCH) < 0.2, t - rng.uniform(0, 8.0, P4_BATCH), t)
        labels = (rng.rand(P4_BATCH) < 0.3).astype(np.int64)
        scores = (1 / (1 + np.exp(-(rng.randn(P4_BATCH) + 1.5 * labels)))).astype(np.float32)
        out.append((keys[i % len(keys)], t, scores, labels))
    return out


def _p4_factory(device):
    import metrics_tpu_torch as pt

    return lambda: pt.Windowed(pt.Accuracy(device=device), window_s=P4_WINDOW_S, num_windows=P4_WINDOWS,
                               allowed_lateness_s=P4_LATENESS)


def _p_fleet(device, stream, made, kill_shard=None):
    """An 8-shard fleet of Windowed(Accuracy) over P4's stream; with ``kill_shard`` a seeded preempt kills it at
    its ingest call ``P4_KILL_CALL`` and ``recover_shard`` rebuilds it."""
    import torch

    import metrics_tpu_torch as pt
    from metrics_tpu_torch.parallel import faults
    from metrics_tpu_torch.serving import FLEET_SITE, ShardStoppedError
    from metrics_tpu_torch.utils.exceptions import PreemptionError

    # only the killed run recovers, and only from the preempt it injected: any other fault propagates
    stopped, preempted = (ShardStoppedError, PreemptionError) if kill_shard is not None else ((), ())
    injector = None
    if kill_shard is not None:
        injector = faults.ChaosInjector([faults.FaultSpec(kind="preempt", call=P4_KILL_CALL, times=1,
                                                          site=FLEET_SITE, shard=kill_shard)], seed=0).install()
    recovered = 0
    try:
        fleet = pt.MetricFleet(_p4_factory(device), num_shards=P4_SHARDS,
                               name="path-p/P4" + ("" if kill_shard is None else "-kill"))
        made.append(fleet)
        t0 = time.perf_counter()
        for key, t, s, y in stream:
            try:
                fleet.submit(key, torch.from_numpy(s).to(device), torch.from_numpy(y).to(device), event_time=t)
            except stopped as err:
                fleet.recover_shard(err.shard)
                recovered += 1
        try:
            fleet.flush(300.0)
        except preempted:  # a kill the submissions never saw surfaces at the barrier
            dead = [i for i, svc in enumerate(fleet.shards) if svc.state == "preempted"]
            if not dead:
                raise
            for i in dead:
                fleet.recover_shard(i)
                recovered += 1
        merged = float(fleet.finalize(300.0))
        seconds = time.perf_counter() - t0
        fleet.stop()
    finally:
        if injector is not None:
            injector.uninstall()
    records = [{k: r[k] for k in ("window", "value", "rows", "shards", "degraded", "forced", "final")}
               for r in fleet.merged_records]
    return {"records": records, "merged": merged, "recovered": recovered, "s": seconds,
            "replayed": sum(s.replayed_steps for s in fleet.shards)}


def _p_scrape(url):
    """One ``GET /metrics``: status, content type, body."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read().decode("utf-8")


def _p_parse(body):
    """The exposition parsed back: {family: kind} from ``# TYPE`` lines and [(name, {label: value}, value)] samples;
    raises on a line that is neither."""
    import re

    sample = re.compile(r'([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
    label = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    lines = body.split("\n")
    if lines[-2:] != ["# EOF", ""]:
        raise AssertionError("path P5: the exposition does not end with '# EOF'")
    kinds, samples = {}, []
    for line in lines[:-2]:
        if line.startswith("# TYPE "):
            name, kind = line[7:].rsplit(" ", 1)
            kinds[name] = kind
        elif line.startswith("# HELP "):
            continue
        else:
            m = sample.match(line)
            if m is None:
                raise AssertionError(f"path P5: unparseable exposition line {line!r}")
            samples.append((m.group(1), dict(label.findall(m.group(2) or "")), m.group(3)))
    return kinds, samples


def run_path_p(device):
    """Path P inside the caller's process group: P1 a served W1 ring (deferred stage, then the synchronous stage,
    then its first 2 batches alone for the CPU comparison) with a retention store attached, P2 the coalescing path,
    P3 the chaos soak with preempt / restore / replay, P4 an 8-shard fleet (then with a shard killed and recovered)
    and a HeavyHitterFleet over G5's keys, P5 the store's queries and one scrape of an ExpositionServer. Every
    service, fleet and server is stopped, and the host plane drained, before it returns."""
    import torch

    import metrics_tpu_torch as pt
    import metrics_tpu_torch.observability as obs
    from metrics_tpu_torch.parallel import faults
    from metrics_tpu_torch.parallel.deferred import drain_host_plane
    from metrics_tpu_torch.parallel.sync import SyncGuard
    from metrics_tpu_torch.serving.service import INGEST_SITE, ServiceStoppedError
    from metrics_tpu_torch.utils.exceptions import PreemptionError

    to = (lambda x: torch.from_numpy(x).to(device))
    data = _k_events(61, W1_STEPS, W1_ADVANCE, (0.05, (0.0, 150.0)), (0.005, (250.0, 400.0)))
    inputs = [(to(b["scores"]), to(b["labels"]), b["t"]) for b in data]
    out, made, server = {"data": data}, [], None
    try:
        # P1: the served ring, deferred publish, a retention store attached, the ledger on
        t0 = time.perf_counter()
        raw, depths = [], []
        obs.disable()
        obs.reset()
        obs.enable()
        svc = pt.MetricService(_p_w1(device), name=P_LABEL, queue_size=64,
                               partial_publish_fn=lambda record, partial: raw.append(partial))
        made.append(svc)
        store = pt.RetentionStore(ladder=P5_LADDER, name="path-p/store").attach(svc)
        ingest_s = _p_serve(svc, inputs, depths)
        merged = float(svc.finalize(300.0))
        svc.stop()
        snap = obs.counters_snapshot()
        out["P1"] = {"records": _p_records(svc), "merged": merged, "partials": _p_partial_counts(raw),
                     "ingest_s": ingest_s, "e2e_ms": _p_e2e(obs, svc), "queue_max": max(depths),
                     "deferred_max": snap["deferred_depth"][P_LABEL]["max"],
                     "selfmeter": snap["selfmeter"].get(P_LABEL, {}), "dropped": svc.metric.dropped_samples,
                     "counts": _j_counts(svc.metric), "health": svc.health, "state": svc.state}
        raw_partials = list(raw)
        # the synchronous stage under the same planes, so the two ingest rates compare
        sync = pt.MetricService(_p_w1(device), name="path-p/P1-sync", queue_size=64, deferred_publish=False)
        made.append(sync)
        sync_s = _p_serve(sync, inputs)
        sync_merged = float(sync.finalize(300.0))
        sync.stop()
        out["P1"]["sync"] = {"records": _p_records(sync), "merged": sync_merged, "ingest_s": sync_s,
                             "e2e_ms": _p_e2e(obs, sync)}
        obs.disable()
        obs.reset()
        early_raw = []
        early = pt.MetricService(_p_w1(device), name="path-p/P1-early",
                                 partial_publish_fn=lambda record, partial: early_raw.append(partial))
        made.append(early)
        _p_serve(early, inputs[:K_CPU_STEPS])
        early_merged = float(early.finalize(300.0))
        out["P1"]["early"] = {"records": _p_records(early), "merged": early_merged,
                              "partials": _p_partial_counts(early_raw)}
        early.stop()
        out["P1"]["s"] = time.perf_counter() - t0

        # P2: batches of 512 events, a backlog under the processing lock, coalescing on and off
        t0 = time.perf_counter()
        small = []
        for i in range(P2_STEPS):
            s, y, t = inputs[i]
            small += [(s[j:j + P2_BATCH], y[j:j + P2_BATCH], t[j:j + P2_BATCH]) for j in range(0, K_N, P2_BATCH)]
        p2 = {}
        for coalesce in (True, False):
            svc = pt.MetricService(_p_w1(device), name=f"path-p/P2-{coalesce}", queue_size=len(small) + 4,
                                   coalesce_max_batches=8 if coalesce else 1)
            made.append(svc)
            with svc._proc_lock:
                for i, (s, y, t) in enumerate(small):
                    svc.submit(s, y, event_time=t, seq=i)
            t1 = time.perf_counter()
            svc.flush(300.0)
            drain_s = time.perf_counter() - t1
            merged = float(svc.finalize(300.0))
            p2[coalesce] = {"records": _p_records(svc), "merged": merged,
                            "counts": _j_counts(svc.metric), "coalesced": svc.coalesced_batches,
                            "drains": svc.drains, "processed": svc.processed, "drain_s": drain_s}
            svc.stop()
        out["P2"] = {"on": p2[True], "off": p2[False], "batches": len(small), "s": time.perf_counter() - t0}

        # P3: the chaos soak: a late burst, an ingest stall and a persistent sync drop, uninterrupted and then
        # preempted at ingest, restored into a fresh service and replayed from two batches before the snapshot
        t0 = time.perf_counter()
        guard = SyncGuard(deadline_s=1.0, max_retries=1, backoff_s=0.01, policy="degrade")
        base = [faults.FaultSpec(kind="late_burst", call=P3_LATE_CALL, times=1, skew_s=P3_LATE_S, site=INGEST_SITE),
                faults.FaultSpec(kind="ingest_stall", call=P3_STALL_CALL, times=1, duration_s=P3_STALL_S,
                                 site=INGEST_SITE),
                faults.FaultSpec(kind="drop", rate=1.0, times=10_000, site="host_gather")]
        with faults.ChaosInjector(base, seed=0) as inj:
            plain = pt.MetricService(_p_w1(device), name="path-p/P3-plain", guard=guard)
            made.append(plain)
            _p_serve(plain, inputs)
            plain_merged = float(plain.finalize(300.0))
            plain.stop()
        injected = {k: v for k, v in inj.injected.items() if v}
        preempt = faults.FaultSpec(kind="preempt", call=P3_PREEMPT_CALL, times=1, site=INGEST_SITE)
        with faults.ChaosInjector(base + [preempt], seed=0):
            killed = pt.MetricService(_p_w1(device), name="path-p/P3-killed", guard=guard)
            made.append(killed)
            died = None
            try:
                _p_serve(killed, inputs)
            except (ServiceStoppedError, PreemptionError) as err:
                died = type(err).__name__
            snapshot = killed.snapshot()
            before = _p_records(killed)
            killed.stop()
            restored = pt.MetricService(_p_w1(device), name="path-p/P3-restored", guard=guard)
            made.append(restored)
            restored.restore(snapshot)
            start = snapshot["processed"] - 2
            for i in range(start, len(inputs)):
                restored.submit(*inputs[i][:2], event_time=inputs[i][2], seq=i)
            restored.flush(300.0)
            restored_merged = float(restored.finalize(300.0))
            restored.stop()
        out["P3"] = {"plain": _p_records(plain), "plain_merged": plain_merged, "plain_dropped": plain.metric.dropped_samples,
                     "plain_health": plain.health, "injected": injected, "died": died, "state": killed.state,
                     "processed": snapshot["processed"], "before": before, "after": _p_records(restored),
                     "restored_merged": restored_merged, "replayed": restored.replayed_steps,
                     "restored_dropped": restored.metric.dropped_samples, "s": time.perf_counter() - t0}

        # P4: the fleet, uninterrupted and with a shard killed; one service over the union; the HeavyHitterFleet
        t0 = time.perf_counter()
        stream = _p_fleet_stream()
        fleet = _p_fleet(device, stream, made)
        kill = pt.serving.shard_for_key(stream[2][0], P4_SHARDS)
        killed = _p_fleet(device, stream, made, kill_shard=kill)
        union = pt.MetricService(_p4_factory(device)(), name="path-p/P4-union", queue_size=P4_BATCHES + 4)
        made.append(union)
        _p_serve(union, [(to(s), to(y), t) for _key, t, s, y in stream])
        union_merged = float(union.finalize(300.0))
        union.stop()
        t1 = time.perf_counter()
        hh = pt.HeavyHitterFleet(lambda: pt.HeavyHitters(pt.Accuracy(device=device), num_hot_slots=P4_HH_HOT,
                                                         tail=P4_HH_TAIL), num_shards=P4_SHARDS)
        keys = _p_g5_keys(P4_HH_STEPS)
        rng = np.random.RandomState(65)
        hh_submit_s = []
        for step_keys in keys:
            labels = (rng.rand(G5_N) < 0.3).astype(np.int64)
            scores = rng.rand(G5_N).astype(np.float32)
            t2 = time.perf_counter()
            hh.submit(step_keys, to(scores), to(labels))
            _sync(device)
            hh_submit_s.append(time.perf_counter() - t2)
        top = hh.compute_heavy_hitters(k=P4_HH_TOP)
        out["P4"] = {"fleet": fleet, "killed": killed, "kill_shard": kill,
                     "union": [{k: r[k] for k in ("window", "value")} for r in union.publications],
                     "union_merged": union_merged, "hh_keys": keys,
                     "hh_top": [{k: (float(v) if k == "value" else v) for k, v in r.items()} for r in top],
                     "hh_bound": hh.tail_overcount_bound(), "hh_mass": hh.tail_mass(),
                     "hh_shard_of": {r["key"]: hh.shard_of(r["key"]) for r in top}, "hh_submit_s": hh_submit_s,
                     "hh_s": time.perf_counter() - t1, "s": time.perf_counter() - t0}
        del hh

        # P5: the store P1 banked into: native and coarse queries, latest, and one scrape parsed back
        t0 = time.perf_counter()
        span = (0.0, (W1_STEPS + 1) * W1_ADVANCE + W1_WINDOW_S)
        queries = {res: store.query(time_range=span, resolution_s=res) for res in (None, 4 * W1_WINDOW_S,
                                                                                  16 * W1_WINDOW_S)}
        server = pt.ExpositionServer([store])
        status, content_type, body = _p_scrape(server.url)
        server.close()
        server = None
        out["P5"] = {"queries": queries, "latest": store.latest(), "raw": _p_partial_counts(raw_partials),
                     "resident_bytes": store.resident_bytes(), "rollups": store.rollups,
                     "banked": store.windows_banked, "evicted": store.evicted_buckets, "status": status,
                     "content_type": content_type, "body": body, "store": store.label, "s": time.perf_counter() - t0}
    finally:
        if server is not None:
            server.close()
        for obj in made:
            obj.stop(60.0)
        drain_host_plane()
        obs.disable()
        obs.reset()
    return out


def _p_same_records(label, got, want, what="bit-equal"):
    if [r["window"] for r in got] != [r["window"] for r in want]:
        raise AssertionError(f"{label}: windows {[r['window'] for r in got]} against {[r['window'] for r in want]}")
    for g, w in zip(got, want):
        for key in w:
            a, b = np.asarray(g[key]), np.asarray(w[key])
            if not np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
                raise AssertionError(f"{label}: window {w['window']} {key} {g[key]} against {w[key]} ({what})")


def check_path_p(result, w1_epoch, device):
    """Path P's checks (its CPU run of P1's first batches included); returns its timings."""
    import torch

    import metrics_tpu_torch as pt
    from metrics_tpu_torch.serving import CONTENT_TYPE, shard_for_key

    print(f"[19] path P: the serving plane over W1's stream ({W1_STEPS} batches of {K_N:,} events), bench.py's"
          f" {P4_SHARDS}-shard fleet and retention ladder, G5's keys")
    data = result["data"]
    p1 = result["P1"]
    steps, *_ = _k_oracle_route([b["t"] for b in data], W1_WINDOW_S, W1_WINDOW_S, W1_WINDOWS, W1_LATENESS)
    windows = [r["window"] for r in p1["records"]]
    oracle = _k_per_window(steps, windows, _p_hist_fold(data))
    _check(windows == sorted(set(windows)) and windows == sorted(p1["partials"]) and len(windows) >= W1_WINDOWS,
           f"P1: windows {windows} published once each, in order, with their partials")
    finals = [r["final"] for r in p1["records"]]
    for r in p1["records"]:
        w = r["window"]
        counts, rows, final = p1["partials"][w]
        if not (np.array_equal(counts, oracle[w]) and rows == oracle[w].sum() and final == r["final"]):
            raise AssertionError(f"P1 window {w}: published counts differ from the numpy router's")
        alone = pt.AUROC(approx="sketch", device=device)
        alone.hist.counts.copy_(torch.from_numpy(oracle[w]))
        if not np.array_equal(r["value"], _j_host(alone.compute()), equal_nan=True):
            raise AssertionError(f"P1 window {w}: value {r['value']} against the oracle counts' {float(alone.compute())}")
    _check(not any(r["degraded"] for r in p1["records"]) and p1["health"] == "healthy" and p1["state"] == "stopped"
           and p1["merged"] == w1_epoch,
           f"P1: every window's (label, bin) counts bit-equal to the numpy router's, each value bit-equal to AUROC"
           f" over those counts; {finals.count(True)} final, {finals.count(False)}"
           f" flushed by finalize; none degraded; the final merged value {p1['merged']:.6f} equals path K's W1 epoch")
    _p_same_records("P1 synchronous stage", p1["sync"]["records"], p1["records"])
    _check(p1["sync"]["merged"] == p1["merged"], "P1: the synchronous stage's records and merged value bit-equal to"
           " the deferred stage's")
    cpu = pt.MetricService(_p_w1(torch.device("cpu")), name="path-p/P1-cpu")
    cpu_raw = []
    cpu.partial_publish_fn = lambda record, partial: cpu_raw.append(partial)
    _p_serve(cpu, [(torch.from_numpy(b["scores"]), torch.from_numpy(b["labels"]), b["t"]) for b in data[:K_CPU_STEPS]])
    cpu_merged = float(cpu.finalize(300.0))
    cpu.stop()
    early = p1["early"]
    cpu_partials = _p_partial_counts(cpu_raw)
    same = sorted(cpu_partials) == sorted(early["partials"]) and all(
        np.array_equal(cpu_partials[w][0], early["partials"][w][0]) and cpu_partials[w][1:] == early["partials"][w][1:]
        for w in cpu_partials)
    close = np.allclose([r["merged"] for r in early["records"]] + [early["merged"]],
                        [float(r["merged"]) for r in cpu.publications] + [cpu_merged], rtol=RTOL_K, atol=0.0)
    _check(same and close, f"P1: the card's first {K_CPU_STEPS} batches publish the CPU run's partials bit for bit and"
           f" its merged views within rtol {RTOL_K} ({early['merged']:.6f} / {cpu_merged:.6f})")
    e2e = [x for x in p1["e2e_ms"] if x is not None]
    sync_e2e = [x for x in p1["sync"]["e2e_ms"] if x is not None]
    meter = p1["selfmeter"].get("e2e", {})
    print(f"    P1 ingest, spans, counters and the ledger on: {W1_STEPS / p1['ingest_s']:.1f} batches/s,"
          f" {W1_STEPS * K_N / p1['ingest_s']:,.0f} events/s deferred ({p1['ingest_s']:.3f} s to flush),"
          f" {W1_STEPS / p1['sync']['ingest_s']:.1f} batches/s synchronous; lifecycle e2e (close -> publish) ms a"
          f" window {[round(x, 3) for x in e2e]} (p50 {meter.get('p50_ms', float('nan')):.3f}, p99"
          f" {meter.get('p99_ms', float('nan')):.3f}), synchronous {[round(x, 3) for x in sync_e2e]}; queue"
          f" high-water {p1['queue_max']} of 64, publish-pipeline high-water {p1['deferred_max']}")

    p2 = result["P2"]
    on, off = p2["on"], p2["off"]
    _p_same_records("P2 coalescing on against off", on["records"], off["records"])
    same_counts = all(np.array_equal(on["counts"][k], off["counts"][k]) for k in off["counts"])
    _check(same_counts and on["merged"] == off["merged"] and off["coalesced"] == 0 and on["coalesced"] > 0
           and on["processed"] == off["processed"] == p2["batches"],
           f"P2: {p2['batches']} batches of {P2_BATCH} events: coalescing on bit-equal to off (records, merged value,"
           f" slabs); {on['coalesced']} batches in spans over {on['drains']} drains against {off['drains']}")
    print(f"    P2 drain: {p2['batches'] * P2_BATCH / on['drain_s']:,.0f} events/s coalesced, "
          f"{p2['batches'] * P2_BATCH / off['drain_s']:,.0f} events/s one batch a drain")

    p3 = result["P3"]
    _check(p3["died"] is not None and p3["state"] == "preempted" and p3["processed"] == P3_PREEMPT_CALL,
           f"P3: the seeded preempt killed the worker at ingest call {P3_PREEMPT_CALL} ({p3['died']}); the snapshot"
           f" holds {p3['processed']} batches")
    published = p3["before"] + p3["after"]
    _p_same_records("P3 restore and replay against the run that was not interrupted", published, p3["plain"])
    _check(p3["restored_merged"] == p3["plain_merged"] and p3["replayed"] == 2
           and p3["restored_dropped"] == p3["plain_dropped"] > 0
           and all(r["degraded"] for r in p3["plain"]) and p3["plain_health"] == "degraded"
           and p3["injected"].get("late_burst") == 1 and p3["injected"].get("ingest_stall") == 1,
           f"P3: under {p3['injected']}: every one of {len(p3['plain'])} publishes degraded; restore and replay"
           f" (2 batches of overlap, no-ops) bit-equal to the uninterrupted run; {p3['plain_dropped']:,} events of"
           f" the late burst dropped in both")

    p4 = result["P4"]
    fleet, killed = p4["fleet"], p4["killed"]
    union = p4["union"]
    _check([r["window"] for r in fleet["records"]] == [r["window"] for r in union]
           and all(np.array_equal(np.asarray(a["value"]), np.asarray(b["value"])) for a, b in zip(fleet["records"], union))
           and fleet["merged"] == p4["union_merged"] and not any(r["degraded"] for r in fleet["records"])
           and fleet["recovered"] == 0 and fleet["replayed"] == 0,
           f"P4: {P4_SHARDS} shards, {P4_BATCHES} tenant batches of {P4_BATCH:,}: no shard recovered or replayed;"
           f" {len(union)} merged records bit-equal"
           f" to one service over the union ({fleet['s']:.2f} s, {P4_BATCHES * P4_BATCH / fleet['s']:,.0f} events/s)")
    _p_same_records("P4 fleet with shard killed and recovered", killed["records"], fleet["records"])
    _check(killed["recovered"] == 1 and killed["replayed"] >= 1 and killed["merged"] == fleet["merged"],
           f"P4: shard {p4['kill_shard']} killed at its ingest call {P4_KILL_CALL} and recovered: no window lost or"
           f" merged twice, {killed['replayed']} replayed batches no-ops")
    truth = np.bincount(np.concatenate(p4["hh_keys"]))
    top = p4["hh_top"]
    ok = len(top) == P4_HH_TOP and [r["count"] for r in top] == sorted((r["count"] for r in top), reverse=True)
    for r in top:
        ok &= r["shard"] == shard_for_key(r["key"], P4_SHARDS) == p4["hh_shard_of"][r["key"]]
        want = int(truth[r["key"]])
        ok &= r["count"] == want if r["exact"] else want <= r["count"] <= want + p4["hh_bound"]
    _check(ok, f"P4: HeavyHitterFleet over {P4_HH_STEPS} x {G5_N:,} Zipf(1.1) keys: top {P4_HH_TOP} on their home"
           f" shards, exact counts equal np.bincount's ({sum(r['exact'] for r in top)} exact), the rest within the"
           f" {p4['hh_bound']:.1f} certificate; submit {[round(x, 2) for x in p4['hh_submit_s']]} s a step")

    p5 = result["P5"]
    raw = p5["raw"]
    checked = 0
    for res, points in p5["queries"].items():
        for point in points:
            covered = [w for w in raw if point["start_s"] <= w * W1_WINDOW_S < point["start_s"] + point["seconds"]]
            counts = sum(raw[w][0] for w in covered)
            alone = pt.AUROC(approx="sketch", device=device)
            alone.hist.counts.copy_(torch.from_numpy(counts))
            if not (point["windows"] == len(covered) and point["rows"] == sum(raw[w][1] for w in covered)
                    and np.array_equal(point["value"], _j_host(alone.compute()), equal_nan=True)):
                raise AssertionError(f"P5 resolution {res}: point at {point['start_s']} s differs from the hand merge")
            checked += 1
    _check(checked and p5["rollups"] > 0 and p5["banked"] == len(raw),
           f"P5: {checked} query points on ladder {P5_LADDER} bit-equal to hand merges of P1's raw partials;"
           f" {p5['banked']} windows banked, {p5['rollups']} roll-ups, {p5['resident_bytes']:,} resident bytes")
    kinds, samples = _p_parse(p5["body"])
    latest = [s for s in samples if s[0] == "metrics_tpu_retained_latest" and s[1].get("store") == p5["store"]]
    want = p5["latest"]["value"]
    _check(p5["status"] == 200 and p5["content_type"] == CONTENT_TYPE and kinds.get("metrics_tpu_fault") == "counter"
           and len(latest) == 1 and float(latest[0][2]) == float(want),
           f"P5: one scrape of GET /metrics: 200, {CONTENT_TYPE}, {len(kinds)} families, {len(samples)} samples;"
           f" metrics_tpu_retained_latest {latest[0][2] if latest else None} equals store.latest()")
    return {"P1_batches_per_s": W1_STEPS / p1["ingest_s"], "P1_events_per_s": W1_STEPS * K_N / p1["ingest_s"],
            "P1_sync_batches_per_s": W1_STEPS / p1["sync"]["ingest_s"], "P1_e2e_ms": e2e, "P1_sync_e2e_ms": sync_e2e,
            "P2_events_per_s": {"on": p2["batches"] * P2_BATCH / on["drain_s"],
                                "off": p2["batches"] * P2_BATCH / off["drain_s"]},
            "P4_events_per_s": P4_BATCHES * P4_BATCH / fleet["s"],
            "s": {k: result[k]["s"] for k in ("P1", "P2", "P3", "P4", "P5")}}


def _torch_of(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script runs on a CUDA card", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "metrics_tpu_torch")):
        print("chip_smoke: metrics_tpu_torch/ is not beside this script; run it from the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)

    smi = phase_device()
    phase_build()
    k1 = phase_k1()
    paths = phase_paths()
    kernel = {
        "name": "binned_counts",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/binned_counts.cu",
        "replaces": "metrics_tpu/ops/binned.py:74",
        "launches": paths["b_launches"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "kernel_ms": k1["ms"],
        "ms_back_to_back": k1["ms_back_to_back"],
        "host_enqueue_us": k1["host_enqueue_us"],
        "launches_per_call": sum(op["per_call"] for op in k1["device_ops"]),
        "plain_ms": k1["plain_ms"],
        "torch_ops_ms": k1["torch_ops_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "library_reason": "no single PyTorch call computes per-threshold weighted counts without the O(N*T) comparison"
                          " matrix (histc/bucketize take no weights with an arbitrary threshold order; the matmul form"
                          " is the plain version)",
        "path_a_ms_per_step": paths["a_ms"],
        "path_b_ms_per_step": paths["b_ms"],
        "path_d1_ms_per_step": paths["d"]["D1"]["ms_per_step"],
        "path_d2_ms_per_step": paths["d"]["D2"]["ms_per_step"],
        **{f"path_{k.lower()}_ms_per_step": paths["e"][k]["ms_per_step"] for k in ("E1", "E2", "E4")},
        "path_f_ms_per_step": paths["f"]["ms_per_step"],
        "path_g_ms_per_step": {k: v["ms_per_step"] for k, v in paths["g"].items()},
        "path_h_ms_per_step": {"H1_update": paths["h"]["H1"]["update_ms"],
                               **{k: paths["h"]["H2"][k]["ms_per_step"] for k in ("H2a", "H2b")},
                               **{k: paths["h"][k]["ms_per_step"] for k in ("H3", "H4")}},
        "path_h_epoch_ms": {"H1": paths["h"]["H1"]["epoch_ms"][1], "H3": paths["h"]["H3"]["epoch_ms"][1],
                            "H3_emi": paths["h"]["H3"]["emi_ms"], "H4": paths["h"]["H4"]["epoch_ms"]},
        "path_h_peak_bytes": {"H1": paths["h"]["H1"]["peak_bytes"], "H3_emi": paths["h"]["H3"]["emi_peak_bytes"],
                              "H4": paths["h"]["H4"]["peak_bytes"]},
        "path_i_ms_per_step": {"I1": paths["i"]["I1"]["ms_per_step"], "I2": paths["i"]["I2"]["ms_per_step"],
                               "I2_edit_distance_padded": paths["i"]["I2"]["dp_ms"],
                               **{f"I3_{k}": v for k, v in paths["i"]["I3"].items() if k.endswith("_ms_per_step")},
                               "I4_rouge": paths["i"]["I4"]["rouge_ms_per_step"], "I4_lcs": paths["i"]["I4"]["lcs_ms"],
                               "I4_squad": paths["i"]["I4"]["squad_ms_per_step"]},
        "path_i_epoch_ms": {"I1": paths["i"]["I1"]["epoch_ms"][1], "I2": paths["i"]["I2"]["epoch_ms"][1],
                            **{f"I3_{k}": v for k, v in paths["i"]["I3"]["epoch_ms"].items()},
                            "I4_rouge": paths["i"]["I4"]["rouge_epoch_ms"], "I4_squad": paths["i"]["I4"]["squad_epoch_ms"]},
        "path_i1_peak_bytes": paths["i"]["I1"]["peak_bytes"],
        "path_i1_bound_ms": paths["i"]["I1"]["bound_ms"],
        "path_j_ms_per_step": {k: v["ms_per_step"] for k, v in paths["j"].items() if k != "J6"},
        "path_j6_ms_per_step": {k: v["ms_per_step"] for k, v in paths["j"]["J6"].items()},
        "path_j_peak_bytes": {k: paths["j"][k]["peak_bytes"] for k in ("J1", "J2")},
        "path_k_ms_per_step": {k: v["ms_per_step"] for k, v in paths["k"].items()},
        "path_k_device_share": {k: v["device_share"] for k, v in paths["k"].items()},
        "path_k_peak_bytes": {k: v["peak_bytes"] for k, v in paths["k"].items() if k != "W6"},
        "path_k_forward_batched_ms": paths["k"]["W6"]["forward_batched_ms"],
        "path_l_ms_per_step": {k: v["ms_per_step"] for k, v in paths["l"].items() if k.startswith("L1_sync")},
        "path_m_ms_per_round": {k: paths["m"][k]["ms_per_round"] for k in ("M1", "M2", "M3")},
        "path_m1_bytes_per_round": {"sparse": paths["m"]["M1"]["bytes_per_round"],
                                    "dense": paths["m"]["M1"]["dense_bytes"]},
        "path_n_epoch_ms": {k: {side: v[side]["ms"] for side in ("gathered", "sharded")}
                            for k, v in paths["n"].items() if k in ("N1", "N2", "N5")},
        "path_o_ms_per_step": paths["o"]["ms_per_step"],
        "path_o1_runs_ms_per_step": paths["o"]["O1_runs_ms"],
        "path_o2_ms_per_step": paths["o"]["O2_ms_per_step"],
        "path_o2_update_device_ms": paths["o"]["O2_update_device_ms"],
        "path_o2_profiled_ms": paths["o"]["O2_profiled_ms"],
        "path_p_batches_per_s": paths["p"]["P1_batches_per_s"],
        "path_p_events_per_s": paths["p"]["P1_events_per_s"],
        "path_p_e2e_ms": paths["p"]["P1_e2e_ms"],
        "path_p_s": paths["p"]["s"],
    }
    print(f"    path O2: fenced metric.forward device ms a step (K1 inside, one launch a member)"
          f" {[round(x, 4) for x in paths['o']['O2_update_device_ms']]} beside K1's phase-3 kernel ms {k1['ms']:.4f}")

    e4_k2 = paths["e"]["E4"]["k2"]
    k2 = {
        "name": "ssim_filter",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/ssim_filter.cu",
        "replaces": None,
        "replaces_reason": "the JAX package's SSIM family filters with an XLA convolution, not a Pallas kernel",
        "launches": e4_k2["launches"],
        "max_abs_err": max(row["max_abs"] for row in e4_k2["compared"]),
        "ms": e4_k2["ms"]["ssim_sums"],
        "kernel_ms": e4_k2["ms"]["ssim_sums"],
        "ms_back_to_back": e4_k2["ms_back_to_back"],
        "host_enqueue_us": e4_k2["host_enqueue_us"],
        "launches_per_call": e4_k2["launches_per_call"],
        "plain_ms": e4_k2["plain_ms"],
        "bound_ms": e4_k2["bound_ms"],
        "bound_by": "operations",
        "library_ms": None,
        "library_reason": "no PyTorch call computes the five windowed moments outside TF32 in one pass",
    }
    print(json.dumps({"kernels": [kernel, k2]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--l6-worker":  # one of path L's two Gloo processes
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(_l6_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if len(sys.argv) == 5 and sys.argv[1] == "--m6-worker":  # one of path M's four Gloo processes
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(_m6_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if len(sys.argv) == 3 and sys.argv[1] == "--o3-worker":  # path O3's compile-telemetry process
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(_o3_worker(sys.argv[2]))
    if len(sys.argv) == 5 and sys.argv[1] == "--n6-worker":  # one of path N's four Gloo processes
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(_n6_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
