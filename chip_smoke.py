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
   ``torch.profiler`` must show one device operation per call and no fill.
4. Path A, the main path: ``MetricCollection([Accuracy, F1, Precision,
   Recall])`` (macro, C = 1,000, ``dist_sync_on_step``) inside a one-rank NCCL
   process group, 20 steps of 4,096 x 1,000 probabilities. Per-step values
   and the epoch compute are checked against the port on the CPU and against
   a numpy ``bincount`` confusion oracle.
5. Path B: ``MetricCollection([BinnedAUROC, BinnedAveragePrecision])`` with
   2,048 thresholds and ``dist_sync_on_step`` in the same group, 10 steps of
   4,194,304 binary scores. K1's launch count must rise by exactly 2 per step,
   and a profiled extra step must show 2 K1 kernels and no sort (the
   thresholds are ranked once per grid, not per step).
   Counts are checked exactly against the numpy oracle and the plain version
   on the card; AUROC / AP to rtol 1e-5.
6. The ``kernels`` JSON line, then the device JSON as the last line.

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

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM non-tensor float32 peak, NVIDIA data sheet
K1_N, K1_T = 4_194_304, 2_048
A_STEPS, A_BATCH, A_CLASSES = 20, 4_096, 1_000
B_STEPS, B_N, B_T = 10, 4_194_304, 2_048
RTOL_FLOAT = 1e-5  # float-weight counts and binned AUROC / AP: sums in another order
RTOL_CLASS = 1e-6  # classification values, card against CPU: a mean in another order
RTOL_ORACLE = 1e-5  # float32 values against the float64 numpy oracle


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
            ops = device_breakdown(call)
            timings["device_ops"] = ops
            _check(len(ops) == 1 and ops[0]["per_call"] == 1 and "count_kernel" in ops[0]["name"],
                   f"K1 with the ranked grid is one device operation per call, no fill ({ops[0]['name'][:48]}...)")
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


def _main_collection(device, **kw):
    import metrics_tpu_torch as pt

    return pt.MetricCollection([
        pt.Accuracy(device=device, **kw),
        pt.F1(num_classes=A_CLASSES, average="macro", device=device, **kw),
        pt.Precision(num_classes=A_CLASSES, average="macro", device=device, **kw),
        pt.Recall(num_classes=A_CLASSES, average="macro", device=device, **kw),
    ])


def _binned_collection(device, **kw):
    import metrics_tpu_torch as pt

    return pt.MetricCollection([
        pt.BinnedAUROC(thresholds=B_T, device=device, **kw),
        pt.BinnedAveragePrecision(thresholds=B_T, device=device, **kw),
    ])


def _run_steps(collection, batches, on_step=None):
    """Per-step values (tensors), per-step milliseconds (host clock, synchronized)."""
    import torch

    values, ms = [], []
    for i, (preds, target) in enumerate(batches):
        t0 = time.perf_counter()
        values.append(collection(preds, target))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if on_step is not None:
            on_step(i)
    return values, ms


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
        a_epoch = col_a.compute()

        col_b = _binned_collection(dev, dist_sync_on_step=True)
        step_launches = []
        binned_counts_cuda.launches = 0
        b_values, b_ms = _run_steps(col_b, b_batches, on_step=lambda i: step_launches.append(binned_counts_cuda.launches))
        b_launches = binned_counts_cuda.launches
        b_epoch = col_b.compute()
        torch.cuda.synchronize()
        step_kernels = _profile_step(_binned_collection(dev, dist_sync_on_step=True), b_batches[0])
    finally:
        dist.destroy_process_group()

    print(f"[4] path A: {A_STEPS} steps of {A_BATCH} x {A_CLASSES}: median {statistics.median(a_ms):.3f} ms/step"
          f" (first step {a_ms[0]:.1f} ms); K1 launches {a_launches}")
    _check_path_a(a_batches, a_values, a_epoch, col_a)
    print(f"[5] path B: {B_STEPS} steps of {B_N} scores, {B_T} thresholds: median {statistics.median(b_ms):.3f} ms/step"
          f" (first step {b_ms[0]:.1f} ms); K1 launches {b_launches}")
    _check(step_launches == [2 * (i + 1) for i in range(B_STEPS)], "path B: K1 launched exactly 2 times per step")
    _check(step_kernels.get("count_kernel", 0) == 2 and step_kernels.get("sort", 0) == 0,
           f"path B profiled step: 2 K1 kernels, no threshold ranking (no sort kernel) ({step_kernels})")
    _check_path_b(b_batches, b_values, b_epoch, col_b)
    return {"a_ms": statistics.median(a_ms), "b_ms": statistics.median(b_ms), "b_launches": b_launches}


def _profile_step(collection, batch):
    """K1's kernels and the sort kernels (a threshold ranking) in one profiled collection step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        collection(*batch)
        torch.cuda.synchronize()
    counts = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for name in ("count_kernel", "sort"):
                if name in e.key.lower():
                    counts[name] = counts.get(name, 0) + e.count
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
    }
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
