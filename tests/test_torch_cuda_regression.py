"""Regression on the card, held against the CPU run of the port and scipy.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so it runs on a GPU machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_regression.py

* SSIM, MS-SSIM and UQI on the card with the precision flags that let a
  convolution or a matmul run in TF32 (``torch.backends.cudnn.allow_tf32``,
  ``torch.backends.cuda.matmul.allow_tf32``, ``set_float32_matmul_precision("high")``)
  give bit for bit what they give with those flags off, equal the CPU run
  (rtol 1e-5 on a value, 1e-4 absolute on a map pixel: float32 moment maps
  cancel, and the card fuses multiply-adds that the CPU rounds twice), and
  leave the caller's flags as they were.
* Spearman over 1,048,576 tied scores and Kendall over 8,192 tied scores
  equal scipy (rtol 1e-5 and 1e-6: Kendall's pair counts are exact int64).
* On a machine with two or more cards (skips on one): one NCCL process per
  card, each with its own uneven batch, a ``PearsonCorrcoef``. Every rank's
  epoch value equals one process over all rows (rtol 1e-5), through one
  layout and one float32 ``all_gather`` and one ``all_reduce``.
"""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import scipy.stats
import torch

import metrics_tpu_torch as pt
import metrics_tpu_torch.functional as ptf

RTOL, ATOL_MAP = 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _images(seed, shape):
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    target = 0.5 + 0.25 * np.sin(8 * yy + rng.random((n, c, 1, 1)) * 6) * np.cos(7 * xx)
    preds = np.clip(target + 0.05 * rng.standard_normal(shape), 0, 1)
    return torch.from_numpy(preds.astype(np.float32)), torch.from_numpy(target.astype(np.float32))


def _flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())


def _set_flags(tf32):
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


_CASES = {
    "ssim": lambda p, t: ptf.ssim(p, t, data_range=1.0),
    "ssim_map": lambda p, t: ptf.ssim(p, t, kernel_size=(7, 11), sigma=(1.0, 2.0), data_range=1.0, reduction="none"),
    "ms_ssim": lambda p, t: ptf.multiscale_ssim(p, t, data_range=1.0, reduction="none"),
    "uqi": lambda p, t: ptf.universal_image_quality_index(p, t),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_CASES))
def test_ssim_family_ignores_the_tf32_flags_and_equals_cpu(cuda, name):
    p, t = _images(1, (4, 3, 256, 256))
    fn = _CASES[name]
    saved = _flags()
    try:
        _set_flags(True)
        with_tf32 = fn(p.to(cuda), t.to(cuda))
        assert _flags() == (True, True, "high")  # the call left the caller's flags alone
        _set_flags(False)
        without = fn(p.to(cuda), t.to(cuda))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
    assert torch.equal(with_tf32, without)
    cpu = fn(p, t)
    if name == "ssim_map":
        torch.testing.assert_close(with_tf32.cpu(), cpu, rtol=0, atol=ATOL_MAP)
        torch.testing.assert_close(with_tf32.mean().cpu(), cpu.mean(), rtol=RTOL, atol=0)
    else:
        torch.testing.assert_close(with_tf32.cpu(), cpu, rtol=RTOL, atol=0)


@pytest.mark.cuda
def test_ssim_module_both_modes_equal_cpu(cuda):
    streaming, stored = pt.SSIM(data_range=1.0, device=cuda), pt.SSIM(device=cuda)
    cpu_streaming, cpu_stored = pt.SSIM(data_range=1.0, device="cpu"), pt.SSIM(device="cpu")
    for step in range(2):
        p, t = _images(10 + step, (2, 3, 128, 128))
        for m in (streaming, stored):
            m.update(p.to(cuda), t.to(cuda))
        for m in (cpu_streaming, cpu_stored):
            m.update(p, t)
    assert streaming.streaming and not stored.streaming and len(stored.y) == 2
    torch.testing.assert_close(stored.compute().cpu(), cpu_stored.compute(), rtol=RTOL, atol=0)
    torch.testing.assert_close(streaming.compute().cpu(), cpu_streaming.compute(), rtol=RTOL, atol=0)


@pytest.mark.cuda
def test_spearman_and_kendall_with_ties_equal_scipy(cuda):
    rng = np.random.default_rng(2)
    x = np.round(rng.random(1 << 20) * 4096).astype(np.float32) / 4096  # a 2**-12 grid: tied
    y = (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
    y = np.round(y * 256) / 256
    got = ptf.spearman_corrcoef(torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda))
    assert float(got) == pytest.approx(scipy.stats.spearmanr(x, y).statistic, rel=RTOL)
    k = 8192
    got = ptf.kendall_rank_corrcoef(torch.from_numpy(x[:k]).to(cuda), torch.from_numpy(y[:k]).to(cuda))
    assert float(got) == pytest.approx(scipy.stats.kendalltau(x[:k], y[:k]).statistic, rel=1e-6)
    cpu = ptf.kendall_rank_corrcoef(torch.from_numpy(x[:k]), torch.from_numpy(y[:k]))
    assert torch.equal(got.cpu(), cpu)


_WORKER = textwrap.dedent("""
    import sys, warnings
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, {repo!r})
    import metrics_tpu_torch as pt

    warnings.simplefilter("ignore")
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:" + port, rank=rank, world_size=world)
    m = pt.PearsonCorrcoef(device=device)
    rng = np.random.default_rng(rank)
    x = rng.standard_normal({n} + 97 * rank).astype(np.float32)
    m.update(torch.from_numpy(x).to(device), torch.from_numpy(2 * x + rng.standard_normal(x.shape).astype(np.float32)).to(device))
    calls = []
    real_gather, real_reduce = dist.all_gather, dist.all_reduce
    dist.all_gather = lambda *a, **k: (calls.append("all_gather"), real_gather(*a, **k))[1]
    dist.all_reduce = lambda *a, **k: (calls.append("all_reduce"), real_reduce(*a, **k))[1]
    value = m.compute()
    torch.save({{"value": value.cpu(), "calls": sorted(calls), "n_total": int(m.n_total)}}, out)
    dist.destroy_process_group()
""")


@pytest.mark.cuda
def test_pearson_sync_across_cards_nccl(cuda, tmp_path):
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more cards")
    n = 100_000
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "pearson_worker.py"
    script.write_text(_WORKER.format(repo=str(Path(__file__).resolve().parents[1]), n=n))
    outs = [tmp_path / f"rank{r}.pt" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), str(port), str(outs[r])],
                              env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * world, logs

    one = pt.PearsonCorrcoef(device="cpu")
    for rank in range(world):
        rng = np.random.default_rng(rank)
        x = rng.standard_normal(n + 97 * rank).astype(np.float32)
        one.update(torch.from_numpy(x), torch.from_numpy(2 * x + rng.standard_normal(x.shape).astype(np.float32)))
    want = one.compute()
    for rank, out in enumerate(outs):
        got = torch.load(out)
        torch.testing.assert_close(got["value"], want, rtol=RTOL, atol=0)
        assert got["calls"] == ["all_gather", "all_gather", "all_reduce"]
        assert got["n_total"] == n + 97 * rank  # each rank keeps its own count
