"""Runs one cell of the port's benchmark and prints its result as one JSON line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up in ``BENCHMARK.json`` at the root of the checkout, or among the
staged cells of ``portbench/staged.json``, which the benchmark does not name yet. A cell
on N cards starts N ranks, one process a card, in one NCCL group: this process
is rank 0 and starts the others, with a rendezvous port picked at run time.
Each rank makes its inputs on its card from ``--seed``, builds the collection,
warms up every shape the cell uses (that, with the imports and the group, is
``setup_s``), then either measures for ``--seconds`` (``--trace 0``: the cell's
end-to-end metrics) or runs the traffic's fixed traced units (``--trace 1``:
its per-layer metrics). When the window has closed and the program's state is
freed, rank 0 computes the plain reference and compares every answer of the
window with it. The numbers compared, each with its limit, are the last lines
on standard error and the last key (``checks``) of the result line.

A run that finds fewer CUDA cards than the cell asks for, or finds ``jax``,
``jaxlib``, ``flax`` or ``metrics_tpu`` loaded, exits with a non-zero code and
prints no result.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# build and kernel caches at fixed paths inside the checkout (these cells build nothing)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".portbench_cache" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".portbench_cache" / "triton")

FORBIDDEN = ("jax", "jaxlib", "flax", "metrics_tpu")
EXIT_FAILED, EXIT_NO_CARD, EXIT_FORBIDDEN = 1, 2, 3


def forbidden_modules():
    """Top-level names in ``sys.modules`` that the benchmark may not load, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by rank 0 for the ranks it starts
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--addr", default=None, help=argparse.SUPPRESS)
    # a rehearsal on the CPU over Gloo at the configuration's "rehearsal" sizes, kept only for the tests under
    # portbench/tests (the last line, the faults, a bare checkout); never a measurement
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_collection(spec, device):
    import metrics_tpu_torch as pt

    common = {"dist_sync_on_step": True} if spec.get("dist_sync_on_step") else {}
    return pt.MetricCollection([getattr(pt, name)(device=device, **kw, **common) for name, kw in spec["members"]])


def _precision(spec) -> None:
    import torch

    if spec.get("allow_tf32"):
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")


def _power_limit(rank: int):
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(rank), "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def run_rank(args, bench, cell, rank: int, addr: str):
    """One rank's run; rank 0 returns the result line as a dict, the others None."""
    import torch
    import torch.distributed as dist

    from portbench import discover, tracing
    from portbench.harness import Ctx, now

    world = int(cell["chips"])
    cfg = discover.json_part("configs", cell["config"])
    traffic = discover.json_part("traffic", cell["traffic"])
    cuda = args.device == "cuda"
    if not cuda:
        cfg["data"].update(cfg.get("rehearsal", {}))
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://{addr}", world_size=world, rank=rank,
                            timeout=timedelta(seconds=240), **({"device_id": device} if cuda else {}))
    try:
        _precision(cfg["collection"].get("precision", {}))
        data = discover.module("data", cfg["data"]["kind"]).make(cfg["data"], args.seed, rank, world, device)
        loop = discover.module("loops", traffic["loop"])
        ctx = Ctx(build_collection(cfg["collection"], device), data, cfg["collection"]["call"], device, world)
        loop.warm(ctx)
        found = forbidden_modules()
        if found:
            raise RuntimeError(f"set-up loaded {', '.join(found)}")
        dist.barrier()
        ctx.sync()
        setup_s = now() - T_START
        setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        if args.trace:
            rec = tracing.traced_run(ctx, loop, traffic["trace_units"], cfg.get("kernel_groups", {}))
        else:
            win = loop.window(ctx, args.seconds)
            rec = {"unit": win.unit, "unit_ms": win.unit_ms, "window_s": win.window_s, "units": len(win.unit_ms),
                   "outputs": win.outputs}
        ctx.sync()
        window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        peaks = torch.tensor([window_peak, max(window_peak, setup_peak)], dtype=torch.int64, device=device)
        dist.all_reduce(peaks, op=dist.ReduceOp.MAX)
        busy = torch.tensor([(rec.get("trace") or {}).get("busy_s", 0.0)], dtype=torch.float64, device=device)
        dist.all_reduce(busy)
        if world > 1:
            rec["outputs"] = _every_rank(rec["outputs"], world, device)
        ctx.collection = None  # the program's state goes before the reference runs
        if cuda:
            torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return None

    ref = discover.module("reference", cell["config"])
    verdict = ref.compare(rec["outputs"], ref.expected(cfg, args.seed, data, world))
    checks = dict(verdict["checks"])
    correct = verdict["failed"] == 0 and all(v <= lim for v, lim in checks.values())

    metrics, notes = {}, []
    if world > 1:
        notes.append(f"ranks' answers differ by up to {_rank_spread(rec['outputs'], world)!r}")
    if args.trace:
        rec.update(cfg=cfg, world=world)
        for m in discover.metrics_of(bench, "per_layer", cell["name"]):
            value = discover.module("layer_metrics", m["name"]).read(rec)
            if value is None:
                notes.append(f"{m['name']}: nothing to read in this run")
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        notes += (rec.get("trace") or {}).get("notes", [])
    else:
        rec.update(setup_s=setup_s, peak_bytes=int(peaks[0]))
        ms = sorted(rec["unit_ms"])
        notes.append(f"{len(ms)} {rec['unit']}s in {rec['window_s']:.3f} s; {rec['unit']} ms min {ms[0]:.3f}"
                     f" median {ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}; over 1.2 x median:"
                     f" {sum(x > 1.2 * ms[len(ms) // 2] for x in ms)}")
        for m in discover.metrics_of(bench, "end_to_end", cell["name"]):
            value = discover.module("end_to_end", m["name"]).read(rec)
            if value is None and cuda:
                raise RuntimeError(f"{cell['name']} reports {m['name']}, but its reader found nothing")
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": world, "memory_peak_bytes": int(peaks[1])}
    if cuda:
        dev["power_limit_w"] = _power_limit(rank)
    line = {"correct": bool(correct), "attempted": verdict["attempted"], "failed": verdict["failed"],
            "metrics": metrics, "device": dev}
    if args.trace and rec.get("trace"):
        t = rec["trace"]
        dev.update(busy_s=float(busy[0]) / world, window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    line["notes"] = notes
    return line


def _every_rank(outputs, world, device):
    """Every rank's answers, on rank 0: each rank's values gathered in one call,
    rank by rank (all ranks run the same units, so their answers line up)."""
    import torch
    import torch.distributed as dist

    names = [sorted(vals) for _, _, vals in outputs]
    mine = torch.tensor([[vals[k] for k in ks] for ks, (_, _, vals) in zip(names, outputs)], dtype=torch.float64,
                        device=device)
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    return [(kind, index, dict(zip(ks, row)), rank) for rank, rows in enumerate(every)
            for ks, (kind, index, _), row in zip(names, outputs, rows.tolist())]


def _rank_spread(outputs, world) -> float:
    """The largest difference between a rank's answer and rank 0's same answer."""
    n = len(outputs) // world
    return max((abs(a[2][k] - b[2][k]) for a, b in zip(outputs[:n] * world, outputs) for k in a[2]), default=0.0)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    from portbench import discover

    bench = discover.with_staged(discover.benchmark())
    cell = discover.cell(bench, args.workload)
    if args.rank is not None:  # a rank that rank 0 started
        run_rank(args, bench, cell, args.rank, args.addr)
        return 0

    world = int(cell["chips"])
    if args.device == "cuda":
        import torch

        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < world:
            print(f"portbench: {args.workload} needs {world} CUDA card(s); this machine has {cards}", file=sys.stderr)
            return EXIT_NO_CARD
    addr = f"127.0.0.1:{_free_port()}"
    children = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), *argv, "--rank", str(r),
                                  "--addr", addr], stdout=sys.stderr) for r in range(1, world)]
    line = None
    try:
        line = run_rank(args, bench, cell, 0, addr)
    except Exception:
        traceback.print_exc()
        for c in children:
            c.kill()
    finally:
        rcs = [c.wait() for c in children]
    if line is None or any(rcs):
        print(f"portbench: {args.workload} failed (ranks 1-{world - 1} exit codes {rcs})", file=sys.stderr)
        return EXIT_FAILED
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return EXIT_FORBIDDEN
    for note in line.pop("notes"):
        print(f"note: {note}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
