"""Kernel K1 of two checkouts of the repo on one card, timed in turns.

Run from the repository root on a machine with one CUDA card, with an earlier
checkout unpacked into a directory that ``.gitignore`` lists:

    git archive <commit> | tar -x -C _chipcheck/base
    python -m metrics_tpu_torch.tools.k1_compare --checkout base=_chipcheck/base

``head`` is the checkout this file lies in; ``--checkout NAME=DIR`` adds
others. Each arm runs in a process of its own with its checkout first on
``sys.path``: it builds that checkout's ``csrc/binned_counts.cu`` and calls
that checkout's ``binned_counts_cuda`` the way its binned metrics do (with
the grid ranked once where the wrapper takes ``ranked=``), at N = 4,194,304
scores, T = 2,048 thresholds and bool weights, made from one seed. The arms
run in the order ``--arms`` gives (default ``base,head,head,base``), and
each measures:

* device ms with L2 cold (median of 30 event pairs, enqueue hidden);
* ms per call back to back (100 calls between one event pair);
* host enqueue microseconds per call (200 calls while the card spins);
* the device operations of one call, from ``torch.profiler``.

Every arm's counts must equal its checkout's plain version exactly. Prints a
line an arm, the card's ``nvidia-smi`` name and power limit, and one JSON
line, which it also writes to ``--out``.
"""
import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

N, T = 4_194_304, 2_048
HEAD = Path(__file__).resolve().parents[2]


def _arm(root: Path) -> dict:
    """One arm, in its own process: ``root``'s K1 at N x T, checked and timed."""
    sys.path.insert(0, str(root))
    import torch

    from metrics_tpu_torch.ops import binned as ops  # the arm's own wrapper, kernel and plain version

    spec = importlib.util.spec_from_file_location("k1_cuda_timing", Path(__file__).with_name("cuda_timing.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.random(N, dtype=np.float32)).to(dev)
    y = torch.from_numpy(rng.random(N) < 0.3).to(dev)
    neg = ~y
    th = torch.from_numpy(np.linspace(0.0, 1.0, T, dtype=np.float32)).to(dev)
    kw = {"ranked": ops.rank_thresholds(th)} if hasattr(ops, "rank_thresholds") else {}

    def call():
        return ops.binned_counts_cuda(p, y, neg, th, **kw)

    tp, fp = call()
    want_tp, want_fp = ops._binned_counts_torch(p[:, None], y[:, None], neg[:, None], th)
    torch.cuda.synchronize()
    if not (torch.equal(tp, want_tp[0]) and torch.equal(fp, want_fp[0])):
        raise AssertionError(f"{root}: K1 counts differ from the plain version")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    return {
        "device_ms_cold": timing.device_ms_cold(call, reps=30, flush=flush),
        "ms_back_to_back": timing.ms_back_to_back(call, 100),
        "host_enqueue_us": timing.host_enqueue_us(call),
        "device_ops": timing.device_breakdown(call),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", action="append", default=[], metavar="NAME=DIR",
                        help="another checkout of the repo, by name")
    parser.add_argument("--arms", default="base,head,head,base", help="comma-separated order of checkout names")
    parser.add_argument("--out", type=Path, default=HEAD / "chiprun_out" / "k1_compare.json")
    parser.add_argument("--arm", type=Path, help=argparse.SUPPRESS)  # run one arm in this process
    args = parser.parse_args(argv)
    if args.arm is not None:
        print(json.dumps(_arm(args.arm.resolve())))
        return 0

    roots = {"head": HEAD}
    for spec in args.checkout:
        name, _, path = spec.partition("=")
        roots[name] = Path(path).resolve()
    arms = args.arms.split(",")
    missing = [a for a in arms if a not in roots]
    if missing:
        parser.error(f"no checkout named {missing}; pass --checkout NAME=DIR")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    runs = []
    for name in arms:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--arm", str(roots[name])],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"arm {name} ({roots[name]}) failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        r = {"arm": name, **json.loads(proc.stdout.strip().splitlines()[-1])}
        runs.append(r)
        ops = "; ".join(f"{o['name'][:60]} x{o['per_call']:g} {o['us_per_call']:.2f} us" for o in r["device_ops"])
        print(f"{name}: cold {r['device_ms_cold']:.4f} ms, back to back {r['ms_back_to_back']:.4f} ms,"
              f" enqueue {r['host_enqueue_us']:.2f} us/call; device ops: {ops}", flush=True)
    record = {"card": smi, "n": N, "t": T, "weights": "bool", "checkouts": {k: str(v) for k, v in roots.items()},
              "runs": runs}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=1))
    print(smi)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
