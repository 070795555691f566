"""Readings that the limits of ``correct`` are set from, for a one-card cell.

    python3 portbench/calibrate.py --workload <name> --seeds 1-12 --control-seeds 1-3 --seconds 4

In one process and one one-rank group: for each seed, the cell's inputs, a
timed window of ``--seconds`` through the cell's own loop, and the widest gaps
of its answers to the plain reference (the lower readings); for each control
seed, the reference computed in the precision below the configuration's, put
in the program's place and compared the same way (the upper readings). One
JSON line a seed on standard output. The benchmark's own runs never run this.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _seeds(text: str):
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def control_outputs(exp_control):
    """The control's answers, shaped as the program's: every batch, then the epoch."""
    answers = [("step", i, v) for i, v in enumerate(exp_control.get("step", []))]
    return answers + [("epoch", 0, exp_control["epoch"])]


def readings(workload: str, seeds, control_seeds, seconds: float, device_kind: str = "cuda", addr=None):
    import torch
    import torch.distributed as dist

    from portbench import discover, run
    from portbench.harness import Ctx

    bench = discover.with_staged(discover.benchmark())
    cell = discover.cell(bench, workload)
    if int(cell["chips"]) != 1:
        raise ValueError("calibrate reads one-card cells; a cell on several cards reads its limits from its runs")
    cfg = discover.json_part("configs", cell["config"])
    traffic = discover.json_part("traffic", cell["traffic"])
    if device_kind == "cpu":
        cfg["data"].update(cfg.get("rehearsal", {}))
    device = torch.device(device_kind, 0) if device_kind == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{addr or f'127.0.0.1:{run._free_port()}'}", world_size=1, rank=0,
                            **({"device_id": device} if device.type == "cuda" else {}))
    gen = discover.module("data", cfg["data"]["kind"])
    loop = discover.module("loops", traffic["loop"])
    ref = discover.module("reference", cell["config"])
    run._precision(cfg["collection"].get("precision", {}))
    rows = []
    try:
        warmed = False
        for seed in sorted(set(seeds) | set(control_seeds)):
            data = gen.make(cfg["data"], seed, 0, 1, device)
            row = {"workload": workload, "seed": seed}
            exp = ref.expected(cfg, seed, data, 1)
            if seed in seeds:
                ctx = Ctx(run.build_collection(cfg["collection"], device), data, cfg["collection"]["call"], device)
                if not warmed:
                    loop.warm(ctx)
                    warmed = True
                ctx.collection.reset()
                win = loop.window(ctx, seconds)
                del ctx
                v = ref.compare(win.outputs, exp)
                row["program"] = {k: val for k, (val, _) in v["checks"].items()}
                row["answers"], row["failed"] = v["attempted"], v["failed"]
            if seed in control_seeds:
                v = ref.compare(control_outputs(ref.expected(cfg, seed, data, 1, control=True)), exp)
                row["control"] = {k: val for k, (val, _) in v["checks"].items()}
            row["limits"] = dict(ref.LIMITS)
            rows.append(row)
            print(json.dumps(row), flush=True)
            del data, exp
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="", help="e.g. 1-12,40")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    readings(a.workload, _seeds(a.seeds), _seeds(a.control_seeds), a.seconds, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
