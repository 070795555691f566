"""What the loops share: the run's context, the host read of a collection's
values, the stop decision of the window, and the harness's own spans."""
import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

now = time.perf_counter
_NULL = contextlib.nullcontext()


@dataclass
class Ctx:
    """One rank's run: the collection under test, its inputs, and how it is called."""

    collection: Any
    data: Dict[str, Any]
    call: Dict[str, str]  # the collection's keyword -> the field of a batch it takes
    device: torch.device
    world: int = 1
    span: Optional[Callable[[str], Any]] = None  # the harness's span of one phase, or None

    def kwargs(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: batch[v] for k, v in self.call.items()}

    def phase(self, name: str):
        """The harness's span around one call into the program (a no-op in the timed window)."""
        return _NULL if self.span is None else self.span(name)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stop(self, local: bool) -> bool:
        """Rank 0's decision to close the window, the same on every rank."""
        if self.world == 1:
            return local
        flag = torch.tensor([1 if local else 0], dtype=torch.int32, device=self.device)
        dist.broadcast(flag, src=0)
        return bool(flag.item())


def read_values(out: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """A collection's values on the host, in one read, as a logger takes them."""
    names = list(out)
    values = torch.stack([out[k].detach().reshape(()).to(torch.float64) for k in names]).tolist()
    return dict(zip(names, values))


@dataclass
class Window:
    """What a timed window leaves: each unit's host milliseconds, the window's
    length, and every answer it produced (``(kind, index, values)``)."""

    unit: str
    unit_ms: List[float] = field(default_factory=list)
    window_s: float = 0.0
    outputs: List[tuple] = field(default_factory=list)


def run_window(ctx: Ctx, seconds: float, unit: str, step: Callable[[int], list],
               after: Optional[Callable[[int], list]] = None) -> Window:
    """``step(k)`` for k = 0, 1, ... until ``seconds`` have passed on rank 0.
    Each call is one unit, ends with its values on the host and returns its
    answers. ``after(k)`` runs between units, inside the window but outside
    the unit's time (an epoch's ``compute()`` after the last step of a pass)."""
    win = Window(unit)
    start = now()
    k = 0
    while True:
        t = now()
        answers = step(k)
        win.unit_ms.append((now() - t) * 1e3)
        win.outputs.extend(answers)
        if after is not None:
            win.outputs.extend(after(k))
        k += 1
        if ctx.stop(now() - start >= seconds):
            break
    win.window_s = now() - start
    return win
