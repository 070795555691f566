"""What the span-layer metrics read: the port's own idle attribution
(``metrics_tpu_torch.observability.devtime.idle_attribution``) of the traced
run's profiled phase, which is the process's last profiler session, over the
traced units' window (the first ``portbench.unit`` range's start to the last
one's end, the window ``device_idle_pct`` reads). The session keeps its span
records, so the host self times come from the profiled units too and carry
the profiler's overhead. A port without the attribution, or a run without
such a session, reads None."""
import threading
from typing import Any, Dict, Optional

_LAST: Dict[str, Any] = {}  # the session last attributed, and its attribution


def attribution() -> Optional[Dict[str, Any]]:
    try:
        from metrics_tpu_torch.observability import devtime, profiler
    except ImportError:
        return None
    attribute = getattr(devtime, "idle_attribution", None)
    last = getattr(profiler, "last_session", None)
    session = last() if last is not None else None
    if attribute is None or session is None:
        return None
    if _LAST.get("session") is not session:
        try:
            result = attribute(window="portbench.unit", thread_id=threading.get_ident())
        except ValueError:  # no anchor or no unit range in the session's trace
            result = None
        _LAST.update(session=session, result=result)
    return _LAST["result"]


def per_unit(rec, kind: str, layer: str) -> Optional[float]:
    """The attribution's ``kind`` (``idle_ms`` or ``host_self_ms``) of
    ``layer``, over the traced units, a unit; None where there is none."""
    found = attribution()
    if found is None or not rec.get("units"):
        return None
    return found[kind]["by_layer"].get(layer, 0.0) / rec["units"]
