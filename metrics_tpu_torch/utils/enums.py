"""String-valued enums shared across the library.

Counterpart of ``metrics_tpu/utils/enums.py``: plain ``str`` subclass enums
with case/space/dash-insensitive lookup.
"""
from enum import Enum
from typing import Optional, Union


class EnumStr(str, Enum):
    """String enum with forgiving lookup: case-insensitive, '-'/' ' treated as '_'."""

    @classmethod
    def from_str(cls, value: str) -> Optional["EnumStr"]:
        try:
            return cls[value.replace("-", "_").replace(" ", "_").upper()]
        except KeyError:
            return None

    def __eq__(self, other: Union[str, Enum, None]) -> bool:
        other = other.value if isinstance(other, Enum) else str(other)
        return self.value.lower() == other.lower()

    def __hash__(self) -> int:
        return hash(self.value.lower())


class DataType(EnumStr):
    """Classification input-type taxonomy."""

    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"


class AverageMethod(EnumStr):
    """Averaging strategies for per-class scores."""

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = "none"
    SAMPLES = "samples"


class MDMCAverageMethod(EnumStr):
    """Multi-dim multi-class handling."""

    GLOBAL = "global"
    SAMPLEWISE = "samplewise"
