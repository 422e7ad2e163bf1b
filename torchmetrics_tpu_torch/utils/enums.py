"""String-valued enums for task dispatch.

Counterpart of ``torchmetrics_tpu/utils/enums.py`` (reference ``enums.py:56-154``); the port keeps
its own copy so that it imports nothing of the JAX package.
"""
from __future__ import annotations

from enum import Enum


class EnumStr(str, Enum):
    """Base for case-insensitive string enums (``from_str`` resolves ``"Macro"`` to ``MACRO``)."""

    @staticmethod
    def _name() -> str:
        return "Task"

    @classmethod
    def from_str(cls, value: str, source: str = "key") -> "EnumStr":
        try:
            return cls[value.replace("-", "_").upper()]
        except KeyError:
            valid = [m.lower() for m in cls.__members__]
            raise ValueError(f"Invalid {cls._name()}: expected one of {valid}, but got {value}.") from None

    def __str__(self) -> str:
        return self.value.lower()


class DataType(EnumStr):
    """Type of an input batch (``enums.py:30``, reference ``enums.py:56``)."""

    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"

    @staticmethod
    def _name() -> str:
        return "Data type"


class AverageMethod(EnumStr):
    """Averaging strategy over classes (``enums.py:43``, reference ``enums.py:74``)."""

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = None  # type: ignore[assignment]
    SAMPLES = "samples"

    @staticmethod
    def _name() -> str:
        return "Average method"


class MDMCAverageMethod(EnumStr):
    """Multi-dim multi-class averaging (``enums.py:57``, reference ``enums.py:97``)."""

    GLOBAL = "global"
    SAMPLEWISE = "samplewise"


class ClassificationTask(EnumStr):
    """Classification task dispatch key (reference ``enums.py:108``)."""

    BINARY = "binary"
    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"

    @staticmethod
    def _name() -> str:
        return "Classification task"


class ClassificationTaskNoBinary(EnumStr):
    """Task dispatch key of the metrics that have no binary form (``torchmetrics_tpu/utils/enums.py:76``)."""

    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"

    @staticmethod
    def _name() -> str:
        return "Classification task"


class ClassificationTaskNoMultilabel(EnumStr):
    """Task dispatch key of the metrics that have no multilabel form (``torchmetrics_tpu/utils/enums.py:85``)."""

    BINARY = "binary"
    MULTICLASS = "multiclass"

    @staticmethod
    def _name() -> str:
        return "Classification task"
