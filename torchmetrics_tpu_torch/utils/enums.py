"""String-valued enums for task dispatch.

Counterpart of ``torchmetrics_tpu/utils/enums.py`` (reference ``enums.py:108``); the port keeps
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
