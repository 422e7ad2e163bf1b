"""Base class of the port's metrics: the core lifecycle.

Counterpart of ``torchmetrics_tpu/metric.py``: ``add_state`` (``:338``), ``update`` (``:495``),
``forward`` as the reduce-state forward (``_forward_reduce_state_update`` ``:1247-1297``, merged
as in ``_merge_tensor_ladder`` ``:909-934``), ``compute`` with its cache (``:1468``), ``reset``
(``:1500``), ``state_dict`` / ``load_state_dict`` (``:1706``, ``:1727``) and ``to`` (``:1838``).

Subclass contract, as in the JAX package:

- call :meth:`add_state` in ``__init__`` for every accumulator;
- implement ``_update(state, *args, **kwargs) -> dict``, a pure function from the dict of tensor
  states and a batch to the new tensor states; for a list state, the dict holds the entry to
  append under the state's name;
- implement ``_compute(state) -> value``; list states arrive concatenated.

States are replaced, never changed in place, so the members of a ``MetricCollection`` compute
group can hold the leader's tensors by reference.

Every metric holds an explicit ``torch.device``. ``device=None`` means CUDA, and raises when no
CUDA device is present; pass ``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.utils.data import dim_zero_cat
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

_REDUCTIONS = ("sum", "mean", "cat", "min", "max", None)


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device a metric lives on: CUDA unless the caller names another; raises if CUDA is absent."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise TorchMetricsUserError(
                "torchmetrics_tpu_torch metrics run on CUDA unless told otherwise, and no CUDA device is"
                " available; pass device='cpu' to run on the CPU."
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Metric:
    """Base class for all metrics of the port (reference ``metric.py:50``)."""

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None

    def __init__(self, device: Union[str, torch.device, None] = None) -> None:
        self._device = resolve_device(device)
        self._defaults: Dict[str, Union[Tensor, List]] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Optional[str]] = {}
        self._tensors: Dict[str, Tensor] = {}
        self._lists: Dict[str, List[Tensor]] = {}
        self._update_count = 0
        self._update_called = False
        self._computed: Any = None

    # ------------------------------------------------------------------ state
    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def update_called(self) -> bool:
        return self._update_called

    @property
    def update_count(self) -> int:
        return self._update_count

    @property
    def metric_state(self) -> Dict[str, Any]:
        """Current state values (reference ``metric.py:186``)."""
        return {**self._tensors, **{k: list(v) for k, v in self._lists.items()}}

    def add_state(
        self,
        name: str,
        default: Any,
        dist_reduce_fx: Optional[str] = None,
        persistent: bool = False,
    ) -> None:
        """Register an accumulator (reference ``metric.py:194-271``).

        ``default`` is a tensor (tensor state) or an empty list (list state). ``dist_reduce_fx``
        is one of ``sum``, ``mean``, ``cat``, ``min``, ``max`` or None.
        """
        if isinstance(default, list):
            if default:
                raise ValueError("state variable must be a tensor or any empty list (where you can append tensors)")
        else:
            try:
                default = torch.as_tensor(default, device=self._device).clone()
            except (TypeError, ValueError, RuntimeError):
                raise ValueError("state variable must be a tensor or any empty list (where you can append tensors)")
        if dist_reduce_fx not in _REDUCTIONS:
            raise ValueError("`dist_reduce_fx` must be one of ['mean', 'sum', 'cat', 'min', 'max', None]")
        self._defaults[name] = default
        self._persistent[name] = persistent
        self._reductions[name] = dist_reduce_fx
        if isinstance(default, list):
            self._lists[name] = []
        else:
            self._tensors[name] = default

    # ------------------------------------------------------------- subclass API
    def _update(self, state: Dict[str, Tensor], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        raise NotImplementedError

    def _compute(self, state: Dict[str, Any]) -> Any:
        raise NotImplementedError

    def _validate(self, *args: Any, **kwargs: Any) -> None:
        """Host-side input checks; subclasses override this when they validate their inputs."""

    # ------------------------------------------------------------------ engine
    def _coerce(self, args: tuple, kwargs: dict) -> tuple:
        """Inputs as tensors on this metric's device."""

        def conv(x: Any) -> Any:
            if isinstance(x, Tensor):
                return x if x.device == self._device else x.to(self._device)
            if isinstance(x, (np.ndarray, np.generic, int, float, bool)) or (
                isinstance(x, (list, tuple)) and len(x) and isinstance(x[0], (int, float, bool))
            ):
                return torch.as_tensor(x, device=self._device)
            return x

        return tuple(conv(a) for a in args), {k: conv(v) for k, v in kwargs.items()}

    def _default_state(self) -> Dict[str, Tensor]:
        return {k: self._defaults[k] for k in self._tensors}

    def _bump(self) -> None:
        self._update_count += 1
        self._update_called = True
        self._computed = None

    def _append(self, out: Dict[str, Any]) -> None:
        for name, entries in self._lists.items():
            if name in out:
                entry = out[name]
                entries.extend(entry if isinstance(entry, (list, tuple)) else [entry])

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Accumulate a batch into the metric state (reference ``metric.py:458-480``)."""
        args, kwargs = self._coerce(args, kwargs)
        self._validate(*args, **kwargs)
        out = self._update(dict(self._tensors), *args, **kwargs)
        for name in self._tensors:
            if name in out:
                self._tensors[name] = out[name]
        self._append(out)
        self._bump()

    def _merge(self, batch_out: Dict[str, Any]) -> None:
        """Merge a batch-only state into the global state by its reduction (``metric.py:909-934``)."""
        n = self._update_count
        for name, gv in self._tensors.items():
            if name not in batch_out:
                continue
            bv = batch_out[name]
            fx = self._reductions[name]
            if fx == "sum":
                # the batch state includes the default; sum states have zero defaults
                merged = gv + (bv - self._defaults[name])
            elif fx == "mean":
                merged = ((n - 1) * gv + bv) / n
            elif fx == "max":
                merged = torch.maximum(gv, bv)
            elif fx == "min":
                merged = torch.minimum(gv, bv)
            elif fx == "cat":
                merged = torch.cat([gv, bv], dim=0)
            else:
                raise TorchMetricsUserError(f"Cannot reduce states with `dist_reduce_fx={fx}` in forward.")
            self._tensors[name] = merged
        self._append(batch_out)

    def _forward_step(self, args: tuple, kwargs: dict, computes: Sequence[Callable]) -> List[Any]:
        """One reduce-state forward step (``metric.py:1247-1297``): update a default state with the
        batch, evaluate each of ``computes`` on that batch state, then merge it into the global
        state. Compute groups pass every member's ``_compute``, so one update feeds them all."""
        batch_out = self._update(self._default_state(), *args, **kwargs)
        batch_state: Dict[str, Any] = {n: batch_out.get(n, self._defaults[n]) for n in self._tensors}
        for name in self._lists:
            entry = batch_out.get(name)
            if entry is None:
                batch_state[name] = []
            else:
                batch_state[name] = dim_zero_cat(list(entry) if isinstance(entry, (list, tuple)) else [entry])
        values = [self._squeeze_if_scalar(compute(batch_state)) for compute in computes]
        self._bump()
        self._merge(batch_out)
        return values

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate the batch AND return its batch-local value (reference ``metric.py:274-305``)."""
        args, kwargs = self._coerce(args, kwargs)
        self._validate(*args, **kwargs)
        return self._forward_step(args, kwargs, [self._compute])[0]

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    # ----------------------------------------------------------------- compute
    @staticmethod
    def _squeeze_if_scalar(value: Any) -> Any:
        if isinstance(value, Tensor) and value.shape == (1,):
            return value.squeeze()
        return value

    def compute(self) -> Any:
        """Finalise the accumulated state to the metric value (reference ``metric.py:592-622``).

        The value is cached until the next ``update``, ``forward`` or ``reset``.
        """
        if not self._update_called:
            rank_zero_warn(
                f"The ``compute`` method of metric {type(self).__name__} was called before the ``update`` method"
                " which may lead to errors, as metric states have not yet been updated.",
                UserWarning,
            )
        if self._computed is not None:
            return self._computed
        state: Dict[str, Any] = dict(self._tensors)
        for name, entries in self._lists.items():
            state[name] = dim_zero_cat(entries) if entries else []
        self._computed = self._squeeze_if_scalar(self._compute(state))
        return self._computed

    def reset(self) -> None:
        """Restore the default state (reference ``metric.py:672-687``)."""
        self._update_count = 0
        self._update_called = False
        self._computed = None
        for name in self._tensors:
            self._tensors[name] = self._defaults[name]
        for name in self._lists:
            self._lists[name] = []

    # ------------------------------------------------------------- persistence
    def _as_state(self, name: str, value: Any, list_dtype: Optional[torch.dtype] = None) -> Tensor:
        """``value`` as a state tensor on this metric's device, in the dtype of the state's default
        (``list_dtype`` for the entries of a list state, or their own). Float values bound for an
        integer state must be whole numbers: counts carried as float32 (the JAX package's) convert
        exactly, anything else raises."""
        default = self._defaults[name]
        dtype = default.dtype if isinstance(default, Tensor) else list_dtype
        tensor = value if isinstance(value, Tensor) else torch.from_numpy(np.array(value))
        if dtype is not None and not dtype.is_floating_point and tensor.is_floating_point():
            if not bool(torch.all(tensor == torch.round(tensor))):
                raise ValueError(f"{type(self).__name__} state {name!r} holds counts, but the values given are not whole")
        return tensor.to(device=self._device, dtype=dtype)

    def _set_states(self, values: Dict[str, Any]) -> None:
        """Replace the named states; a list state takes a sequence of entries."""
        for name, value in values.items():
            if name in self._lists:
                self._lists[name] = [self._as_state(name, e) for e in value]
            elif name in self._tensors:
                self._tensors[name] = self._as_state(name, value)
            else:
                raise KeyError(f"{type(self).__name__} has no state {name!r}; its states are {sorted(self._defaults)}")
        if values:
            self._update_called = True
            self._computed = None

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "", keep_vars: bool = False) -> dict:
        """Checkpoint dict of the persistent states (reference ``metric.py:831``).

        Beyond the reference format it holds ``_update_count``, which mean reductions need.
        """
        destination = destination if destination is not None else {}
        for name, persistent in self._persistent.items():
            if not persistent:
                continue
            if name in self._tensors:
                v = self._tensors[name]
                destination[prefix + name] = v if keep_vars else v.detach().clone()
            else:
                destination[prefix + name] = [e if keep_vars else e.detach().clone() for e in self._lists[name]]
        if any(self._persistent.values()):
            destination[prefix + "_update_count"] = self._update_count
        return destination

    def load_state_dict(self, state_dict: dict, strict: bool = True, prefix: str = "") -> None:
        """Restore the persistent states from a checkpoint dict (reference ``metric.py:863``)."""
        restored_count = state_dict.get(prefix + "_update_count")
        values = {}
        for name, persistent in self._persistent.items():
            if prefix + name in state_dict:
                values[name] = state_dict[prefix + name]
            elif strict and persistent:
                raise RuntimeError(f"Missing key {name!r} in state_dict")
        self._set_states(values)
        if values:
            self._update_count = int(restored_count) if restored_count is not None else max(self._update_count, 1)
            self._update_called = self._update_count > 0

    def to(self, device: Union[str, torch.device]) -> "Metric":
        """Move every state and default to ``device`` (reference ``_apply``, ``metric.py:776-824``)."""
        dev = resolve_device(device)
        self._tensors = {k: v.to(dev) for k, v in self._tensors.items()}
        self._lists = {k: [e.to(dev) for e in v] for k, v in self._lists.items()}
        self._defaults = {k: v.to(dev) if isinstance(v, Tensor) else v for k, v in self._defaults.items()}
        if isinstance(self._computed, Tensor):
            self._computed = self._computed.to(dev)
        self._device = dev
        return self

    # ----------------------------------------------------------------- helpers
    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep only the kwargs this metric's ``_update`` accepts (reference ``metric.py:882-901``)."""
        if not kwargs:
            return kwargs
        params = inspect.signature(self._update).parameters
        if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
            return kwargs
        return {k: v for k, v in kwargs.items() if k in params and k != "state"}

    def __repr__(self) -> str:
        return f"{type(self).__name__}(device={self._device})"
