"""Logging and running loss meters (counterpart of
`mico_tpu/utils/logger.py`).

Mirrors data/utils/logger.py: a module-global LOGGER with the same format,
an optional file handler, and the EMA(0.99) `RunningMeter` the train loop
logs every `log_every` steps (data/utils/pipeline.py:63-81)."""

from __future__ import annotations

import logging

_LOG_FMT = "%(asctime)s - %(levelname)s - %(name)s -   %(message)s"
_DATE_FMT = "%m/%d/%Y %H:%M:%S"
logging.basicConfig(format=_LOG_FMT, datefmt=_DATE_FMT, level=logging.INFO)
LOGGER = logging.getLogger("__main__")


def add_log_to_file(log_path: str) -> None:
    fh = logging.FileHandler(log_path)
    fh.setFormatter(logging.Formatter(_LOG_FMT, datefmt=_DATE_FMT))
    LOGGER.addHandler(fh)


class RunningMeter:
    """Exponential moving average of a scalar (smooth=0.99), reference
    data/utils/logger.py:18-47."""

    def __init__(self, name: str, val=None, smooth: float = 0.99):
        self._name = name
        self._sm = smooth
        self._val = val

    def __call__(self, value: float) -> None:
        value = float(value)
        self._val = (value if self._val is None
                     else self._val * self._sm + value * (1 - self._sm))

    def __str__(self) -> str:
        return f"{self._name}: {self._val:.4f}"

    @property
    def val(self) -> float:
        return self._val if self._val is not None else 0.0

    @property
    def name(self) -> str:
        return self._name
