"""Sequence-position weight schedulers (the port of
rsq_tpu.quantize.schedulers, host numpy as there).

Position-based weight curves (a linear ramp, a cosine end-points peak, a
start peak), min-max normalized into [min_value, max_value]
(fake_quant/schedulers.py of the method's reference).  No module of either
package imports them: they are API surface, an alternative
importance-weighting source.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _normalize(w, min_value, max_value, quantile_value=None):
    w = np.asarray(w, np.float64)
    if quantile_value is not None:
        q_hi = max(quantile_value, 1 - quantile_value)
        lo, hi = np.quantile(w, [1 - q_hi, q_hi])
    else:
        lo, hi = w.min(), w.max()
    w = (w - lo) / max(hi - lo, 1e-20)
    w = w * (max_value - min_value) + min_value
    return np.clip(w, min_value, max_value)


@dataclasses.dataclass(frozen=True)
class LinearScheduler:
    start_value: float
    end_value: float

    def get_ratio(self, max_length: int) -> np.ndarray:
        w = np.linspace(self.start_value, self.end_value, max_length)
        return _normalize(w, min(self.start_value, self.end_value),
                          max(self.start_value, self.end_value))


@dataclasses.dataclass(frozen=True)
class EndPointsPeakScheduler:
    min_value: float
    max_value: float
    factor: int = 6

    def get_ratio(self, max_length: int) -> np.ndarray:
        x = np.linspace(0, max_length - 1, max_length)
        y = np.cos(x * np.pi / (max_length - 1)) ** self.factor
        return _normalize(y, self.min_value, self.max_value)


@dataclasses.dataclass(frozen=True)
class StartPeakScheduler:
    min_value: float
    max_value: float
    factor: int = 6

    def get_ratio(self, max_length: int) -> np.ndarray:
        x = np.linspace(0, max_length - 1, max_length)
        y = 1.0 / ((x + 1) ** self.factor)
        return _normalize(y, self.min_value, self.max_value)


def make_scheduler(name: str, **params):
    table = {"linear": LinearScheduler, "endpoints_peak": EndPointsPeakScheduler,
             "start_peak": StartPeakScheduler}
    return table[name](**params)
