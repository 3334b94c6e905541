"""Load predictors over a sliding metric window.

Reference: components/src/dynamo/planner/utils/load_predictor.py
(constant / ARIMA / Prophet behind one add_data_point/predict_next
interface). Same interface here; the heavy statistical models are replaced
by closed-form numpy fits, which match the planner's short horizons (one
adjustment interval ahead).

Copy of ``dynamo_tpu/planner/load_predictor.py``.
"""

from __future__ import annotations

from collections import deque

import numpy as np


class BasePredictor:
    def __init__(self, window_size: int = 50):
        self.window: deque[float] = deque(maxlen=window_size)

    def add_data_point(self, value: float) -> None:
        if value is not None and not np.isnan(value):
            self.window.append(float(value))

    def predict_next(self) -> float:
        raise NotImplementedError


class ConstantPredictor(BasePredictor):
    """Next value = last value."""

    def predict_next(self) -> float:
        return self.window[-1] if self.window else 0.0


class MovingAveragePredictor(BasePredictor):
    """Next value = mean of the window."""

    def predict_next(self) -> float:
        return float(np.mean(self.window)) if self.window else 0.0


class LinearTrendPredictor(BasePredictor):
    """Least-squares line through the window, evaluated one step ahead.
    Clamped at zero (a downward trend can't predict negative load)."""

    def predict_next(self) -> float:
        n = len(self.window)
        if n == 0:
            return 0.0
        if n < 3:
            return self.window[-1]
        x = np.arange(n, dtype=np.float64)
        slope, intercept = np.polyfit(x, np.asarray(self.window), 1)
        return float(max(slope * n + intercept, 0.0))


LOAD_PREDICTORS = {
    "constant": ConstantPredictor,
    "moving_average": MovingAveragePredictor,
    "linear": LinearTrendPredictor,
}


def make_predictor(kind: str, window_size: int = 50) -> BasePredictor:
    try:
        return LOAD_PREDICTORS[kind](window_size=window_size)
    except KeyError:
        raise ValueError(f"unknown load predictor {kind!r} "
                         f"(have: {sorted(LOAD_PREDICTORS)})") from None
