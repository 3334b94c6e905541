"""Performance interpolators over profiled sweep data.

Reference: components/src/dynamo/planner/utils/perf_interpolation.py —
PrefillInterpolator (TTFT + throughput/gpu vs ISL, quadratic fit over npz
sweep data) and DecodeInterpolator (ITL + throughput/gpu over a
(concurrency, context_length) grid). Same math; throughput is tokens/s per
card and a "replica" is one engine instance spanning ``chips_per_replica``
cards (its tensor-parallel group), so replica math divides by the group's
size exactly like the reference divides by engine_num_gpu.

Data comes from a dict/npz of 1-D sweep arrays (the profiler writes the
same keys) — no fixed file format dependency.

Copy of ``dynamo_tpu/planner/interpolator.py``.
"""

from __future__ import annotations

import numpy as np


class PrefillInterpolator:
    """Fit TTFT(isl) and prefill throughput/chip(isl) from sweep samples.

    Quadratic in log-space would over-fit the handful of sweep points the
    profiler produces; piecewise-linear interpolation with edge clamping
    (np.interp semantics) is monotone and safe to extrapolate flat.
    """

    def __init__(self, isl: np.ndarray, ttft_s: np.ndarray, thpt_per_chip: np.ndarray):
        order = np.argsort(isl)
        self.isl = np.asarray(isl, np.float64)[order]
        self.ttft_s = np.asarray(ttft_s, np.float64)[order]
        self.thpt = np.asarray(thpt_per_chip, np.float64)[order]
        if len(self.isl) == 0:
            raise ValueError("empty prefill sweep")

    @classmethod
    def from_data(cls, data: dict) -> "PrefillInterpolator":
        return cls(data["prefill_isl"], data["prefill_ttft_s"],
                   data["prefill_thpt_per_chip"])

    def interpolate_ttft(self, isl: float) -> float:
        return float(np.interp(isl, self.isl, self.ttft_s))

    def interpolate_thpt_per_chip(self, isl: float) -> float:
        return float(np.interp(isl, self.isl, self.thpt))


class DecodeInterpolator:
    """ITL and decode throughput/chip over a (concurrency, context) grid."""

    def __init__(self, concurrency: np.ndarray, context: np.ndarray,
                 itl_s: np.ndarray, thpt_per_chip: np.ndarray):
        # grids: itl_s[i, j] for concurrency[i] × context[j]
        self.concurrency = np.asarray(concurrency, np.float64)
        self.context = np.asarray(context, np.float64)
        self.itl_s = np.asarray(itl_s, np.float64)
        self.thpt = np.asarray(thpt_per_chip, np.float64)
        assert self.itl_s.shape == (len(self.concurrency), len(self.context))
        assert self.thpt.shape == self.itl_s.shape

    @classmethod
    def from_data(cls, data: dict) -> "DecodeInterpolator":
        return cls(data["decode_concurrency"], data["decode_context"],
                   data["decode_itl_s"], data["decode_thpt_per_chip"])

    def _interp_context(self, grid: np.ndarray, context: float) -> np.ndarray:
        """Interpolate each concurrency row at the given context length."""
        return np.array([np.interp(context, self.context, row) for row in grid])

    def interpolate_itl(self, concurrency: float, context: float) -> float:
        col = self._interp_context(self.itl_s, context)
        return float(np.interp(concurrency, self.concurrency, col))

    def interpolate_thpt_per_chip(self, concurrency: float, context: float) -> float:
        col = self._interp_context(self.thpt, context)
        return float(np.interp(concurrency, self.concurrency, col))

    def find_best_throughput_per_chip(self, itl_s: float, context: float) -> tuple[float, float]:
        """Highest throughput/chip whose ITL stays within the SLA at this
        context length → (throughput_per_chip, concurrency). Falls back to
        the lowest-concurrency point if even that misses the SLA
        (reference: find_best_throughput_per_gpu)."""
        itl_col = self._interp_context(self.itl_s, context)
        thpt_col = self._interp_context(self.thpt, context)
        ok = itl_col <= itl_s
        if not ok.any():
            i = int(np.argmin(itl_col))
            return float(thpt_col[i]), float(self.concurrency[i])
        i = int(np.argmax(np.where(ok, thpt_col, -np.inf)))
        return float(thpt_col[i]), float(self.concurrency[i])


def synthetic_profile(
    base_ttft_s: float = 0.1,
    prefill_rate_tokps: float = 8000.0,
    base_itl_s: float = 0.01,
    chips_per_replica: int = 1,
) -> dict:
    """An analytic profile for tests/dryruns: linear TTFT in ISL, ITL that
    degrades with concurrency and context. Its numbers are synthetic, no
    card's measurement: it stands in for a real sweep until the profiler
    has run on the card (``planner/profiler.py``)."""
    isl = np.array([128, 512, 2048, 8192], np.float64)
    conc = np.array([1, 4, 16, 64], np.float64)
    ctx = np.array([256, 1024, 4096, 16384], np.float64)
    itl = base_itl_s * (1 + 0.02 * conc[:, None]) * (1 + ctx[None, :] / 32768)
    # tokens/s/chip for decode: concurrency / itl, per chip
    thpt = (conc[:, None] / itl) / chips_per_replica
    return {
        "prefill_isl": isl,
        "prefill_ttft_s": base_ttft_s + isl / prefill_rate_tokps,
        "prefill_thpt_per_chip": np.full_like(isl, prefill_rate_tokps / chips_per_replica),
        "decode_concurrency": conc,
        "decode_context": ctx,
        "decode_itl_s": itl,
        "decode_thpt_per_chip": thpt,
    }
