"""Planner decision loop: metrics → prediction → replica targets.

Reference: components/src/dynamo/planner/utils/planner_core.py — per
adjustment interval: record observed num_req/ISL/OSL, predict the next
interval's load, correct for queueing (observed TTFT/ITL vs the
interpolated no-queueing value), then size prefill and decode fleets:

    prefill_replicas = ceil(req_rate·ISL / (prefill_thpt_per_chip·chips))
    decode_replicas  = ceil(req_rate·OSL / (best_decode_thpt_per_chip·chips))

where best_decode_thpt is the highest throughput meeting the (corrected)
ITL SLA at the predicted context length.

Copy of ``dynamo_tpu/planner/planner_core.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from dynamo_tpu_torch.planner.interpolator import DecodeInterpolator, PrefillInterpolator
from dynamo_tpu_torch.planner.load_predictor import make_predictor
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("planner")


@dataclass
class Metrics:
    """One adjustment interval's observations (reference: planner_core.py
    Metrics)."""

    num_req: float = 0.0       # requests completed this interval
    isl: float = 0.0           # mean input sequence length
    osl: float = 0.0           # mean output sequence length
    ttft_s: float | None = None
    itl_s: float | None = None

    def is_valid(self) -> bool:
        return self.num_req > 0 and self.isl > 0 and self.osl > 0


@dataclass
class PlannerConfig:
    ttft_sla_s: float = 0.5
    itl_sla_s: float = 0.05
    adjustment_interval_s: float = 30.0
    chips_per_prefill_replica: int = 1
    chips_per_decode_replica: int = 1
    min_replicas: int = 1
    max_replicas: int = 64
    load_predictor: str = "moving_average"
    prediction_window: int = 20
    # Max total chips the fleet may use (0 = unbounded); prefill is trimmed
    # first when over budget, mirroring the reference's gpu-budget clamp.
    chip_budget: int = 0


@dataclass
class Decision:
    prefill_replicas: int
    decode_replicas: int
    reason: str = ""


@dataclass
class Planner:
    config: PlannerConfig
    prefill_interp: PrefillInterpolator
    decode_interp: DecodeInterpolator
    p_correction: float = 1.0
    d_correction: float = 1.0
    _predictors: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        for key in ("num_req", "isl", "osl"):
            self._predictors[key] = make_predictor(
                self.config.load_predictor, self.config.prediction_window)

    # ------------------------------------------------------------------
    def observe(self, m: Metrics) -> None:
        if not m.is_valid():
            return
        self._predictors["num_req"].add_data_point(m.num_req)
        self._predictors["isl"].add_data_point(m.isl)
        self._predictors["osl"].add_data_point(m.osl)
        # Correction factors: how much worse the observed latency is than
        # the no-queueing interpolation at this operating point
        # (reference: correct prediction factors, planner_core.py:424).
        if m.ttft_s:
            expected = self.prefill_interp.interpolate_ttft(m.isl)
            if expected > 0:
                self.p_correction = m.ttft_s / expected
        if m.itl_s:
            expected = self.decode_interp.interpolate_itl(1.0, m.isl + m.osl / 2)
            if expected > 0:
                self.d_correction = m.itl_s / expected

    def predict_load(self) -> tuple[float, float, float]:
        return (self._predictors["num_req"].predict_next(),
                self._predictors["isl"].predict_next(),
                self._predictors["osl"].predict_next())

    # ------------------------------------------------------------------
    def compute_replicas(self, num_req: float, isl: float, osl: float) -> Decision:
        cfg = self.config
        if num_req <= 0 or isl <= 0:
            return Decision(cfg.min_replicas, cfg.min_replicas, "no load")

        # Prefill: queueing bias scales required throughput linearly
        # (reference: min(1, p_correction) damping on the way down only).
        p_thpt_needed = (num_req * isl / cfg.adjustment_interval_s
                         * max(1.0, self.p_correction))
        p_cap = (self.prefill_interp.interpolate_thpt_per_chip(isl)
                 * cfg.chips_per_prefill_replica)
        num_p = math.ceil(p_thpt_needed / max(p_cap, 1e-9))

        # Decode: tighten the ITL target by the observed correction, find
        # the best operating point meeting it, then size for token rate.
        corrected_itl = cfg.itl_sla_s / max(self.d_correction, 1e-9) \
            if self.d_correction > 1 else cfg.itl_sla_s
        d_thpt_per_chip, conc = self.decode_interp.find_best_throughput_per_chip(
            corrected_itl, isl + osl / 2)
        d_thpt_needed = num_req * osl / cfg.adjustment_interval_s
        d_cap = d_thpt_per_chip * cfg.chips_per_decode_replica
        num_d = math.ceil(d_thpt_needed / max(d_cap, 1e-9))

        num_p = min(max(num_p, cfg.min_replicas), cfg.max_replicas)
        num_d = min(max(num_d, cfg.min_replicas), cfg.max_replicas)
        if cfg.chip_budget > 0:
            while (num_p * cfg.chips_per_prefill_replica
                   + num_d * cfg.chips_per_decode_replica > cfg.chip_budget
                   and (num_p > cfg.min_replicas or num_d > cfg.min_replicas)):
                if num_p > cfg.min_replicas:
                    num_p -= 1
                else:
                    num_d -= 1
        reason = (f"pred: {num_req:.1f} req × isl {isl:.0f} / osl {osl:.0f}; "
                  f"p_corr {self.p_correction:.2f} d_corr {self.d_correction:.2f}; "
                  f"decode op point conc={conc:.0f}")
        return Decision(num_p, num_d, reason)

    def plan(self) -> Decision:
        """One decision from the current prediction state."""
        num_req, isl, osl = self.predict_load()
        d = self.compute_replicas(num_req, isl, osl)
        log.info("plan: prefill=%d decode=%d (%s)",
                 d.prefill_replicas, d.decode_replicas, d.reason)
        return d
