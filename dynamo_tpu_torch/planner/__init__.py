"""SLA planner: observe load → predict → size the worker fleet.

Fills the role of the reference's planner component
(reference: components/src/dynamo/planner/ — planner_core.py decision loop,
utils/load_predictor.py predictors, utils/perf_interpolation.py
interpolators, kubernetes/virtual connectors):

- :mod:`load_predictor` — constant / moving-average / linear-trend
  predictors over the recent metric window (the reference's ARIMA/Prophet
  fill the same role; a linear trend covers the interpolation-scale
  horizons the planner uses).
- :mod:`interpolator` — TTFT/throughput-per-card vs ISL (prefill) and
  ITL/throughput-per-card vs (concurrency, context) (decode), fitted from
  profiled sweep data (:mod:`profiler` sweeps an engine on the card).
- :mod:`planner_core` — replica calculation with SLA targets + correction
  factors for queueing (observed TTFT/ITL vs interpolated).
- :mod:`scrape` — per-interval rates from one frontend's ``/metrics`` or
  from the fleet aggregator's rollups (``obs/fleet.py``).
- :mod:`connector` — VirtualConnector (decisions → coordinator KV for an
  external orchestrator) and ProcessConnector (spawns/stops local worker
  processes — the zero-K8s analog of patching DynamoGraphDeployment
  replicas).

Copy of ``dynamo_tpu/planner/__init__.py``.
"""

from dynamo_tpu_torch.planner.connector import ProcessConnector, VirtualConnector
from dynamo_tpu_torch.planner.interpolator import DecodeInterpolator, PrefillInterpolator
from dynamo_tpu_torch.planner.load_predictor import LOAD_PREDICTORS, make_predictor
from dynamo_tpu_torch.planner.planner_core import Metrics, Planner, PlannerConfig

__all__ = [
    "DecodeInterpolator", "LOAD_PREDICTORS", "Metrics", "Planner",
    "PlannerConfig", "PrefillInterpolator", "ProcessConnector",
    "VirtualConnector", "make_predictor",
]
