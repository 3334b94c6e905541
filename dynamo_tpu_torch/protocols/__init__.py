from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)

__all__ = [
    "FinishReason",
    "LLMEngineOutput",
    "PreprocessedRequest",
    "SamplingOptions",
    "StopConditions",
]
