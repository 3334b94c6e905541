from dynamo_tpu_torch.protocols.common import (
    BackendOutput,
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
    tensor_from_wire,
    tensor_to_wire,
)

__all__ = [
    "BackendOutput",
    "FinishReason",
    "LLMEngineOutput",
    "PreprocessedRequest",
    "SamplingOptions",
    "StopConditions",
    "tensor_from_wire",
    "tensor_to_wire",
]
