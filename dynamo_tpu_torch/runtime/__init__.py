from dynamo_tpu_torch.runtime.runtime import DistributedRuntime, Endpoint, Component, Namespace
from dynamo_tpu_torch.runtime.client import EndpointClient, PushRouter, RouterMode

__all__ = [
    "DistributedRuntime",
    "Namespace",
    "Component",
    "Endpoint",
    "EndpointClient",
    "PushRouter",
    "RouterMode",
]
