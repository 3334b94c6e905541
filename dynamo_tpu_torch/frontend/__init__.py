"""The port's OpenAI HTTP frontend: the service (``frontend.service``) over
its stdlib HTTP/1.1 server (``frontend.http``), the model registry and the
delta/aggregate assembly."""

from dynamo_tpu_torch.frontend.service import HttpService

__all__ = ["HttpService"]
