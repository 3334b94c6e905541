"""The mocker: an engine simulator with no accelerator (``engine``).

Copy of ``dynamo_tpu/mocker/__init__.py``."""

from dynamo_tpu_torch.mocker.engine import MockEngine, MockEngineArgs

__all__ = ["MockEngine", "MockEngineArgs"]
