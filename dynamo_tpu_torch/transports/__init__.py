from dynamo_tpu_torch.transports.wire import Frame, MsgpackConnection
from dynamo_tpu_torch.transports.coordinator import CoordinatorServer
from dynamo_tpu_torch.transports.client import CoordinatorClient

__all__ = ["Frame", "MsgpackConnection", "CoordinatorServer", "CoordinatorClient"]
