"""KVBM — tiered KV block manager (port of ``dynamo_tpu/kvbm``, one device).

- **G1 (device)** lives in the engine: the paged cache tensors plus the
  refcounted :class:`~dynamo_tpu_torch.engine.prefix_pool.PrefixPool`.
- **G2 (host)** — :class:`HostBlockPool`: a preallocated host arena keyed
  by sequence hash with LRU eviction.
- **G3 (disk)** — :class:`DiskBlockPool`: file-per-block local-disk tier
  with a byte budget; persists across engine restarts.
- **G4 (remote)** — :class:`~dynamo_tpu_torch.kvbm.remote.RemoteBlockPool`
  against a :class:`~dynamo_tpu_torch.kvbm.remote.RemoteBlockServer`.
- **Offload manager** — :class:`OffloadManager`: write-back offload when
  the device pool evicts a committed block, onboarding of cached prefixes
  at admission, publish-on-commit and stream checkpoints.

Device↔host copies are gathers and in-place scatters over the engine's
cache tensors (:mod:`dynamo_tpu_torch.kvbm.transfer`). The host, disk and
wire formats are the JAX package's byte for byte.
"""

from dynamo_tpu_torch.kvbm.offload import OffloadManager
from dynamo_tpu_torch.kvbm.pools import DiskBlockPool, HostBlockPool
from dynamo_tpu_torch.kvbm.transfer import BlockTransferEngine

__all__ = ["BlockTransferEngine", "DiskBlockPool", "HostBlockPool", "OffloadManager"]
