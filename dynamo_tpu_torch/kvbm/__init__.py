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

import importlib

#: the package's names, each loaded from its module at first use, so that a
#: process that needs only the checkpoint records or the metrics (the
#: mocker) does not import torch through the block mover
_LAZY = {"BlockTransferEngine": "transfer", "DiskBlockPool": "pools",
         "HostBlockPool": "pools", "OffloadManager": "offload"}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
