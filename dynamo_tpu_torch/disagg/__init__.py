"""Disaggregated prefill/decode serving — copy of ``dynamo_tpu/disagg/``.

Separate prefill and decode workers with a KV handoff:

- The prefill worker computes the prompt's KV, **pins + stages** the
  chain's blocks to host memory (in one shot, or wave by wave while the
  prefill still runs), and returns ``kv_transfer_params`` (the block hash
  chain, a transfer id and its shard server's endpoint with its (layer,
  head) box).
- The decode worker pulls exactly those slices over TCP from the shard
  server (disagg/sharded.py), injects them as matchable prefix-cache
  entries, and the scheduler then admits the request with the whole
  prompt (minus the tail) resident. On one card the handoff goes through
  the host: device → host staging → loopback TCP → host → device.
- Decode-first and conditional: short prompts skip the remote hop, and any
  prefill failure falls back to local prefill.

Engines with more than one rank (tp > 1) refuse the handoff (ROADMAP item
14).
"""

from dynamo_tpu_torch.disagg.handlers import DisaggDecodeHandler
from dynamo_tpu_torch.disagg.receiver import pull_and_import
from dynamo_tpu_torch.disagg.source import KvTransferSource

__all__ = ["DisaggDecodeHandler", "KvTransferSource", "pull_and_import"]
