from dynamo_tpu_torch.router.events import BlockStored, BlockRemoved, KvCacheEvent, RouterEvent

__all__ = ["BlockStored", "BlockRemoved", "KvCacheEvent", "RouterEvent"]
