"""Engine error types (copy of ``dynamo_tpu/engine/errors.py``)."""


class NoFreeBlocks(Exception):
    """Block pool exhausted (caller should preempt, queue, or reject)."""
