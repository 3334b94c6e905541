from dynamo_tpu_torch.backend.detokenizer import DetokenizerBackend

__all__ = ["DetokenizerBackend"]
