from dynamo_tpu_torch.tokenizer.base import (
    BaseTokenizer,
    BPETokenizer,
    ByteTokenizer,
    DecodeStream,
    load_tokenizer,
)

__all__ = ["BaseTokenizer", "BPETokenizer", "ByteTokenizer", "DecodeStream",
           "load_tokenizer"]
