from dynamo_tpu_torch.tokenizer.base import (
    BaseTokenizer,
    BPETokenizer,
    ByteTokenizer,
    DecodeStream,
    guided_vocab,
    load_tokenizer,
)

__all__ = ["BaseTokenizer", "BPETokenizer", "ByteTokenizer", "DecodeStream",
           "guided_vocab", "load_tokenizer"]
