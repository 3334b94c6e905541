from dynamo_tpu_torch.preprocessor.preprocessor import OpenAIPreprocessor

__all__ = ["OpenAIPreprocessor"]
