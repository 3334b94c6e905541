"""The port's serving engine: paged KV cache, continuous-batching
scheduler, sampling, and the model runner / engine core / async facade
(``engine.engine``)."""
