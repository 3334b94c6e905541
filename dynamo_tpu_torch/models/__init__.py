"""Model configs, the Llama forward over a paged KV cache, and the loader."""
