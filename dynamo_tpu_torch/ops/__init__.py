"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), each with
its plain PyTorch version beside it; and the attention ops around them.

- paged_attention: flash attention over a block-table-paged KV cache.
- ring_attention: causal attention over the seq ranks of a ring prefill
  (plain torch ops and point-to-point hops; the JAX op is no Pallas
  kernel either).
"""
