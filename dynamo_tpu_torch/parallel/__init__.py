"""Tensor parallelism over ``torch.distributed``: the port of the JAX
package's "model" mesh axis (``dynamo_tpu/parallel/mesh.py``), one
process per rank."""
