"""The radial domain decomposition on ``torch.distributed`` (the JAX
package's explicit shard_map path, ``fargocpt_tpu/parallel/``): one
process per rank, each stepping a window of the grid."""
