# Distribution layer of the port: logical-axis sharding context,
# parameter/state sharding tables, the shard_map of collectives over a
# torch.distributed mesh, split-KV decode attention, and pipeline
# parallelism.  Every entry point degrades to a no-op on one rank (a
# group of one skips its collective), so a 1 x 1 mesh is bit-equal to no
# mesh.
