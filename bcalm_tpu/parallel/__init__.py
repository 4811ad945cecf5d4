"""Multi-chip scaling: device meshes, sharded pipelines, collectives.

The reference is single-node shared-memory (SURVEY.md §3.3: thread pools +
lock-free queues + the filesystem as the only transport).  Here the same
partitioning structure maps onto a jax.sharding Mesh: k-mer-space
partitions become devices, superkmer/glue routing becomes all_to_all over
the device interconnect, histograms become psum.
"""
