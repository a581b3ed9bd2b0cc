"""Multi-GPU counting: the (data, seq) mesh of positions, its collectives,
the halo, the routed count steps and the multi-process count.

Counterpart of kmer_tpu/parallel/.  kmer_tpu runs one controller over a
jax mesh (shard_map) and joins processes with jax.distributed; here a
Mesh is a grid of positions, each with a torch.device, run by one
process or spread over a torch.distributed process group (mesh.Mesh,
comm).  Modules: mesh (positions and how a batch splits over them), comm
(every collective), halo (seq shards' neighbour columns), distributed
(the count steps: routed pairs, sorted stream, dense), multihost
(initialize and count_fasta_multihost).
"""
