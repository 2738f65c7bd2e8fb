from .mesh import (
    BATCH, DATA_AXIS, EXPERT_AXIS, FSDP_AXIS, PIPE_AXIS, SEQ_AXIS, TENSOR_AXIS,
    WORLD, Mesh, MeshContext, MeshSpec, ShardSpec, all_gather, all_gather_axis,
    all_reduce_axis, all_reduce_sum, fetch_global, gather_tree,
    initialize_distributed, make_mesh, mesh_shards, num_data_shards,
    process_shard, reduce_scatter_axis, ring_shift, shard_tree,
)
