from .mesh import (
    DATA_AXIS, EXPERT_AXIS, FSDP_AXIS, PIPE_AXIS, SEQ_AXIS, TENSOR_AXIS,
    Mesh, MeshContext, MeshSpec, all_gather, all_reduce_sum, fetch_global,
    initialize_distributed, make_mesh, mesh_shards, num_data_shards,
    process_shard,
)
