from mfm_tpu_torch.parallel.mesh import (
    ChainMesh,
    chain_sharding,
    make_mesh,
    replicate,
    replicated,
    shard_chains,
)

__all__ = [
    "ChainMesh",
    "chain_sharding",
    "make_mesh",
    "replicate",
    "replicated",
    "shard_chains",
]

# mfm_tpu_torch.parallel.distributed (seed replication across processes) is
# not imported here: a process imports it at its start and brings the group
# up itself (initialize_distributed). parallel.mesh imports torch.distributed
# only inside the functions that need a group.
