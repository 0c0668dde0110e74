from tpuseg_torch.parallel.mesh import (
    Mesh,
    any_rank,
    global_sum,
    init_distributed,
    make_mesh,
    multihost_sum,
    per_rank,
    process_count,
    process_index,
    shard_batch_spatial,
    sync_hosts,
)

__all__ = ["Mesh", "any_rank", "global_sum", "init_distributed",
           "make_mesh", "multihost_sum", "per_rank", "process_count",
           "process_index", "shard_batch_spatial", "sync_hosts"]
