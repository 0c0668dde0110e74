from tpuseg_torch.parallel.mesh import (
    any_rank,
    global_sum,
    init_distributed,
    multihost_sum,
    per_rank,
    process_count,
    process_index,
    sync_hosts,
)

__all__ = ["any_rank", "global_sum", "init_distributed", "multihost_sum",
           "per_rank", "process_count", "process_index", "sync_hosts"]
