from repro_torch.core.ddl.allreduce import (ddl_reduce_tree, flat_allreduce,
                                            hierarchical_allreduce_flat,
                                            hierarchical_reduce_scatter_flat,
                                            init_error_feedback, make_buckets,
                                            pack, unpack, pack_spec)
from repro_torch.core.ddl.topology import (ddl_allreduce_time, flat_allreduce_time,
                                           fabrics, AXIS_FABRIC)
from repro_torch.core.ddl.compress import compress, decompress, compressed_allreduce_pod
from repro_torch.core.ddl.overlap import (make_grad_reduce_hook, make_stack_hooks,
                                          reduce_tree_bucketed)

__all__ = ["ddl_reduce_tree", "flat_allreduce", "hierarchical_allreduce_flat",
           "hierarchical_reduce_scatter_flat", "init_error_feedback",
           "make_buckets", "pack", "unpack", "pack_spec", "ddl_allreduce_time",
           "flat_allreduce_time", "fabrics", "AXIS_FABRIC", "compress",
           "decompress", "compressed_allreduce_pod", "make_grad_reduce_hook",
           "make_stack_hooks", "reduce_tree_bucketed"]
