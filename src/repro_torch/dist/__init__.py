"""Distribution substrate of the port: logical-axis mesh rules
(`axes`), tensor-parallel sharding and collectives on torch.distributed
(`shard`), rank 0's lead of a tensor-parallel engine (`lockstep`), and
inter-pod gradient compression (`compress`)."""
from .axes import (MULTI_POD_RULES, SERVE_RULES, SINGLE_POD_RULES,
                   MeshRules, rules_for_mesh, sanitize_pspec)
from .compress import (compress_decompress_roundtrip, compress_with_feedback,
                       init_error_state)
from .lockstep import (FleetChannel, Lockstep, LockstepError, follow,
                       follow_all, reset_tick_counts, tick_counts,
                       tick_seconds)
from .shard import (collective_counts, collective_seconds, fleet_group,
                    leaf_pspec, rank_params, recurrent_splits,
                    replica_groups, reset_collective_counts, serve_group,
                    shard_specs, shard_state_specs, shard_tree,
                    tp_all_gather, tp_all_reduce, use_tp)

__all__ = ["MeshRules", "MULTI_POD_RULES", "SERVE_RULES", "SINGLE_POD_RULES",
           "rules_for_mesh", "sanitize_pspec",
           "compress_decompress_roundtrip", "compress_with_feedback",
           "init_error_state",
           "collective_counts", "collective_seconds",
           "FleetChannel", "Lockstep", "LockstepError", "follow",
           "follow_all", "fleet_group",
           "reset_tick_counts",
           "tick_counts", "tick_seconds",
           "leaf_pspec", "rank_params", "recurrent_splits",
           "replica_groups",
           "reset_collective_counts", "serve_group", "shard_specs",
           "shard_state_specs", "shard_tree", "tp_all_gather",
           "tp_all_reduce", "use_tp"]
