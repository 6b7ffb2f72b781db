"""Distribution substrate on PyTorch (counterpart of ``repro.distributed``):
the logical-axis rules and the device-list mesh with row-wise shard
placement."""
from .sharding import (Rules, as_mesh, current_rules, logical_constraint,
                       make_rules, put_db_sharded, resolve_spec, serve_mesh,
                       shard_shape, tree_shardings, use_rules)

__all__ = ["Rules", "as_mesh", "current_rules", "logical_constraint",
           "make_rules", "put_db_sharded", "resolve_spec", "serve_mesh",
           "shard_shape", "tree_shardings", "use_rules"]
