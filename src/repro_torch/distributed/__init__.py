"""Distribution substrate on PyTorch: the serving part of
``repro.distributed`` (the device-list mesh and row-wise shard placement)."""
from .sharding import as_mesh, put_db_sharded, serve_mesh

__all__ = ["as_mesh", "put_db_sharded", "serve_mesh"]
