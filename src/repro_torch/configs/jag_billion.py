"""JAG production config (the paper's own system): billion-scale
shard-and-merge filtered search over the production mesh. 256 shards x
2^22 points x d=128 bf16, R=64 (+16 spare), range filters."""
from ..core.jag import JAGConfig
from .registry import ArchSpec

CONFIG = JAGConfig(degree=64, ls_build=96, alpha=1.2,
                   threshold_quantiles=(1.0, 0.01, 0.0),
                   batch_size=128, cand_pool=192)

REDUCED = JAGConfig(degree=12, ls_build=24, batch_size=128, cand_pool=64)

SPEC = ArchSpec(id="jag", family="jag",
                make_config=lambda shape=None: CONFIG,
                make_reduced=lambda: REDUCED,
                notes="the paper's index at production scale")
