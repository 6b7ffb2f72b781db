"""fm [Rendle ICDM'10]: pure factorization machine, 39 fields,
embed_dim=10, pairwise interactions via the O(nk) sum-square trick."""
import dataclasses

from ..models.recsys import RecsysConfig
from .registry import ArchSpec

CONFIG = RecsysConfig(
    name="fm", kind="fm", n_sparse=39, embed_dim=10,
    total_vocab=1 << 25, n_dense=0)

REDUCED = dataclasses.replace(CONFIG, total_vocab=4096)

SPEC = ArchSpec(id="fm", family="recsys",
                make_config=lambda shape=None: CONFIG,
                make_reduced=lambda: REDUCED,
                notes="FM 2-way, sum-square trick")
