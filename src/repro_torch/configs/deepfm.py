"""deepfm [arXiv:1703.04247]: 39 sparse fields, embed_dim=10,
MLP 400-400-400, FM interaction. Criteo-scale table: 2^25 rows."""
import dataclasses

from ..models.recsys import RecsysConfig
from .registry import ArchSpec

CONFIG = RecsysConfig(
    name="deepfm", kind="deepfm", n_sparse=39, embed_dim=10,
    total_vocab=1 << 25, mlp_dims=(400, 400, 400), n_dense=13)

REDUCED = dataclasses.replace(CONFIG, total_vocab=4096,
                              mlp_dims=(32, 32), n_dense=4)

SPEC = ArchSpec(id="deepfm", family="recsys",
                make_config=lambda shape=None: CONFIG,
                make_reduced=lambda: REDUCED,
                notes="FM sum-square trick + deep MLP")
