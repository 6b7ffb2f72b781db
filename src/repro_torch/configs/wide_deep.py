"""wide-deep [arXiv:1606.07792]: 40 sparse fields, embed_dim=32,
MLP 1024-512-256, concat interaction + wide linear branch."""
import dataclasses

from ..models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="wide-deep", kind="wide_deep", n_sparse=40, embed_dim=32,
    total_vocab=1 << 25, mlp_dims=(1024, 512, 256), n_dense=13)

REDUCED = dataclasses.replace(CONFIG, total_vocab=4096,
                              mlp_dims=(64, 32), n_dense=4)
