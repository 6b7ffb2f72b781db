"""din [arXiv:1706.06978]: target attention over a 100-item behavior
sequence; embed_dim=18, attention MLP 80-40, main MLP 200-80."""
import dataclasses

from ..models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="din", kind="din", n_sparse=1, embed_dim=18,
    total_vocab=1 << 24, mlp_dims=(200, 80), attn_mlp_dims=(80, 40),
    seq_len=100, n_dense=0)

REDUCED = dataclasses.replace(CONFIG, total_vocab=4096, seq_len=16,
                              mlp_dims=(32, 16), attn_mlp_dims=(16, 8))
