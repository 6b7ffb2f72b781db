"""gemma-7b [arXiv:2403.08295; hf:google/gemma-7b].

28L d_model=3072 16H (kv=16) head_dim=256 d_ff=24576 vocab=256000; GeGLU
activation, (1+w) RMSNorm, sqrt(d_model) embedding scaling.
"""
import dataclasses
import math

from ..models.transformer import LMConfig
from .registry import ArchSpec

CONFIG = LMConfig(
    name="gemma-7b", n_layers=28, d_model=3072, n_heads=16,
    n_kv_heads=16, head_dim=256, d_ff=24576, vocab=256_000, act="gelu",
    norm_plus_one=True, emb_scale=math.sqrt(3072))

REDUCED = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=512, emb_scale=8.0)

SPEC = ArchSpec(id="gemma-7b", family="lm",
                make_config=lambda shape=None: CONFIG,
                make_reduced=lambda: REDUCED,
                notes="GeGLU, head_dim=256, (1+w) norms")
