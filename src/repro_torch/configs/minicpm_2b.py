"""minicpm-2b [arXiv:2404.06395; hf:openbmb/MiniCPM-2B].

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753. MiniCPM mu-P
scaling: emb_scale=12, residual scale 1.4/sqrt(40).
"""
import dataclasses
import math

from ..models.transformer import LMConfig
from .registry import ArchSpec

CONFIG = LMConfig(
    name="minicpm-2b", n_layers=40, d_model=2304, n_heads=36,
    n_kv_heads=36, d_ff=5760, vocab=122753, act="silu",
    emb_scale=12.0, resid_scale=1.4 / math.sqrt(40))

REDUCED = dataclasses.replace(
    CONFIG, n_layers=3, d_model=72, n_heads=6, n_kv_heads=6, d_ff=128,
    vocab=512, resid_scale=1.4 / math.sqrt(3))

SPEC = ArchSpec(id="minicpm-2b", family="lm",
                make_config=lambda shape=None: CONFIG,
                make_reduced=lambda: REDUCED,
                notes="WSD schedule; mu-P emb/resid scaling")
