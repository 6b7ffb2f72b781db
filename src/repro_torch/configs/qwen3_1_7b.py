"""qwen3-1.7b [hf:Qwen/Qwen3-1.7B].

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936; qk-norm on per-head
q/k, rope_theta=1e6.
"""
import dataclasses

from ..models.transformer import LMConfig
from .registry import ArchSpec

CONFIG = LMConfig(
    name="qwen3-1.7b", n_layers=28, d_model=2048, n_heads=16,
    n_kv_heads=8, d_ff=6144, vocab=151_936, act="silu", qk_norm=True,
    rope_theta=1_000_000.0)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512)

SPEC = ArchSpec(id="qwen3-1.7b", family="lm",
                make_config=lambda shape=None: CONFIG,
                make_reduced=lambda: REDUCED,
                notes="qk_norm, GQA")
