"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-Maverick; unverified].

48L d_model=5120 40H (GQA kv=8, head_dim=128) d_ff=8192 vocab=202048,
MoE 128 experts top-1 on every 2nd layer (interleave_moe_layer_step=2) +
shared expert; iRoPE: chunked local attention (8192) with every 4th layer
global/NoPE. Totals ~400B params, ~17B active.
"""
import dataclasses

from ..models.transformer import LMConfig

CONFIG = LMConfig(
    name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=202048,
    act="silu", n_experts=128, moe_every=2, shared_expert=True,
    attn_chunk=8192, global_every=4, rope_theta=500_000.0)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab=512, n_experts=8, attn_chunk=8, global_every=2)
