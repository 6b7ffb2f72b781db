"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts
top-1 on every layer + shared expert; iRoPE chunked attention. ~109B total,
~17B active.
"""
import dataclasses

from ..models.transformer import LMConfig

CONFIG = LMConfig(
    name="llama4-scout-17b-a16e", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=202048,
    act="silu", n_experts=16, moe_every=1, shared_expert=True,
    attn_chunk=8192, global_every=4, rope_theta=500_000.0)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab=512, n_experts=4, attn_chunk=8, global_every=2)
