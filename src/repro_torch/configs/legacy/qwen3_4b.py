"""qwen3-4b [hf:Qwen/Qwen3-8B family]: GQA + qk-norm."""
from ...legacy.models.transformer import TransformerConfig
from ..base import Arch, LM_SHAPES, register

MODEL = TransformerConfig(
    name="qwen3-4b", n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151936, qk_norm=True, d_head=128)

register(Arch(
    name="qwen3-4b", family="lm", model=MODEL, shapes=LM_SHAPES,
    smoke=dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
               vocab=512, qk_norm=True, d_head=16, dtype="float32",
               remat=False, q_chunk=16, k_chunk=16)))
