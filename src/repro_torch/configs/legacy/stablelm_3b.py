"""stablelm-3b [hf:stabilityai/stablelm family]: MHA (kv == heads)."""
from ...legacy.models.transformer import TransformerConfig
from ..base import Arch, LM_SHAPES, register

MODEL = TransformerConfig(
    name="stablelm-3b", n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab=50304)

register(Arch(
    name="stablelm-3b", family="lm", model=MODEL, shapes=LM_SHAPES,
    smoke=dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
               vocab=256, dtype="float32", remat=False, q_chunk=16,
               k_chunk=16)))
