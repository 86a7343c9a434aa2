"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0 family]: 40 routed
experts top-8, d_expert=512."""
from ...legacy.models.transformer import TransformerConfig
from ..base import Arch, LM_SHAPES, register

MODEL = TransformerConfig(
    name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
    n_kv_heads=8, d_ff=512, vocab=49155, n_experts=40, top_k=8,
    n_shared_experts=0, d_expert=512, d_head=64)

register(Arch(
    name="granite-moe-3b-a800m", family="lm", model=MODEL, shapes=LM_SHAPES,
    smoke=dict(n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=32,
               vocab=256, n_experts=5, top_k=2, n_shared_experts=0,
               d_expert=32, d_head=12, dtype="float32", remat=False,
               q_chunk=16, k_chunk=16)))
