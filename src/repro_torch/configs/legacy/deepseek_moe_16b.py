"""deepseek-moe-16b [arXiv:2401.06066]: 2 shared + 64 routed top-6,
fine-grained experts (d_expert=1408). Deviation noted in DESIGN.md: the HF
model's first layer is dense; here all 28 layers are MoE (scan-over-layers
homogeneity)."""
from ...legacy.models.transformer import TransformerConfig
from ..base import Arch, LM_SHAPES, register

MODEL = TransformerConfig(
    name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab=102400, n_experts=64, top_k=6,
    n_shared_experts=2, d_expert=1408)

SHAPES = dict(LM_SHAPES)
# §Perf hillclimbed variant: int8-compressed EP all_to_all (EXPERIMENTS.md)
SHAPES["train_4k_int8a2a"] = dict(kind="train", seq=4096, batch=256,
                                  moe_a2a_int8=True)

register(Arch(
    name="deepseek-moe-16b", family="lm", model=MODEL, shapes=SHAPES,
    smoke=dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
               vocab=256, n_experts=8, top_k=2, n_shared_experts=1,
               d_expert=64, dtype="float32", remat=False, q_chunk=16,
               k_chunk=16)))
