"""h2o-danube-3-4b [arXiv:2401.16818]: llama+mistral mix with SWA."""
from ...legacy.models.transformer import TransformerConfig
from ..base import Arch, LM_SHAPES, register

MODEL = TransformerConfig(
    name="h2o-danube-3-4b", n_layers=24, d_model=3840, n_heads=32,
    n_kv_heads=8, d_ff=10240, vocab=32000, swa_window=4096)

register(Arch(
    name="h2o-danube-3-4b", family="lm", model=MODEL, shapes=LM_SHAPES,
    smoke=dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
               vocab=256, swa_window=16, dtype="float32", remat=False,
               q_chunk=16, k_chunk=16)))
