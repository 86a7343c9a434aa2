"""DLRM-RM2 [arXiv:1906.00091]: dot interaction, 26 sparse fields."""
from ...legacy.models.dlrm import DLRMConfig
from ..base import RECSYS_SHAPES, Arch, register

MODEL = DLRMConfig(
    name="dlrm-rm2", n_dense=13, n_sparse=26, embed_dim=64,
    vocab_sizes=(1_000_000,) * 26, multi_hot=1,
    bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1))

register(Arch(
    name="dlrm-rm2", family="recsys", model=MODEL, shapes=RECSYS_SHAPES,
    smoke=dict(vocab_sizes=(1000,) * 26, bot_mlp=(32, 16, 8), embed_dim=8,
               top_mlp=(32, 16, 1))))
