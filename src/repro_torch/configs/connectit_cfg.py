"""The paper's own workload as an arch: production-mesh connectivity."""
import dataclasses

from .base import CONNECTIT_SHAPES, Arch, register


@dataclasses.dataclass(frozen=True)
class ConnectItConfig:
    name: str = "connectit"
    finish: str = "uf_sync"
    sample: str = "kout"
    jumps_per_round: int = 2


register(Arch(
    name="connectit", family="connectit", model=ConnectItConfig(),
    shapes=CONNECTIT_SHAPES, smoke=dict()))
