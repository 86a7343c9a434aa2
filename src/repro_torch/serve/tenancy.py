"""Multi-tenant vertex-id namespaces over one shared device label state.

One device state serves many logical graphs: each tenant owns a contiguous
block of the shared ``[0, total)`` vertex space, and the registry translates
tenant-local vertex ids to global ids at admission time. Because every
finish method only ever hooks along submitted edges, two tenants' blocks
can never merge — isolation is structural, not enforced per dispatch.
A copy of the JAX package's ``repro.serve.tenancy`` (numpy only).

The grammar is deliberately tiny: ``{"tenant_name": n_vertices, ...}`` (an
ordered dict — insertion order fixes the block layout), or a bare ``n`` for
the single-tenant case (one tenant named ``"default"``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Mapping, Optional, Union

import numpy as np

__all__ = ["Tenant", "TenantRegistry", "DEFAULT_TENANT"]

DEFAULT_TENANT = "default"

_NAME_RE = re.compile(r"[A-Za-z0-9_.-]+")


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One logical graph: a named block of the shared vertex space."""

    name: str
    base: int    # first global vertex id of the block
    n: int       # block size (tenant-local ids are [0, n))

    def translate(self, ids) -> np.ndarray:
        """Tenant-local vertex ids -> global ids (validated)."""
        ids = np.asarray(ids, np.int32)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n):
            bad = ids[(ids < 0) | (ids >= self.n)][0]
            raise ValueError(
                f"vertex id {int(bad)} out of range for tenant "
                f"{self.name!r} (n={self.n})")
        return ids + np.int32(self.base)


class TenantRegistry:
    """Block layout of tenants over the shared vertex space."""

    def __init__(self, tenants: Mapping[str, int]):
        if not tenants:
            raise ValueError("at least one tenant is required")
        self._tenants: dict[str, Tenant] = {}
        base = 0
        for name, n in tenants.items():
            if not _NAME_RE.fullmatch(str(name)):
                raise ValueError(f"bad tenant name {name!r}")
            if int(n) != n or int(n) < 1:
                raise ValueError(
                    f"tenant {name!r} size must be a positive integer, "
                    f"got {n!r}")
            self._tenants[str(name)] = Tenant(str(name), base, int(n))
            base += int(n)
        self.total = base  # shared vertex-space size (dump id = total)

    @classmethod
    def build(cls, n: Optional[int] = None,
              tenants: Union[Mapping[str, int], "TenantRegistry", None] = None,
              ) -> "TenantRegistry":
        """``n`` (single default tenant) xor ``tenants`` (explicit layout)."""
        if isinstance(tenants, TenantRegistry):
            if n is not None and n != tenants.total:
                raise ValueError(
                    f"n={n} conflicts with the registry total "
                    f"{tenants.total}")
            return tenants
        if tenants is not None:
            if n is not None:
                raise ValueError("pass n or tenants, not both")
            return cls(tenants)
        if n is None:
            raise ValueError("pass n (single-tenant) or tenants (layout)")
        return cls({DEFAULT_TENANT: int(n)})

    def __len__(self) -> int:
        return len(self._tenants)

    def __iter__(self):
        return iter(self._tenants.values())

    def __contains__(self, name: str) -> bool:
        return name in self._tenants

    def names(self) -> tuple:
        return tuple(self._tenants)

    def get(self, name: str = DEFAULT_TENANT) -> Tenant:
        try:
            return self._tenants[name]
        except KeyError:
            raise KeyError(f"unknown tenant {name!r}; "
                           f"have {self.names()}") from None
