"""The seed-era flat string keys' resolver (mirrors
``repro.core.registry.make_legacy_resolver``; the port's factories are
``core/finish.py::memoized_factory`` registries)."""

from __future__ import annotations

from typing import Callable


def make_legacy_resolver(aliases: dict[str, tuple[str, dict]],
                         make: Callable, kind: str) -> Callable:
    """Silent resolver for the flat seed-era string keys → memoized
    callable: ``aliases[name] = (factory name, params)``."""

    def resolve(name: str):
        if name not in aliases:
            raise KeyError(f"unknown {kind} {name!r}; have {sorted(aliases)}")
        base, params = aliases[name]
        return make(base, **params)

    return resolve
