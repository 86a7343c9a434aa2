"""AppSpec: declarative configuration for the §5 applications layer.

The paper's applications (approximate MSF, §5.1; SCAN GS*-Query, §5.2) are
*consumers* of the ConnectIt framework: each one runs the sampling × finish
variant space. ``AppSpec`` gives them the same declarative grammar the rest
of the stack uses (``VariantSpec``):

    app  := "msf"
          | "amsf" [ "(" kv ("," kv)* ")" ]
          | "scan" [ "(" kv ("," kv)* ")" ]
    kv   := "eps=" FLOAT          # amsf: bucket ratio; scan: similarity bar
          | "skip=" ("none" | "lmax")      # amsf: L_max vertex skipping
          | "mode=" ("mask" | "coo")       # amsf: bucket realization
          | "mu="  INT                     # scan: core degree threshold

Canonical strings round-trip exactly (``AppSpec.parse(str(s)) == s``); knobs
an app does not use are pinned to their defaults on construction so equality
is canonical — the same discipline as ``SamplingSpec``.

Paper-variant mapping:

    amsf                    AMSF-NF   (mask the full edge list per bucket)
    amsf(skip=lmax)         AMSF-NF-S (additionally skip the running L_max
                            component — the sampling optimization; the
                            paper-best variant, 2.03-5.36x over exact MSF)
    amsf(mode=coo)          AMSF-COO  (host-sorted, per-bucket compacted)
    msf                     exact Borůvka (the GBBS-MSF baseline)
    scan(eps=0.6,mu=3)      GS*-Query at (eps, mu)

``ConnectIt(variant).amsf/.msf/.scan`` are the session entry points
(``repro_torch.api``). This module is the JAX package's grammar, copied so
that the port imports nothing of it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Union

APPS = ("amsf", "msf", "scan")
SKIP_MODES = ("none", "lmax")
AMSF_MODES = ("mask", "coo")

_HEAD_RE = re.compile(r"([a-z_]+)(?:\((.*)\))?")

# which AppSpec knobs are meaningful per app; the rest are pinned to their
# defaults on construction (canonical equality / round-trips)
_APP_FIELDS = {
    "amsf": ("eps", "skip", "mode"),
    "msf": (),
    "scan": ("eps", "mu"),
}
# eps means a different thing per app (geometric bucket ratio vs structural
# similarity threshold), so its default is app-specific; ``eps=None`` on
# construction resolves to the app default
EPS_DEFAULTS = {"amsf": 0.25, "scan": 0.6}
_FIELD_DEFAULTS: dict = {}


def _fmt_float(x: float) -> str:
    # repr round-trips exactly through float() (same rule as SamplingSpec)
    return repr(float(x))


@dataclasses.dataclass(frozen=True)
class AppSpec:
    """One point of the paper's §5 application space."""

    app: str = "amsf"
    eps: float = None          # amsf: bucket ratio; scan: similarity bar
    skip: str = "none"         # amsf: L_max component skipping (NF vs NF-S)
    mode: str = "mask"         # amsf: masked sweep vs host-compacted COO
    mu: int = 3                # scan: core degree threshold

    def __post_init__(self):
        if self.app not in APPS:
            raise ValueError(f"unknown app {self.app!r}; have {APPS}")
        if self.eps is None:
            object.__setattr__(self, "eps", EPS_DEFAULTS.get(self.app, 0.0))
        object.__setattr__(self, "eps", float(self.eps))
        if int(self.mu) != self.mu:
            raise ValueError(f"mu must be an integer, got {self.mu!r}")
        object.__setattr__(self, "mu", int(self.mu))
        if self.app == "amsf":
            if not self.eps > 0.0:
                raise ValueError(f"amsf eps must be > 0, got {self.eps}")
            if self.skip not in SKIP_MODES:
                raise ValueError(f"unknown skip mode {self.skip!r}; "
                                 f"have {SKIP_MODES}")
            if self.mode not in AMSF_MODES:
                raise ValueError(f"unknown amsf mode {self.mode!r}; "
                                 f"have {AMSF_MODES}")
            if self.skip == "lmax" and self.mode == "coo":
                raise ValueError(
                    "skip=lmax composes with mode=mask only: the paper's "
                    "AMSF variants are NF, NF-S (masked) and COO (no skip)")
        if self.app == "scan":
            if not 0.0 < self.eps <= 1.0:
                raise ValueError(f"scan eps must be in (0, 1], got {self.eps}")
            if self.mu < 1:
                raise ValueError(f"scan mu must be >= 1, got {self.mu}")
        # canonicalize: pin knobs the app does not use to their defaults
        live = _APP_FIELDS[self.app]
        for name, default in _FIELD_DEFAULTS.items():
            if name not in live:
                object.__setattr__(self, name, default)
        if "eps" not in live:
            object.__setattr__(self, "eps", 0.0)

    # -- views --------------------------------------------------------------

    def __str__(self) -> str:
        opts = []
        if self.app == "amsf":
            if self.eps != EPS_DEFAULTS["amsf"]:
                opts.append(f"eps={_fmt_float(self.eps)}")
            if self.skip != "none":
                opts.append(f"skip={self.skip}")
            if self.mode != "mask":
                opts.append(f"mode={self.mode}")
        elif self.app == "scan":
            if self.eps != EPS_DEFAULTS["scan"]:
                opts.append(f"eps={_fmt_float(self.eps)}")
            if self.mu != _FIELD_DEFAULTS["mu"]:
                opts.append(f"mu={self.mu}")
        return self.app + (f"({','.join(opts)})" if opts else "")

    @classmethod
    def parse(cls, text: str) -> "AppSpec":
        t = text.strip()
        m = _HEAD_RE.fullmatch(t)
        if not m:
            raise ValueError(f"bad app spec {text!r}")
        app, optpart = m.group(1), m.group(2)
        if app not in APPS:
            raise ValueError(f"unknown app {app!r} in {text!r}; have {APPS}")
        if optpart is not None and not optpart.strip():
            raise ValueError(f"empty option list in {text!r}")
        kw: dict = {}
        for opt in (optpart.split(",") if optpart else ()):
            key, eq, val = opt.partition("=")
            key, val = key.strip(), val.strip()
            if not key or not eq or not val:
                raise ValueError(f"bad app option {opt!r} in {text!r}")
            if key == "eps":
                kw["eps"] = float(val)
            elif key == "mu":
                kw["mu"] = int(val)
            elif key in ("skip", "mode"):
                kw[key] = val
            else:
                raise ValueError(f"unknown app option {key!r} in {text!r}")
        bad = [k for k in kw if k not in _APP_FIELDS[app]]
        if bad:
            raise ValueError(
                f"option(s) {bad} are not valid for app {app!r} "
                f"(valid: {list(_APP_FIELDS[app])})")
        return cls(app, **kw)


_FIELD_DEFAULTS.update({
    f.name: f.default for f in dataclasses.fields(AppSpec)
    if f.name not in ("app", "eps")
})

AppSpecLike = Union[str, AppSpec]


def as_app_spec(spec: AppSpecLike) -> AppSpec:
    if isinstance(spec, str):
        return AppSpec.parse(spec)
    if isinstance(spec, AppSpec):
        return spec
    raise TypeError(f"app spec must be an AppSpec or string, "
                    f"got {type(spec).__name__}")


def default_app_grid() -> list:
    """The paper's §5 application grid: every AMSF variant (Figure 6) at the
    paper eps, the exact baseline, and the SCAN sweep points (Figure 7)."""
    return [
        AppSpec("msf"),
        AppSpec("amsf"),                          # AMSF-NF
        AppSpec("amsf", skip="lmax"),             # AMSF-NF-S (paper best)
        AppSpec("amsf", mode="coo"),              # AMSF-COO
        AppSpec("amsf", eps=0.1),
        AppSpec("amsf", eps=0.5, skip="lmax"),
        AppSpec("scan"),
        AppSpec("scan", eps=0.1, mu=3),
        AppSpec("scan", eps=0.3, mu=2),
    ]
