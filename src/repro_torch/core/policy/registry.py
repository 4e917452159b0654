"""String-keyed policy registry.

  @register_policy("mine")
  class MinePolicy(PolicyBase):
      def select(self, view): ...

  pol = get_policy("mine")          # fresh instance per engine run
  list_policies()                   # sorted names

`resolve_policy` is what the engines call: it accepts a registry name, a
`SchedulerPolicy` enum member, a legacy `sim.Policy` flag record, an
already-built policy instance, or a policy class — so every historical
call-site spelling keeps working.
"""
from __future__ import annotations

import enum
from typing import Callable, Union

from repro_torch.core.policy.base import PolicyBase, RefreshPolicy

_REGISTRY: dict[str, Callable[..., RefreshPolicy]] = {}


def register_policy(name: str, factory: Callable[..., RefreshPolicy] = None,
                    *, override: bool = False):
    """Register a policy class/factory under `name`.

    Usable as a decorator (`@register_policy("x")`) or directly
    (`register_policy("x", lambda: ...)`). The factory is called with no
    required arguments and must return a fresh `RefreshPolicy`. Name
    collisions raise unless `override=True` — silently replacing e.g.
    "darp" would change every engine's behavior at a distance.

    Convention: the policy class docstring states the paper section it
    implements (or "not in the source paper" for extras) and its traits
    (level, sarp, write-drain use) — see `paper.py` / `extras.py`, and
    `docs/policy-cookbook.md` for the end-to-end recipe.
    """
    def deco(obj):
        if not override and name in _REGISTRY:
            raise ValueError(
                f"refresh policy {name!r} is already registered; pass "
                f"override=True to replace it")
        _REGISTRY[name] = obj
        return obj
    if factory is not None:
        return deco(factory)
    return deco


def get_policy(name: str, **kwargs) -> RefreshPolicy:
    """Instantiate the policy registered under `name` (KeyError lists the
    known names on a miss)."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown refresh policy {name!r}; registered: "
            f"{', '.join(sorted(_REGISTRY))}") from None
    pol = factory(**kwargs)
    # classes that never set an instance name inherit it from the registry
    if "name" not in vars(pol) or not getattr(pol, "name", None):
        pol.name = name
    return pol


def list_policies() -> list[str]:
    return sorted(_REGISTRY)


def resolve_policy(spec: Union[str, enum.Enum, RefreshPolicy, type],
                   **kwargs) -> RefreshPolicy:
    """Turn any historical policy spelling into a policy instance."""
    if isinstance(spec, str):
        return get_policy(spec, **kwargs)
    if isinstance(spec, enum.Enum):
        return get_policy(str(spec.value), **kwargs)
    if isinstance(spec, type) and issubclass(spec, PolicyBase):
        return spec(**kwargs)
    if _is_legacy_flags(spec):
        return _from_legacy_flags(spec)
    if callable(getattr(spec, "select", None)):
        return spec
    raise TypeError(f"cannot resolve refresh policy from {spec!r}")


def _is_legacy_flags(spec) -> bool:
    """A legacy `sim.Policy` flag record (frozen dataclass of booleans)."""
    return all(hasattr(spec, a) for a in ("ideal", "level", "ooo", "wrp",
                                          "sarp", "name"))


def _from_legacy_flags(spec) -> RefreshPolicy:
    """Map a legacy flag record onto the registered implementations."""
    if spec.name in _REGISTRY:
        return get_policy(spec.name)
    from repro_torch.core.policy.paper import (AllBankPolicy, DarpPolicy,
                                         IdealPolicy, RoundRobinPolicy)
    if spec.ideal:
        return IdealPolicy(name=spec.name)
    if spec.level == "ab":
        return AllBankPolicy(name=spec.name, sarp=spec.sarp)
    if spec.ooo:
        return DarpPolicy(name=spec.name, wrp=spec.wrp, sarp=spec.sarp)
    return RoundRobinPolicy(name=spec.name, sarp=spec.sarp)
