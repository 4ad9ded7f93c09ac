"""Name → factory registries (counterpart of ``audio_fewshot_tpu/registry.py``).

The YAML surface (``classifier.name`` / ``backbone.name``) names a registered
factory; an unknown name raises a ``KeyError`` that lists the registered
ones.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._factories: Dict[str, Callable[..., Any]] = {}

    def register(self, name: Optional[str] = None):
        def deco(fn):
            key = name or fn.__name__
            if key in self._factories:
                raise ValueError(
                    f"duplicate {self.kind} registration {key!r} — a config "
                    "naming it would silently build the wrong component"
                )
            self._factories[key] = fn
            return fn

        return deco

    def register_alias(self, name: str, target: str) -> None:
        """``name`` builds what the registered ``target`` builds (the
        reference's exported aliases, e.g. ``DiffKendall``)."""
        if name in self._factories:
            raise ValueError(f"duplicate {self.kind} registration {name!r}")
        self._factories[name] = self.get(target)

    def __contains__(self, name: str) -> bool:
        return name in self._factories

    def names(self):
        return sorted(self._factories)

    def get(self, name: str) -> Callable[..., Any]:
        if name not in self._factories:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: {self.names()}"
            )
        return self._factories[name]

    def build(self, name: str, **kwargs) -> Any:
        return self.get(name)(**kwargs)


BACKBONES = Registry("backbone")
CLASSIFIERS = Registry("classifier")
