"""Framework configuration (the port's copy of ``ray_tpu/_private/config.py``,
cut to the one field its in-process runtime reads).

A field keeps its coded default unless the ``_system_config`` dict passed to
:func:`ray_tpu_torch.init` overrides it. A key the port does not read is
refused, as any unknown key is.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict


@dataclasses.dataclass
class _ConfigDefaults:
    # Retries of a task whose ``max_retries`` option is unset.
    task_max_retries: int = 3


class RayTpuConfig:
    """Accessor resolving (system_config > default) per field."""

    def __init__(self):
        self._defaults = _ConfigDefaults()
        self._system_config: Dict[str, Any] = {}
        self._fields = {f.name for f in dataclasses.fields(_ConfigDefaults)}

    def initialize(self, system_config: Dict[str, Any] | str | None):
        if system_config is None:
            system_config = {}
        if isinstance(system_config, str):
            system_config = json.loads(system_config) if system_config else {}
        unknown = set(system_config) - self._fields
        if unknown:
            raise ValueError(f"Unknown _system_config keys: {sorted(unknown)}")
        self._system_config = dict(system_config)

    def __getattr__(self, name: str) -> Any:
        fields = object.__getattribute__(self, "_fields")
        if name not in fields:
            raise AttributeError(name)
        default = getattr(object.__getattribute__(self, "_defaults"), name)
        sysconf = object.__getattribute__(self, "_system_config")
        return type(default)(sysconf[name]) if name in sysconf else default


GLOBAL_CONFIG = RayTpuConfig()
