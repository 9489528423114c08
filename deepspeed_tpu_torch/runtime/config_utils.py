"""Typed config blocks (counterpart of ``deepspeed_tpu/runtime/config_utils.py``).

The JAX package builds its blocks with pydantic; the port uses dataclasses
and `from_dict`, with the same rules for the keys of one block: a value of
``"auto"`` or ``None`` keeps the field's default, and keys the block does not
know are accepted and ignored. `unported` is the one error for a config
value the port does not run yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Type, TypeVar

T = TypeVar("T")


class DeepSpeedConfigError(Exception):
    pass


def from_dict(cls: Type[T], values: Optional[Dict[str, Any]]) -> T:
    """`cls(**values)` over the fields `cls` has."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in (values or {}).items()
                  if k in names and v is not None and v != "auto"})


def unported(what: str, item: str) -> NotImplementedError:
    """The error for `what`, which ROADMAP.md's Queue 1 `item` brings."""
    return NotImplementedError(f"{what} is not ported to deepspeed_tpu_torch yet: "
                               f"ROADMAP.md, Queue 1, '{item}'")
