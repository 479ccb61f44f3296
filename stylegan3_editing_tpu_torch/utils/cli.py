"""Dataclass-driven CLI parsing (pyrallis equivalent).

A copy of the JAX package's `utils/cli.py`.

The reference wraps every tool's options dataclass with `@pyrallis.wrap()`
(e.g. inversion/options/train_options.py); this provides the same
ergonomics: `opts = parse_dataclass(TrainOptions)` turns every field into a
`--flag`, with type coercion for Optional/List/bool/Path.
"""

from __future__ import annotations

import argparse
import dataclasses
import typing
from pathlib import Path
from typing import Optional, Sequence, Type, TypeVar

T = TypeVar("T")


def _base_type(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return _base_type(args[0])
    return tp


def _str2bool(v: str) -> bool:
    if v.lower() in ("1", "true", "yes", "y"):
        return True
    if v.lower() in ("0", "false", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"not a bool: {v}")


def parse_dataclass(cls: Type[T], args: Optional[Sequence[str]] = None) -> T:
    """Build an argparse CLI from a dataclass and parse it."""
    parser = argparse.ArgumentParser(description=cls.__doc__)
    hints = typing.get_type_hints(cls)
    for field in dataclasses.fields(cls):
        tp = _base_type(hints[field.name])
        default = (field.default if field.default is not dataclasses.MISSING
                   else (field.default_factory()
                         if field.default_factory is not dataclasses.MISSING
                         else None))
        flag = f"--{field.name}"
        origin = typing.get_origin(tp)
        if origin in (list, typing.List) or (origin is None and tp in (list,)):
            inner = (typing.get_args(tp) or (str,))[0]
            parser.add_argument(flag, type=inner, nargs="*", default=default)
        elif tp is bool:
            parser.add_argument(flag, type=_str2bool, default=default)
        elif tp in (Path,):
            parser.add_argument(flag, type=str, default=default)
        else:
            parser.add_argument(flag, type=tp, default=default)
    ns = parser.parse_args(args)
    return cls(**vars(ns))
