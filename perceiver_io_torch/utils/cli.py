"""Dataclass-driven CLI: nested ``--group.field=value`` flags from config
dataclasses, preset defaults per task, and data-to-model argument links.

The port's own copy of ``perceiver_io_tpu/utils/cli.py`` (it imports nothing
of the JAX package): the same parsing rules, so one argv builds the same
field values in both packages. ``get_type_hints`` resolves each field's
annotation; every field, whatever its type, registers one string flag that
``_parse_value`` converts by that annotation.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, Optional, Sequence, Type, get_args, get_origin, get_type_hints


def _parse_value(text: str, annotation) -> Any:
    import types
    import typing

    origin = get_origin(annotation)
    if origin in (typing.Union, types.UnionType):  # Optional[...] / unions: take the first non-None arm
        args = [a for a in get_args(annotation) if a is not type(None)]
        if args:
            annotation = args[0]
        origin = get_origin(annotation)
    if text.lower() in ("none", "null"):
        return None
    if annotation is bool or isinstance(annotation, type) and issubclass(annotation, bool):
        return text.lower() in ("1", "true", "yes")
    import enum

    if isinstance(annotation, type) and issubclass(annotation, enum.Enum):
        return annotation[text]
    if origin is dict:
        # "k=v,k2=v2" -> {k: v} with int values where possible (e.g. mesh axes)
        out = {}
        for part in [p for p in text.split(",") if p]:
            k, _, v = part.partition("=")
            out[k.strip()] = _parse_value(v.strip(), (get_args(annotation) or (str, str))[1])
        return out
    if origin in (tuple, list):
        elem = (get_args(annotation) or (str,))[0]
        parts = [p for p in text.strip("()[]").split(",") if p]
        return tuple(_parse_value(p.strip(), elem) for p in parts) if origin is tuple else [
            _parse_value(p.strip(), elem) for p in parts
        ]
    if dataclasses.is_dataclass(annotation):
        raise ValueError(f"cannot parse nested dataclass from '{text}'")
    if isinstance(annotation, type) and issubclass(annotation, (int, float, str)):
        return annotation(text)
    # fall back: try int, float, str
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            continue
    return text


def add_dataclass_args(parser: argparse.ArgumentParser, prefix: str, cls: Type, defaults: Optional[Dict] = None):
    """Register ``--{prefix}.{field}`` flags for every (nested) dataclass field."""
    defaults = defaults or {}
    hints = get_type_hints(cls)
    for f in dataclasses.fields(cls):
        name = f"{prefix}.{f.name}"
        ftype = hints.get(f.name, f.type)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
            add_dataclass_args(parser, name, ftype, defaults.get(f.name))
            continue
        default = defaults.get(f.name, f.default if f.default is not dataclasses.MISSING else None)
        parser.add_argument(f"--{name}", type=str, default=None, help=f"(default: {default})")


def build_dataclass(
    cls: Type,
    prefix: str,
    namespace: argparse.Namespace,
    defaults: Optional[Dict] = None,
    overrides: Optional[Dict] = None,
):
    """Construct ``cls`` from preset defaults < parsed flags < overrides (links)."""
    defaults = dict(defaults or {})
    overrides = dict(overrides or {})
    hints = get_type_hints(cls)
    kwargs: Dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        flag = getattr(namespace, f"{prefix}.{f.name}".replace("-", "_"), None)
        ftype = hints.get(f.name, f.type)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
            kwargs[f.name] = build_dataclass(
                ftype, f"{prefix}.{f.name}", namespace, defaults.get(f.name), overrides.get(f.name)
            )
        elif f.name in overrides:
            kwargs[f.name] = overrides[f.name]  # data->model links win (LightningCLI link_arguments)
        elif flag is not None:
            kwargs[f.name] = _parse_value(flag, ftype)
        elif f.name in defaults:
            kwargs[f.name] = defaults[f.name]
        elif f.default is not dataclasses.MISSING:
            kwargs[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            kwargs[f.name] = f.default_factory()  # type: ignore[misc]
        else:
            raise SystemExit(f"missing required flag --{prefix}.{f.name}")
    return cls(**kwargs)


class CLI:
    """Minimal task CLI: register dataclass groups, parse, link, run.

    >>> cli = CLI(description="train clm")
    >>> cli.add_group("data", WikiTextDataModule, defaults={...})
    >>> cli.add_group("model", CausalLanguageModelConfig, defaults={...})
    >>> args = cli.parse()                      # argparse namespace
    >>> data = cli.build("data", args)
    >>> cfg = cli.build("model", args, link={"vocab_size": data.vocab_size})
    """

    def __init__(self, description: str = "", argv: Optional[Sequence[str]] = None):
        self.parser = argparse.ArgumentParser(description=description)
        self.groups: Dict[str, tuple] = {}
        self.argv = argv

    def add_group(self, name: str, cls: Type, defaults: Optional[Dict] = None):
        add_dataclass_args(self.parser, name, cls, defaults)
        self.groups[name] = (cls, defaults or {})

    def add_flag(self, name: str, default=None, help: str = ""):
        self.parser.add_argument(f"--{name}", type=str, default=default, help=help)

    def add_bool_flag(self, name: str, default: bool = False, help: str = ""):
        def parse_bool(s: str) -> bool:
            low = s.lower()
            if low in ("1", "true", "yes"):
                return True
            if low in ("0", "false", "no"):
                return False
            raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")

        self.parser.add_argument(
            f"--{name}", type=parse_bool, nargs="?", const=True, default=default, help=help
        )

    def parse(self) -> argparse.Namespace:
        return self.parser.parse_args(self.argv)

    def build(self, name: str, namespace: argparse.Namespace, link: Optional[Dict] = None):
        cls, defaults = self.groups[name]
        return build_dataclass(cls, name, namespace, defaults, overrides=link)
