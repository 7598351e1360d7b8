"""Two-level INI experiment configs with the reference's value grammar (the
port's own copy of ``cyclediffusion_tpu.runtime.config``).

An experiment cfg's sections become an :class:`Args` attribute tree; string
values parse as int -> float -> bool -> None -> JSON list -> str.  Relative
paths resolve against ``CYCLEDIFFUSION_CONFIG_ROOT`` when it is set, else
against the port's packaged ``config/`` directory (the text-path
experiments and their tasks), so ``--cfg experiments/X.cfg`` works from
any directory.
"""

from __future__ import annotations

import configparser
import json
import os
from typing import Any, Iterator, Tuple

_PACKAGED_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "config")


class Args:
    """Attribute tree over config sections; iterating a section yields
    (key, value) pairs, the surface ``get_gan_wrapper`` reads."""

    def __init__(self, **kwargs):
        self.__dict__.update(kwargs)

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self.__dict__.items())

    def __repr__(self) -> str:
        return "Args(" + ", ".join(f"{k}={v!r}" for k, v in self) + ")"

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, Args) else v for k, v in self}


def parse_string(value: str) -> Any:
    """int -> float -> bool -> None -> JSON -> str."""
    for parse in (int, float):
        try:
            return parse(value)
        except ValueError:
            pass
    if value in ("True", "true"):
        return True
    if value in ("False", "false"):
        return False
    if value in ("None", "none", "~"):
        return None
    try:
        return json.loads(value)
    except ValueError:
        return value


def config_root() -> str:
    return os.environ.get("CYCLEDIFFUSION_CONFIG_ROOT", _PACKAGED_ROOT)


def get_config(cfg_name: str) -> Args:
    """Read a cfg file into a two-level :class:`Args` tree."""
    path = cfg_name
    if not os.path.isabs(path):
        path = os.path.join(config_root(), cfg_name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"config not found: {path}")
    parser = configparser.ConfigParser()
    parser.optionxform = str  # keep key case
    with open(path) as f:
        parser.read_string(f.read())
    return Args(**{section: Args(**{k: parse_string(v) for k, v in parser.items(section)})
                   for section in parser.sections()})
