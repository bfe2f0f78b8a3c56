"""Leaf shapes and work counts, one module per architecture, named by a
configuration file's ``architecture`` (as its plain reference is, under
``bench/reference/``)."""

import importlib
from types import ModuleType
from typing import Mapping


def load(cfg: Mapping) -> ModuleType:
    """``bench/arch/<architecture>.py`` of the configuration ``cfg``."""
    return importlib.import_module(f"bench.arch.{cfg['architecture']}")
