"""Model families: everything a configuration's model needs from the
benchmark, one file a family, found by the name a configuration file gives
in ``runs.family`` (``families/<family>.py``, loaded by its path, as the
metric readers are).

A family file defines, at module level:

- ``port_config(c)``: the port's ``ArchConfig`` for configuration file
  ``c``;
- ``layout(c)``: every weight leaf in the port's tree, as (path, shape,
  scale), scale 0 meaning a norm's ones (``weights.make`` fills them);
- ``NUMBERS``: the numbers its check produces; every run requires each,
  and each has to include ``logit_err`` and ``token_gap``;
- ``judge(c, weights, samples, precision)``: those numbers over the
  sampled requests (``harness.Served`` with logits and routing), from its
  plain reference;
- ``prefill_flops(c, b, s)``: the published model's operations in a
  prefill of ``b`` prompts of ``s`` tokens;
- ``flash_launches(c, b, s)``: the flash-attention launches of that
  prefill, each ``(b, s, h, kh, d, dv, causal)``;
- ``TINY(c)``: the configuration at the CPU tests' size.

A configuration of a new family is then new files only: the family file,
its reference module under ``reference/``, the configuration file, the
cells' files under ``workloads/``, and their entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict

__all__ = ["DIR", "NAMES", "REQUIRED_NUMBERS", "of"]

DIR = Path(__file__).resolve().parent
NAMES = ("port_config", "layout", "NUMBERS", "judge", "prefill_flops",
         "flash_launches", "TINY")
REQUIRED_NUMBERS = ("logit_err", "token_gap")  # no family passes unjudged

_loaded: Dict[Path, ModuleType] = {}


def of(c: dict) -> ModuleType:
    """The family module configuration file ``c`` names in
    ``runs.family``.

    Raises:
        FileNotFoundError: no such family file.
        AttributeError: the file lacks a name of ``NAMES``.
        ValueError: its ``NUMBERS`` lacks one of ``REQUIRED_NUMBERS``.
    """
    family = c["runs"]["family"]
    path = DIR / f"{family}.py"
    if path in _loaded:
        return _loaded[path]
    where = f"configuration {c.get('name')!r} names family {family!r}"
    if not path.is_file():
        raise FileNotFoundError(f"{where}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_family_{family}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [n for n in NAMES if not hasattr(mod, n)]
    if missing:
        raise AttributeError(f"{where}: {path} defines no "
                             f"{', '.join(missing)}")
    lacking = [n for n in REQUIRED_NUMBERS if n not in mod.NUMBERS]
    if lacking:
        raise ValueError(f"{where}: {path}'s NUMBERS {tuple(mod.NUMBERS)} "
                         f"lack {', '.join(lacking)}")
    _loaded[path] = mod
    return mod
