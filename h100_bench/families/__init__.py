"""One module a model family: everything of the harness that depends on
the family, which the rest of the harness reads and never tests a
family's name for.  A family module holds:

  reference          the family's plain forward (`h100_bench.reference`):
                     `layout(cfg)` and `logits(cfg, weights, seqs, mm)`,
                     with `follow=` where the family follows a choice
  arch_config(cfg)   the program's `ArchConfig` from the configuration
                     file's keys; raises where the program would compute
                     something the reference does not
  kernels(cfg)       the CUDA sources its serving path launches, built
                     before the window
  matmul_params(cfg) the weights of the products one token goes through,
                     every layer, the unembedding left out
  attention_layers(cfg)  (full-attention layers, windowed layers)
  OPS                traced ops beyond `trace.OPS`: {op: (module,
                     call_args, work)}
  FOLLOW             a `Choice` the check keeps for its checked rows and
                     the reference follows, or None

The configuration file's `family` names it: `families/<family>.py`, or,
where the name holds a dot, the module of that name (a test's family).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from types import ModuleType
from typing import Callable, Dict, Tuple


@dataclass(frozen=True)
class Choice:
    """A choice the check follows (`check.py`): `fn` where the port module
    `module` binds it (as the model modules call it), `keep(result)` the
    choices of the call's T = B·S rows, an int64 (T, *row) tensor, and
    `shape(cfg)` (calls a step, *row).  The judged numbers and the limit
    are named by `name`."""
    module: str
    fn: str
    keep: Callable
    shape: Callable[[Dict], Tuple[int, ...]]
    name: str


def of(cfg: Dict) -> ModuleType:
    """The family module of a configuration file."""
    name = cfg["family"]
    return importlib.import_module(name if "." in name
                                   else f"{__name__}.{name}")
