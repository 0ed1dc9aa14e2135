"""hvdlint for the port: framework-invariant static analysis of its
collective engine, plus the runtime lock-order witness.

Counterpart of horovod_tpu/analysis/, copied and adapted (the port
imports nothing of the JAX package). ``python -m
horovod_tpu_torch.analysis [--baseline .hvdlint-torch-baseline]`` lints
``horovod_tpu_torch/`` against the rule catalog of
docs/static-analysis.md, with the rules' torch readings (rules.py); the
lock witness (``analysis.lockwitness``) wraps the port's own locks when
a test or a drive installs it.
"""

from .core import (AstRule, Finding, ProjectRule, all_rules, lint_file,
                   lint_tree, load_baseline, main, register)
from .lockwitness import LockOrderWitness, format_cycles

__all__ = ["AstRule", "Finding", "ProjectRule", "all_rules", "lint_file",
           "lint_tree", "load_baseline", "main", "register",
           "LockOrderWitness", "format_cycles"]
