"""Final distillation of the pruned student (reference ``final_distill.py``):
the stage-1 trainer with ``use_reg=False`` (no gates, no Lagrangian) and
the projections warm-started from the student checkpoint's
``distill_linear_projs``.  Flags and exit codes as ``cli/distill.py``."""

from __future__ import annotations

from argparse import ArgumentParser

from .distill import add_common_training_args, run_train


def _parse_args(argv=None):
    parser = ArgumentParser(description="Final distillation")
    add_common_training_args(parser)
    return parser.parse_args(argv)


def cli_main(argv=None):
    return run_train(_parse_args(argv), use_reg=False)


if __name__ == "__main__":
    cli_main()
