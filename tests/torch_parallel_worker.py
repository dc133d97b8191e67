"""The tests' rank process for the CLI: ``python -m tests.torch_parallel_worker
<rank argv>`` runs the harness's jobs (``dphubert_torch.parallel.dryrun``:
``steps``, ``train``, ``jobs``) and ``cli_distill``, which drives
``cli.distill`` in a process group already up.  Start the ranks with
``dryrun.start(ENTRY, ...)``."""

from __future__ import annotations

import pathlib
import sys

from dphubert_torch.parallel import dryrun

ENTRY = ["-m", "tests.torch_parallel_worker"]


def run_cli_distill(payload: dict, mesh=None) -> None:
    """``cli.distill`` with ``payload["argv"]``; the file
    ``payload["marker"]`` appears once a step is logged, so the test can
    signal one rank while training runs."""
    from dphubert_torch.cli import distill
    from dphubert_torch.train import trainer

    marker = pathlib.Path(payload["marker"])
    log = trainer.MetricLogger.log

    def log_and_mark(self, step, metrics, audio_seconds=0.0):
        marker.touch()
        return log(self, step, metrics, audio_seconds)

    trainer.MetricLogger.log = log_and_mark
    distill.cli_main(payload["argv"])


if __name__ == "__main__":
    dryrun.run_rank({**dryrun.JOBS, "cli_distill": run_cli_distill}, sys.argv[1:])
