"""Experiment trackers, `--report-to wandb,tensorboard` (port of
`leaf_tpu/utils/trackers.py`).

Both back ends are optional and imported only inside their tracker.  As
in the JAX package, a back end that fails to start (its package missing,
say) is logged as a warning and left out; with none left the tracker is a
no-op, so call sites stay unconditional.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

LOG = logging.getLogger(__name__)


class Tracker:
    def log(self, data: Dict[str, float], step: Optional[int] = None):
        pass

    def finish(self):
        pass


class TensorBoardTracker(Tracker):
    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            from tensorboardX import SummaryWriter
        self.writer = SummaryWriter(log_dir)

    def log(self, data, step=None):
        for k, v in data.items():
            try:
                self.writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass

    def finish(self):
        self.writer.close()


class WandbTracker(Tracker):
    def __init__(self, project: str, name: str, notes: str = "",
                 config: Optional[dict] = None, resume: str = "auto"):
        import wandb
        self.run = wandb.init(project=project, name=name, notes=notes,
                              config=config, resume=resume)

    def log(self, data, step=None):
        import wandb
        # step= keeps wandb's x-axis on the training step
        wandb.log(data, step=step)

    def finish(self):
        import wandb
        wandb.finish()


class MultiTracker(Tracker):
    def __init__(self, trackers):
        self.trackers = trackers

    def log(self, data, step=None):
        for t in self.trackers:
            t.log(data, step)

    def finish(self):
        for t in self.trackers:
            t.finish()


def create_tracker(report_to: str, log_dir: str, run_name: str,
                   wandb_project: str = "open-clip", wandb_notes: str = "",
                   config: Optional[dict] = None) -> Tracker:
    wanted = {x.strip() for x in (report_to or "").split(",") if x.strip()}
    trackers = []
    if "tensorboard" in wanted:
        try:
            trackers.append(TensorBoardTracker(log_dir))
        except Exception as e:  # noqa: BLE001
            LOG.warning("tensorboard unavailable: %r", e)
    if "wandb" in wanted:
        try:
            trackers.append(WandbTracker(wandb_project, run_name,
                                         wandb_notes, config))
        except Exception as e:  # noqa: BLE001
            LOG.warning("wandb unavailable: %r", e)
    if not trackers:
        return Tracker()
    if len(trackers) == 1:
        return trackers[0]
    return MultiTracker(trackers)
