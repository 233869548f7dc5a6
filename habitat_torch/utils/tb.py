"""TensorBoard writer (port of the ``TensorboardWriter`` of
``habitat_tpu/utils/tb.py``; reference common/tensorboard_utils.py:32).

``torch.utils.tensorboard`` needs the ``tensorboard`` package: without it
building the writer raises ImportError, so a run that asks for TensorBoard
output never goes on without it. The W&B writer and eval videos
(``add_video_from_np_images``) are not ported: they wait for the port of
utils/visualizations/utils.py."""

from __future__ import annotations


class TensorboardWriter:
    def __init__(self, log_dir: str, flush_secs: int = 30):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir=log_dir, flush_secs=flush_secs)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.writer.add_scalar(tag, value, step)

    def close(self) -> None:
        self.writer.close()
