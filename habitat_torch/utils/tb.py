"""TensorBoard and W&B writers (port of ``habitat_tpu/utils/tb.py``;
reference common/tensorboard_utils.py:32,102).

``TensorboardWriter`` needs the ``tensorboard`` package
(``torch.utils.tensorboard``): without it building the writer raises
ImportError, so a run that asks for TensorBoard output never goes on without
it. ``add_video_from_np_images`` writes the summary that
``SummaryWriter.add_video`` writes where moviepy is installed: an image
summary whose encoded bytes are an animated GIF of the frames, here from the
port's own encoder (``utils/visualizations/image_io.py``), so no moviepy is
needed.

``WeightsAndBiasesWriter`` needs ``wandb`` and raises ImportError naming it
when it is missing (the JAX package's writer then logs nothing).
"""

from __future__ import annotations

from typing import Any, List

import numpy as np


class TensorboardWriter:
    def __init__(self, log_dir: str, flush_secs: int = 30):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir=log_dir, flush_secs=flush_secs)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.writer.add_scalar(tag, value, step)

    def add_video_from_np_images(self, video_name: str, step_idx: int, images: List[np.ndarray],
                                 fps: int = 10) -> None:
        """Equal-size (H, W, 3) uint8 frames as one GIF image summary under
        ``video_name`` at ``step_idx`` (reference tensorboard_utils.py:64)."""
        from tensorboard.compat.proto.summary_pb2 import Summary

        from habitat_torch.utils.visualizations.image_io import encode_gif

        frames = [np.asarray(im) for im in images]
        h, w = frames[0].shape[:2]
        image = Summary.Image(height=h, width=w, colorspace=3, encoded_image_string=encode_gif(frames, fps))
        self.writer._get_file_writer().add_summary(Summary(value=[Summary.Value(tag=video_name, image=image)]),
                                                   step_idx)

    def close(self) -> None:
        self.writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class WeightsAndBiasesWriter:
    """reference tensorboard_utils.py:102; ``kwargs`` go to ``wandb.init``."""

    def __init__(self, config=None, **kwargs: Any):
        try:
            import wandb
        except ImportError as e:
            raise ImportError("WeightsAndBiasesWriter needs the wandb package, which is not installed") from e
        self.wandb = wandb
        self.run = wandb.init(**kwargs)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.wandb.log({tag: value}, step=int(step))

    def close(self) -> None:
        self.run.finish()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
