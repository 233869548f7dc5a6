"""Console logger singleton (port of ``habitat_tpu/core/logging.py``;
reference habitat-lab/habitat/core/logging.py)."""

import logging


class HabitatLogger(logging.Logger):
    def __init__(self, name, level, format_str=None):
        super().__init__(name, level)
        handler = logging.StreamHandler()
        if format_str is not None:
            handler.setFormatter(logging.Formatter(format_str))
        self.addHandler(handler)

    def add_filehandler(self, log_filename):
        self.addHandler(logging.FileHandler(log_filename))


logger = HabitatLogger(name="habitat_torch", level=logging.INFO, format_str="%(asctime)-15s %(message)s")
