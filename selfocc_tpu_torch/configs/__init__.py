"""configs — the port's own copies of ``selfocc_tpu/configs``."""
