"""Plain PyTorch references of the benchmark's modes, one file each
(``<mode>.py``), found by a configuration's ``mode``."""
