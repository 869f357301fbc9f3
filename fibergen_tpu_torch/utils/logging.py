"""Logger of the reference (fibergen.cpp:262-372), reduced to what the port
uses.  Set ``LOG.enabled = False`` to quiet the per-iteration log."""
from __future__ import annotations


class Logger:
    def __init__(self):
        self.enabled = True

    def info(self, msg):
        if self.enabled:
            print(msg)

    def warn(self, msg):
        self.info("WARNING: " + str(msg))

    def error(self, msg):
        self.info("ERROR: " + str(msg))


LOG = Logger()
