"""`python -m stellar_core_tpu_torch` entry point.

Copied from `stellar_core_tpu/__main__.py` at commit c7c3018; carry a fix
in either copy to the other. Nothing is left out.

Role parity: reference src/main/main.cpp.
"""

import signal
import sys

from .main.commandline import main

if __name__ == "__main__":
    # die quietly when a downstream pipe (head, less) closes, like any
    # well-behaved unix CLI
    try:
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):
        pass
    sys.exit(main())
