"""CLI entry point: ``python -m mpassit_tpu_torch <namelist>`` (defaults to
./fort.41 like the reference driver, mpassit.F90:52-65). The device comes
from ``MPASSIT_PLATFORM``: ``cuda`` (default) or ``cpu``."""

import sys

from .run.pipeline import main

if __name__ == "__main__":
    sys.exit(main())
