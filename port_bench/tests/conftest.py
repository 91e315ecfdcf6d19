"""The benchmark's CPU tests run from the checkout's root; the harness and
the port are imported from there."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
