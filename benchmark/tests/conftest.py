"""The benchmark's own CPU tests: `python -m pytest benchmark/tests`.
Tests marked `cuda` run a cell on the card and skip without one."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
