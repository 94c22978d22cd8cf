"""Tests of the benchmark harness. They run on the CPU at small sizes; what
only the card can show (the cell's runs, the control at the cell's size)
is read on the card by the harness itself (PERF.md)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
