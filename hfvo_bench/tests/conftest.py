"""The benchmark's tests run on the CPU (`python -m pytest -o addopts= hfvo_bench/tests`
from the repository root); those marked `cuda` decide inside whether a card
is there and skip without one."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
