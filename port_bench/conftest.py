"""Puts the benchmark's own modules on the path of its tests, as run.py
puts them for a run, and the checkout's root for the port."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for path in (str(HERE), str(HERE.parent)):
    if path not in sys.path:
        sys.path.insert(0, path)
