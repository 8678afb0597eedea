"""Put the checkout's ``src`` on the path, as ``dsbench/run.py`` does."""
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[2] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)
