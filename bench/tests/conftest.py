"""The benchmark's own tests: ``python -m pytest -q bench/tests`` from the
repository's root (``pytest.ini``'s ``testpaths`` leaves them out of the
repository's suite).  Card-only tests carry the ``cuda`` marker."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
