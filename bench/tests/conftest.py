"""Puts the repository's root (for ``bench``) and ``src`` (for the program)
on the import path of the benchmark's tests."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
