"""The benchmark's tests import the benchmark as the package `benchmark`
from the checkout's root, and its helpers from this directory."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for path in (os.path.dirname(os.path.dirname(HERE)), HERE):
    if path not in sys.path:
        sys.path.insert(0, path)
