"""The benchmark's CPU tests. Run from the repository's root:

    python -m pytest nerfbench/tests -q

Tests marked `cuda` need the card and skip without one (decided inside
each test); on the card: python -m pytest -m cuda nerfbench/tests."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
