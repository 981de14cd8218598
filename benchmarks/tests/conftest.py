"""Tests of the benchmark's harness, reference and counts on the CPU:

    python -m pytest benchmarks/tests -q -p no:cacheprovider
"""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


@pytest.fixture
def tiny_root(tmp_path):
    from benchmarks.tests import tiny

    return tiny.make_tree(str(tmp_path))
