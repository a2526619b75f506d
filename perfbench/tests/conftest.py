import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
