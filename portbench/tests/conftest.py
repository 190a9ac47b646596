"""The benchmark's own tests.  They run on the CPU at tiny sizes; a test
that needs a CUDA card is marked ``card`` and skips, decided inside the
test, where none is found."""
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
