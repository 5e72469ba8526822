"""Chain storage backends (re-design of ``/root/reference/src/eryn/backends/``)."""

from .backend import Backend
from .devicebackend import DeviceBackend
from .hdfbackend import HDFBackend, TempHDFBackend, h5py

__all__ = ["Backend", "DeviceBackend", "HDFBackend", "TempHDFBackend"]


def get_test_backends():
    """Backends usable for testing (ref ``backends/__init__.py:10-20``):
    the in-memory backend plus, when h5py is available, the temp-file HDF
    backend context manager."""
    backends = [Backend]
    if h5py is not None:
        backends.append(TempHDFBackend)
    return backends
