"""Native (C++) host components of the port, loaded with ctypes."""
from .build import load_library, native_available

__all__ = ["load_library", "native_available"]
