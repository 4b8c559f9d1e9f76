"""Native host code of the port (the JPEG loader's ctypes binding)."""
