"""Host-side CELT pieces the port keeps its own copies of (the mode, the
plan transforms, the native symbol stage binding)."""
