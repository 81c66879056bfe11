"""SILK host-side pieces of the port: the native decoder binding and the
resampler's coefficient tables."""
