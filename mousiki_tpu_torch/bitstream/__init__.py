"""The Opus packet layer, as far as the port's pipelines need it."""
