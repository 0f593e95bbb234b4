"""Host-side utilities: image post-processing, the artifact writer, and
tracing and step timing."""
