"""Host-side utilities: image post-processing and the artifact writer."""
