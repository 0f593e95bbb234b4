"""Training-side modules of the port; this slice has only checkpoints."""
