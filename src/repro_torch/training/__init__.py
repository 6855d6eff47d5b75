"""training — the MeshNet training path: losses, the reference's AdamW and
SGD over params trees, checkpoints in the reference's on-disk format, and
the trainer."""
