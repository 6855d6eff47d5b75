"""serving — the segmentation engine."""
