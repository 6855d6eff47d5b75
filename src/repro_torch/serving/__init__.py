"""serving — the segmentation engine and the LM engine."""
