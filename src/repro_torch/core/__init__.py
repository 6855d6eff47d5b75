"""core — MeshNet, the executor registry and the segmentation pipeline
(conform, cropping, connected components), in PyTorch."""
