"""The port's counterpart of `dust3r_tpu/datasets/`: so far only the image
normalization that visloc's datasets use (the training loaders wait for
ROADMAP.md queue A item 7)."""
