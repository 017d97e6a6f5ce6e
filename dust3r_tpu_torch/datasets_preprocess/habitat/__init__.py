"""Habitat: equirectangular environment maps rendered by habitat-sim
(optional), cut into pinhole crops (`preprocess_habitat`)."""
