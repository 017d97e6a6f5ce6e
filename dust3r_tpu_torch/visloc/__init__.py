"""Visual localization on the port: counterpart of `dust3r_tpu/visloc/` and
of the root `visloc.py` (`cli.py`; `python -m dust3r_tpu_torch.visloc`).

Per query: the two-view network on (query, map view) pairs, a confidence
threshold, reciprocal 3D nearest neighbours, the matches lifted to the
map's sparse 3D, their pixels taken back to the original resolution, then
RANSAC-PnP (`localization.py`, numpy where the JAX package calls cv2) and
the pose-error stats in the LTVL format (`evaluation.py`). The host side
is numpy and scipy, as in the JAX package; PIL, kapture, poselib and
pycolmap are imported inside the functions that use them.
"""
