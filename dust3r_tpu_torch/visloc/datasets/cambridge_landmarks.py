"""Cambridge Landmarks visloc dataset (counterpart of
`dust3r_tpu/visloc/datasets/cambridge_landmarks.py`)."""
import os

from .base_colmap import BaseVislocColmapDataset


class VislocCambridgeLandmarks(BaseVislocColmapDataset):
    def __init__(self, root, subscene, pairsfile, topk=1, cache_sfm=False):
        super().__init__(
            image_path=os.path.join(root, subscene),
            map_path=os.path.join(root, "mapping", subscene, "colmap/reconstruction"),
            query_path=os.path.join(root, "kapture", subscene, "query"),
            pairsfile_path=os.path.join(root, subscene, "pairsfile/query", pairsfile + ".txt"),
            topk=topk, cache_sfm=cache_sfm)
