"""Aachen Day-Night visloc dataset (counterpart of
`dust3r_tpu/visloc/datasets/aachen_day_night.py`)."""
import os

from .base_colmap import BaseVislocColmapDataset


class VislocAachenDayNight(BaseVislocColmapDataset):
    def __init__(self, root, subscene, pairsfile, topk=1, cache_sfm=False):
        if subscene not in (None, "", "day", "night", "all"):
            raise ValueError(f"subscene {subscene!r} not in None, '', day, night, all")
        self.subscene = subscene
        super().__init__(
            image_path=os.path.join(root, "images"),
            map_path=os.path.join(root, "mapping/colmap/reconstruction"),
            query_path=os.path.join(root, "kapture", "query"),
            pairsfile_path=os.path.join(root, "pairsfile/query", pairsfile + ".txt"),
            topk=topk, cache_sfm=cache_sfm)
        self.scenes = [f for f in self.scenes if f in self.pairs]
        if self.subscene in ("day", "night"):
            self.scenes = [f for f in self.scenes if self.subscene in f]
