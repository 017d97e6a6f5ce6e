"""Base visloc dataset (counterpart of
`dust3r_tpu/visloc/datasets/base_dataset.py`)."""


class BaseVislocDataset:
    def __init__(self):
        self.maxdim = None
        self.patch_size = None

    def set_resolution(self, model):
        """model: an AsymmetricCroCo3DStereo; its largest image side picks
        the bucket table, as in the JAX package."""
        self.maxdim = max(model.img_size)
        self.patch_size = model.patch_size

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise NotImplementedError
