"""The offline preprocess scripts: each dataset's download -> its loader's
layout (`dust3r_tpu_torch/datasets/`).

Counterparts of the JAX package's `datasets_preprocess/` scripts, with the
same arguments and outputs, run as

    python -m dust3r_tpu_torch.datasets_preprocess.preprocess_<name> ...
    python -m dust3r_tpu_torch.datasets_preprocess.habitat.preprocess_habitat ...

They need numpy and PIL (scipy through the port); the cv2 calls of the JAX
scripts are `utils/cvops.py`. The optional packages stay optional, imported
by the stage that needs them: h5py (MegaDepth's depth), tensorflow and
waymo_open_dataset (Waymo's stage 1), pyrender and trimesh (ScanNet++'s
depth render), habitat_sim (Habitat's envmaps). Each of those stages takes
a stand-in where a caller has its output another way (`tools/raw_scenes.py`).
"""
