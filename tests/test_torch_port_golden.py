"""The port held to the JAX package's 512-bucket goldens on the CPU.

`tests/golden/bucket512_{dpt,linear}.npz` (written by
`scripts/make_goldens.py`) are 384x512 inputs through the real structural
path: a 24x32 patch grid, RoPE over it, and for the DPT head the full
resolution cascade with hooks at (0, 6, 9, 12), the 24x32 and 12x16 grids
on which the card's attention and conv3x3 kernels split their work. The
JAX package is held to them by tests/test_golden.py:57-76. Here the same
seeded JAX parameters (`bucket_model_and_inputs`; JAX builds them, nothing
else) go through `state_dict_from_jax` into the port, whose fp32 forward
on CPU tensors (its plain versions) must land on the goldens at that
test's limits: 2e-4 of the absmean on the every-4th-pixel subsample, 1e-4
on the full-tensor mean.
"""
import os.path as osp
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "scripts"))

from make_goldens import BUCKET_CFGS, bucket_model_and_inputs, outputs_to_golden  # noqa: E402

from dust3r_tpu_torch.checkpoint import state_dict_from_jax  # noqa: E402
from dust3r_tpu_torch.models.model import AsymmetricCroCo3DStereo  # noqa: E402

GOLDEN_DIR = osp.join(osp.dirname(osp.abspath(__file__)), "golden")


@pytest.mark.parametrize("head_type", ["dpt", "linear"])
def test_port_matches_the_512_bucket_golden(head_type):
    _, variables, img1, img2 = bucket_model_and_inputs(head_type)
    cfg = {k: v for k, v in BUCKET_CFGS[head_type].items() if k != "attn_impl"}
    port = AsymmetricCroCo3DStereo(**cfg, device="cpu").eval()
    port.load_state_dict(state_dict_from_jax(jax.device_get(variables), cfg["enc_depth"],
                                             cfg["dec_depth"], head_type), strict=True)
    with torch.no_grad():
        r1, r2 = port(torch.from_numpy(np.array(img1)), torch.from_numpy(np.array(img2)))
    assert r1["pts3d"].shape == (1, 384, 512, 3) and r2["conf"].shape == (1, 384, 512)
    out = outputs_to_golden({k: v.numpy() for k, v in r1.items()},
                            {k: v.numpy() for k, v in r2.items()})
    golden = np.load(osp.join(GOLDEN_DIR, f"bucket512_{head_type}.npz"))
    for k in ("pts3d1", "conf1", "pts3d2", "conf2"):
        scale = max(float(golden[k + "_absmean"]), 1e-6)
        np.testing.assert_allclose(out[k] / scale, golden[k] / scale, rtol=2e-4, atol=2e-4,
                                   err_msg=f"{head_type}/{k}: the port left the golden")
        np.testing.assert_allclose(out[k + "_mean"] / scale, golden[k + "_mean"] / scale,
                                   rtol=1e-4, atol=1e-4)
