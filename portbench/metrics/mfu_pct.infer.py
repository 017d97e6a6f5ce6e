"""mfu_pct.infer: the work of the window's scenes (one encoder pass an
image, a decoder pass and a head a view of each pair; padding not counted;
`portbench/flops.py`) over the window's seconds, as a share of the H100's
989 TFLOP/s dense bf16. Read in the untraced window."""
from portbench import flops


def read(rec):
    work = sum(flops.scene_flops(rec["arch"], s["images"], s["pairs"], s["height"], s["width"])
               for s in rec["scenes"])
    return 100.0 * work / rec["window_s"] / flops.PEAK_BF16_FLOPS
