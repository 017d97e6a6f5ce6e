"""The demo: images -> pairs -> inference -> global alignment -> a 3D scene
file and a gallery, in a gradio UI or headless.

Counterpart of `dust3r_tpu/demo.py` (reference dust3r/demo.py:20-287): the
scene-graph choice, the confidence-threshold, camera-size, sky-mask and
depth-cleanup controls that re-export the scene without running inference
again. The engine is the port's `InferenceEngine`, the model comes from
`checkpoint.from_pretrained`, and the aligner runs on `device` (the CUDA
card by default). The scene is exported as a GLB through `trimesh`, or,
where `trimesh` is missing (as it is on both of this repo's machines), as
a binary PLY point cloud with the cameras' frusta sampled as points, as the
JAX package does. `gradio` is imported only inside the UI functions.

    python -m dust3r_tpu_torch.demo --weights ckpt.pth                # the UI
    python -m dust3r_tpu_torch.demo --weights ckpt.pth --images a.jpg b.jpg c.jpg \\
        --outdir out                                                  # headless

`--quantize int8` runs the transformer's projections on int8 operands
(`ops/quant.py`); `--serving` is the JAX package's serving configuration:
bf16 body, bf16 heads and `--quantize int8`. `--mesh N` splits each batch
of N pairs over the first N cards (`InferenceEngine(mesh=)`, one replica a
card) and the aligner's edges over the same cards, as the root `demo.py`
does; more cards than are visible raises.
"""
from __future__ import annotations

import argparse
import builtins
import copy
import datetime
import functools
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .cloud_opt import GlobalAlignerMode, global_aligner
from .image_pairs import make_pairs
from .inference import inference
from .utils.image import jet, load_images, rgb
from .viz import CAM_COLORS, OPENGL, add_scene_cam, cat_meshes, pts3d_to_trimesh, uint8


def get_args_parser():
    parser = argparse.ArgumentParser(prog="python -m dust3r_tpu_torch.demo")
    parser_url = parser.add_mutually_exclusive_group()
    parser_url.add_argument("--local_network", action="store_true", default=False)
    parser_url.add_argument("--server_name", type=str, default=None)
    parser.add_argument("--image_size", type=int, default=512, choices=[512, 224])
    parser.add_argument("--server_port", type=int, default=None)
    parser_weights = parser.add_mutually_exclusive_group(required=True)
    parser_weights.add_argument("--weights", type=str, default=None,
                                help="path to a .pth checkpoint or a hub snapshot")
    parser_weights.add_argument("--model_name", type=str,
                                choices=["DUSt3R_ViTLarge_BaseDecoder_512_dpt",
                                         "DUSt3R_ViTLarge_BaseDecoder_512_linear",
                                         "DUSt3R_ViTLarge_BaseDecoder_224_linear"])
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the model and the aligner run")
    parser.add_argument("--mesh", type=int, default=0,
                        help="shard inference and the aligner's edges over this many cards "
                             "(0: one device, --device)")
    parser.add_argument("--quantize", type=str, default=None, choices=["int8"],
                        help="int8 serving mode: the transformer's projections on int8 "
                             "operands (ops/quant.py)")
    parser.add_argument("--serving", action="store_true",
                        help="the serving configuration: bf16 body, bf16 heads and "
                             "--quantize int8")
    parser.add_argument("--tmp_dir", type=str, default=None)
    parser.add_argument("--silent", action="store_true", default=False)
    parser.add_argument("--images", type=str, nargs="+", default=None,
                        help="image files (or one folder): reconstruct once with the UI's "
                             "defaults, without the UI")
    parser.add_argument("--outdir", type=str, default=".",
                        help="where a run with --images writes its scene file")
    return parser


def set_print_with_timestamp(time_format="%Y-%m-%d %H:%M:%S"):
    builtin_print = builtins.print

    def print_with_timestamp(*args, **kwargs):
        now = datetime.datetime.now().strftime(time_format)
        builtin_print(f"[{now}] ", end="")
        builtin_print(*args, **kwargs)

    builtins.print = print_with_timestamp


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _export_scene_ply(outdir, imgs, pts3d, mask, focals, cams2world, cam_size=0.05,
                      silent=False):
    """Coloured point cloud plus camera frusta (8 segments of 16 points a
    camera) in one binary PLY, in the OpenGL frame anchored on camera 0:
    the scene file where trimesh is missing."""
    pts = np.concatenate([p[m].reshape(-1, 3) for p, m in zip(pts3d, mask)])
    col = uint8(np.concatenate([im[m].reshape(-1, 3) for im, m in zip(imgs, mask)]))
    cam_pts, cam_cols = [], []
    for i, c2w in enumerate(np.asarray(cams2world)):
        color = CAM_COLORS[i % len(CAM_COLORS)]
        h, w = imgs[i].shape[:2]
        # frustum: camera centre -> 4 image-plane corners at depth cam_size
        corners = cam_size * np.array([[x * w / (2 * focals[i]), y * h / (2 * focals[i]), 1.0]
                                       for x, y in ((-1, -1), (1, -1), (1, 1), (-1, 1))])
        segs = ([(np.zeros(3), c) for c in corners]
                + [(corners[k], corners[(k + 1) % 4]) for k in range(4)])
        t = np.linspace(0, 1, 16)[:, None]
        local = np.concatenate([a * (1 - t) + b * t for a, b in segs])
        world = local @ c2w[:3, :3].T + c2w[:3, 3]
        cam_pts += [world[16 * k:16 * (k + 1)] for k in range(8)]
        cam_cols += [np.tile(color, (16, 1))] * 8
    verts = np.concatenate([pts] + cam_pts).astype(np.float32)
    cols = np.concatenate([col] + cam_cols).astype(np.uint8)
    roty = np.eye(4)
    roty[0, 0] = roty[2, 2] = -1
    trf = np.linalg.inv(np.asarray(cams2world)[0] @ OPENGL @ roty)
    verts = (verts @ trf[:3, :3].T + trf[:3, 3]).astype(np.float32)
    outfile = os.path.join(outdir, "scene.ply")
    with open(outfile, "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\nelement vertex {len(verts)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                 "end_header\n").encode())
        rec = np.zeros(len(verts), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
        rec["xyz"] = verts
        rec["rgb"] = cols
        f.write(rec.tobytes())
    if not silent:
        print("(trimesh unavailable; exported point-cloud PLY to", outfile, ")")
    return outfile


def _convert_scene_output_to_glb(outdir, imgs, pts3d, mask, focals, cams2world, cam_size=0.05,
                                 cam_color=None, as_pointcloud=False, transparent_cams=False,
                                 silent=False):
    imgs = [np.asarray(im) for im in imgs]
    pts3d = [_host(p) for p in pts3d]
    focals = _host(focals).reshape(-1)
    cams2world = _host(cams2world)
    try:
        import trimesh
    except ImportError:
        return _export_scene_ply(outdir, imgs, pts3d, mask, focals, cams2world,
                                 cam_size=cam_size, silent=silent)

    assert len(pts3d) == len(mask) <= len(imgs) <= len(cams2world) == len(focals)
    scene = trimesh.Scene()
    if as_pointcloud:
        pts = np.concatenate([p[m] for p, m in zip(pts3d, mask)])
        col = np.concatenate([p[m] for p, m in zip(imgs, mask)])
        scene.add_geometry(trimesh.PointCloud(pts.reshape(-1, 3), colors=col.reshape(-1, 3)))
    else:
        meshes = [pts3d_to_trimesh(imgs[i], pts3d[i], mask[i]) for i in range(len(imgs))]
        scene.add_geometry(trimesh.Trimesh(**cat_meshes(meshes)))
    for i, pose_c2w in enumerate(cams2world):
        color = (cam_color[i] if isinstance(cam_color, list)
                 else cam_color or CAM_COLORS[i % len(CAM_COLORS)])
        add_scene_cam(scene, pose_c2w, color, None if transparent_cams else imgs[i], focals[i],
                      imsize=imgs[i].shape[1::-1], screen_width=cam_size)
    roty = np.eye(4)
    roty[0, 0] = roty[2, 2] = -1  # 180 degrees about y: the OpenGL frame, camera 0's
    scene.apply_transform(np.linalg.inv(cams2world[0] @ OPENGL @ roty))
    outfile = os.path.join(outdir, "scene.glb")
    if not silent:
        print("(exporting 3D scene to", outfile, ")")
    scene.export(file_obj=outfile)
    return outfile


def get_3D_model_from_scene(outdir, silent, scene, min_conf_thr=3, as_pointcloud=False,
                            mask_sky=False, clean_depth=False, transparent_cams=False,
                            cam_size=0.05):
    if scene is None:
        return None
    if clean_depth:
        scene = scene.clean_pointcloud()
    if mask_sky:
        scene = scene.mask_sky()
    rgbimg = scene.imgs
    focals = _host(scene.get_focals())
    cams2world = _host(scene.get_im_poses())
    pts3d = [_host(p) for p in scene.get_pts3d()]
    # the reference's quirk (dust3r/demo.py:131): the UI's threshold goes
    # through the confidence transform before it meets the raw maps
    scene.min_conf_thr = float(scene.conf_trf(torch.tensor(float(min_conf_thr))))
    msk = scene.get_masks()
    return _convert_scene_output_to_glb(outdir, rgbimg, pts3d, msk, focals, cams2world,
                                        as_pointcloud=as_pointcloud,
                                        transparent_cams=transparent_cams, cam_size=cam_size,
                                        silent=silent)


def get_reconstructed_scene(outdir, engine, device, silent, image_size, filelist, schedule,
                            niter, min_conf_thr, as_pointcloud, mask_sky, clean_depth,
                            transparent_cams, cam_size, scenegraph_type, winsize, refid):
    """Load -> pairs -> inference -> align (on `device`) -> scene file;
    returns (scene, scene file, gallery of rgb / depth / confidence an
    image). `scene.demo_seconds` holds the host seconds of each stage
    (inference and the loop end waiting for the device)."""
    clock = [time.perf_counter()]

    def lap():
        clock.append(time.perf_counter())
        return clock[-1] - clock[-2]

    patch_size = getattr(engine.model, "patch_size", 16)
    imgs = load_images(filelist, size=image_size, verbose=not silent, patch_size=patch_size)
    if len(imgs) == 1:
        imgs = [imgs[0], copy.deepcopy(imgs[0])]
        imgs[1]["idx"] = 1
    if scenegraph_type == "swin":
        scenegraph_type = f"swin-{winsize}"
    elif scenegraph_type == "oneref":
        scenegraph_type = f"oneref-{refid}"

    pairs = make_pairs(imgs, scene_graph=scenegraph_type, prefilter=None, symmetrize=True)
    seconds = dict(load=lap())
    output = inference(pairs, engine, verbose=not silent)
    seconds["inference"] = lap()

    mode = (GlobalAlignerMode.PointCloudOptimizer if len(imgs) > 2
            else GlobalAlignerMode.PairViewer)
    scene = global_aligner(output, device=device, mode=mode, verbose=not silent,
                           mesh=getattr(engine, "mesh", None))
    seconds["scene"] = lap()
    if mode == GlobalAlignerMode.PointCloudOptimizer:
        scene.compute_global_alignment(init="mst", niter=niter, schedule=schedule, lr=0.01)
    seconds["align"] = lap()

    outfile = get_3D_model_from_scene(outdir, silent, scene, min_conf_thr, as_pointcloud,
                                      mask_sky, clean_depth, transparent_cams, cam_size)
    seconds["export"] = lap()

    rgbimg = scene.imgs
    depths = [_host(d) for d in scene.get_depthmaps()]
    confs = [np.asarray(c) for c in scene.im_conf]
    depths_max = max(d.max() for d in depths)
    depths = [d / depths_max for d in depths]
    confs_max = max(c.max() for c in confs)
    confs = [jet(c / confs_max) for c in confs]
    gallery = []
    for i in range(len(rgbimg)):
        gallery += [rgbimg[i], rgb(depths[i]), rgb(confs[i])]
    seconds["gallery"] = lap()
    scene.demo_seconds = seconds
    return scene, outfile, gallery


def set_scenegraph_options(inputfiles, winsize, refid, scenegraph_type):
    import gradio

    num_files = len(inputfiles) if inputfiles is not None else 1
    max_winsize = max(1, math.ceil((num_files - 1) / 2))
    winsize = gradio.Slider(label="Scene Graph: Window Size", value=max_winsize, minimum=1,
                            maximum=max_winsize, step=1, visible=scenegraph_type == "swin")
    refid = gradio.Slider(label="Scene Graph: Id", value=0, minimum=0, maximum=num_files - 1,
                          step=1, visible=scenegraph_type == "oneref")
    return winsize, refid


def main_demo(tmpdirname, engine, device, image_size, server_name, server_port, silent=False):
    import gradio

    recon_fun = functools.partial(get_reconstructed_scene, tmpdirname, engine, device, silent,
                                  image_size)
    model_from_scene_fun = functools.partial(get_3D_model_from_scene, tmpdirname, silent)
    css = """.gradio-container {margin: 0 !important; min-width: 100%};"""
    with gradio.Blocks(css=css, title="DUSt3R Demo (PyTorch / CUDA)") as demo:
        scene = gradio.State(None)
        gradio.HTML('<h2 style="text-align: center;">DUSt3R Demo (PyTorch / CUDA)</h2>')
        with gradio.Column():
            inputfiles = gradio.File(file_count="multiple")
            with gradio.Row():
                schedule = gradio.Dropdown(["linear", "cosine"], value="linear",
                                           label="schedule")
                niter = gradio.Number(value=300, precision=0, minimum=0, maximum=5000,
                                      label="num_iterations")
                scenegraph_type = gradio.Dropdown(
                    [("complete: all possible image pairs", "complete"),
                     ("swin: sliding window", "swin"),
                     ("oneref: match one image with all", "oneref")],
                    value="complete", label="Scenegraph", interactive=True)
                winsize = gradio.Slider(label="Scene Graph: Window Size", value=1, minimum=1,
                                        maximum=1, step=1, visible=False)
                refid = gradio.Slider(label="Scene Graph: Id", value=0, minimum=0, maximum=0,
                                      step=1, visible=False)
            run_btn = gradio.Button("Run")
            with gradio.Row():
                min_conf_thr = gradio.Slider(label="min_conf_thr", value=3.0, minimum=1.0,
                                             maximum=20, step=0.1)
                cam_size = gradio.Slider(label="cam_size", value=0.05, minimum=0.001,
                                         maximum=0.1, step=0.001)
            with gradio.Row():
                as_pointcloud = gradio.Checkbox(value=False, label="As pointcloud")
                mask_sky = gradio.Checkbox(value=False, label="Mask sky")
                clean_depth = gradio.Checkbox(value=True, label="Clean-up depthmaps")
                transparent_cams = gradio.Checkbox(value=False, label="Transparent cameras")
            outmodel = gradio.Model3D()
            outgallery = gradio.Gallery(label="rgb,depth,confidence", columns=3, height="100%")

            post_inputs = [scene, min_conf_thr, as_pointcloud, mask_sky, clean_depth,
                           transparent_cams, cam_size]
            graph_inputs = [inputfiles, winsize, refid, scenegraph_type]
            scenegraph_type.change(set_scenegraph_options, inputs=graph_inputs,
                                   outputs=[winsize, refid])
            inputfiles.change(set_scenegraph_options, inputs=graph_inputs,
                              outputs=[winsize, refid])
            run_btn.click(fn=recon_fun,
                          inputs=[inputfiles, schedule, niter, min_conf_thr, as_pointcloud,
                                  mask_sky, clean_depth, transparent_cams, cam_size,
                                  scenegraph_type, winsize, refid],
                          outputs=[scene, outmodel, outgallery])
            for ctl in (min_conf_thr, cam_size, as_pointcloud, mask_sky, clean_depth,
                        transparent_cams):
                event = (ctl.release if hasattr(ctl, "release") and ctl is min_conf_thr
                         else ctl.change)
                event(fn=model_from_scene_fun, inputs=post_inputs, outputs=outmodel)
    demo.launch(share=False, server_name=server_name, server_port=server_port)


def main(argv=None):
    """What the root `demo.py` does, on the port: load the weights, build
    the engine, then serve the UI (or, with --images, reconstruct once
    without it)."""
    from .parallel.mesh import cli_pair_mesh

    args = get_args_parser().parse_args(argv)
    mesh, batch_size = cli_pair_mesh(args.mesh)
    set_print_with_timestamp()
    if args.tmp_dir is not None:
        os.makedirs(args.tmp_dir, exist_ok=True)
        tempfile.tempdir = args.tmp_dir
    server_name = args.server_name or ("0.0.0.0" if args.local_network else "127.0.0.1")

    from .checkpoint import from_pretrained
    from .inference import InferenceEngine, serving_overrides

    model = from_pretrained(args.weights or "naver/" + args.model_name, device=args.device,
                            verbose=not args.silent, **serving_overrides(args))
    if mesh is None:
        engine = InferenceEngine(model, quantize=args.quantize)
    else:
        print(f"data-parallel inference over {batch_size} devices")
        engine = InferenceEngine(model, batch_size=batch_size, quantize=args.quantize,
                                 mesh=mesh)
    if args.images is not None:
        filelist = args.images[0] if len(args.images) == 1 and os.path.isdir(args.images[0]) \
            else args.images
        os.makedirs(args.outdir, exist_ok=True)
        _, outfile, _ = get_reconstructed_scene(  # the UI's defaults
            args.outdir, engine, args.device, args.silent, args.image_size, filelist,
            schedule="linear", niter=300, min_conf_thr=3.0, as_pointcloud=False,
            mask_sky=False, clean_depth=True, transparent_cams=False, cam_size=0.05,
            scenegraph_type="complete", winsize=1, refid=0)
        print("scene written to", outfile)
        return 0
    with tempfile.TemporaryDirectory(suffix="dust3r_gradio_demo") as tmp:
        if not args.silent:
            print("Outputing stuff in", tmp)
        main_demo(tmp, engine, args.device, args.image_size, server_name, args.server_port,
                  silent=args.silent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
