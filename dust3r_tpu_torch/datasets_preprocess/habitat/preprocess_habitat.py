#!/usr/bin/env python3
"""Habitat preprocessing driver: render crops at metadata viewpoints.

Counterpart of `datasets_preprocess/habitat/preprocess_habitat.py`: walks
the metadata dirs printing one command line per scene (for GNU parallel),
or renders one metadata file: an envmap at each stored viewpoint -> the
cropped jpeg + half-float EXR depth (`utils/exr.write_exr(..., half=True)`)
+ camera_params.json. The envmaps come from habitat-sim unless
`preprocess_metadata` is given another renderer.

    python -m dust3r_tpu_torch.datasets_preprocess.habitat.preprocess_habitat \\
        --metadata_dir META --scenes_dir SCENES --output_dir OUT [--metadata_filename F]
"""
import argparse
import glob
import json
import os

from . import multiview_crop_generator as mcg
from ...utils.exr import write_exr


def _resolve_scene(metadata, scenes_dir):
    """The metadata either names a bare scene file (HM3D/Gibson-style,
    resolved under scenes_dir) or a (scene, dataset-config) pair where the
    CONFIG is the path to resolve (replica-style)."""
    config = metadata["scene_dataset_config_file"]
    if config == "":
        return os.path.join(scenes_dir, metadata["scene"]), ""
    return metadata["scene"], os.path.join(scenes_dir, config)


def _iter_views(metadata):
    """Flatten view_batches into (label, view_params) rows."""
    for batch_label, batch in metadata["view_batches"].items():
        for view_label, view_params in batch.items():
            yield f"{batch_label}_{view_label}", view_params


def _render_and_write(renderer, view_params, output_dir, label):
    import PIL.Image

    projection, position = mcg.dict_to_perspective_projection(view_params)
    viewpoint = renderer.render_viewpoint_data(position)
    colormap, depthmap, _pointmap, _ = renderer.extract_cropped_camera(
        projection, viewpoint.colormap, viewpoint.distancemap,
        viewpoint.pointmap)

    stem = os.path.join(output_dir, label)
    PIL.Image.fromarray(colormap).save(stem + ".jpeg")
    write_exr(stem + "_depth.exr", depthmap, half=True)
    with open(stem + "_camera_params.json", "w") as f:
        json.dump(mcg.perspective_projection_to_dict(projection, position), f)


def preprocess_metadata(metadata_filename, scenes_dir, output_dir,
                        crop_resolution=(512, 512),
                        equirectangular_resolution=None,
                        fix_existing_dataset=False, envmap_renderer=None, seed=0):
    """envmap_renderer: the envmaps' source for `mcg.HabitatMultiviewCrops`
    (None: habitat-sim's); seed: the jitter's generator."""
    with open(metadata_filename) as f:
        metadata = json.load(f)
    scene, scene_config = _resolve_scene(metadata, scenes_dir)

    if equirectangular_resolution is None:
        # tall enough that a crop_resolution pinhole crop never upsamples
        side = 4 * max(crop_resolution)
        equirectangular_resolution = (side, 2 * side)

    if os.path.exists(output_dir) and not fix_existing_dataset:
        raise FileExistsError(output_dir)

    renderer = None  # habitat-sim init is expensive: only when needed
    for label, view_params in _iter_views(metadata):
        assert list(view_params["size"]) == list(crop_resolution)
        done_marker = os.path.join(output_dir,
                                   f"{label}_camera_params.json")
        if fix_existing_dataset and os.path.isfile(done_marker):
            continue
        if renderer is None:
            renderer = mcg.HabitatMultiviewCrops(
                scene=scene, navmesh=None,
                scene_dataset_config_file=scene_config,
                equirectangular_resolution=equirectangular_resolution,
                crop_resolution=crop_resolution, renderer=envmap_renderer, seed=seed)
            os.makedirs(output_dir, exist_ok=bool(fix_existing_dataset))
        _render_and_write(renderer, view_params, output_dir, label)


def _emit_scene_commands(args):
    """One ready-to-run command line per unprocessed scene (GNU parallel)."""
    pattern = os.path.join(args.metadata_dir, "**/metadata.json")
    for filename in glob.iglob(pattern, recursive=True):
        rel = os.path.relpath(os.path.dirname(filename), args.metadata_dir)
        output_dir = os.path.join(args.output_dir, rel)
        if os.path.exists(output_dir):
            continue
        print("python -m dust3r_tpu_torch.datasets_preprocess.habitat.preprocess_habitat"
              f" --metadata_filename={filename}"
              f" --metadata_dir={args.metadata_dir}"
              f" --scenes_dir={args.scenes_dir}"
              f" --output_dir={output_dir}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--metadata_dir", required=True)
    parser.add_argument("--scenes_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--metadata_filename", default="")
    args = parser.parse_args(argv)

    if args.metadata_filename:
        preprocess_metadata(metadata_filename=args.metadata_filename,
                            scenes_dir=args.scenes_dir,
                            output_dir=args.output_dir)
    else:
        _emit_scene_commands(args)


if __name__ == "__main__":
    main()
