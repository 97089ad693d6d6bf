"""Dataset generation / regeneration / packing drivers.

Reference: croco/datasets/habitat_sim/{generate_multiview_images.py,
generate_from_metadata.py, generate_from_metadata_files.py,
pack_metadata_files.py, paths.py}.  Output layout is exactly what
datasets/habitat.py and datasets/pairs.py consume:
<seq:08d>_<i>.jpeg [+ _depth.exr + _camera_params.json] + metadata.json.

Depth is written as EXR when this cv2 build supports it; otherwise as
float16 .npy next to the same stem (the consumer reads either).
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os

import numpy as np
import PIL.Image

from . import quat
from .generator import MultiviewSceneGenerator, NoNavigableSpaceError

# ref paths.py:14-23 — remap per deployment via this dict or $HABITAT_DATA
SCENES_DATASET = {
    "hm3d": "./data/habitat-sim-data/scene_datasets/hm3d/",
    "gibson": "./data/habitat-sim-data/scene_datasets/gibson/",
    "habitat-test-scenes":
        "./data/habitat-sim-data/scene_datasets/habitat_test_scenes",
    "replica_cad_baked_lighting":
        "./data/habitat-sim/scene_datasets/replica_cad_baked_lighting/",
    "replica_cad": "./data/habitat-sim/scene_datasets/replica_cad/",
    "replica": "./data/habitat-sim-data/scene_datasets/ReplicaDataset",
    "scannet": "./data/habitat-sim/scene_datasets/scannet/",
}

SceneData = collections.namedtuple(
    "SceneData",
    ["scene_dataset_config_file", "scene", "navmesh", "output_dir"])


def list_scenes(base_output_dir, base_path):
    """Walk a folder for .glb scenes (+ optional sibling .navmesh), with
    the HM3D .basis.glb preference rule (ref paths.py:72-101)."""
    scenes_data = []
    for root, _dirs, files in os.walk(base_path, followlinks=True):
        folder = []
        for file in files:
            name, ext = os.path.splitext(file)
            if ext == ".glb":
                navmesh = os.path.join(root, name + ".navmesh")
                if not os.path.exists(navmesh):
                    navmesh = ""
                relpath = os.path.relpath(root, base_path)
                folder.append(SceneData(
                    scene_dataset_config_file="",
                    scene=os.path.join(root, name + ".glb"),
                    navmesh=navmesh,
                    output_dir=os.path.abspath(
                        os.path.join(base_output_dir, relpath, name))))
        basis = [d.scene[:-len(".basis.glb")] for d in folder
                 if d.scene.endswith(".basis.glb")]
        if basis:
            folder = [d for d in folder
                      if d.scene[:-len(".glb")] not in basis]
        scenes_data.extend(folder)
    return scenes_data


def list_replicacad_scenes(base_output_dir,
                           base_path=None):
    """ref paths.py:27-40."""
    base_path = base_path or SCENES_DATASET["replica_cad"]
    cfg = os.path.join(base_path, "replicaCAD.scene_dataset_config.json")
    scenes = [f"apt_{i}" for i in range(6)] + ["empty_stage"]
    navmeshes = [f"navmeshes/apt_{i}_static_furniture.navmesh"
                 for i in range(6)] + ["empty_stage.navmesh"]
    return [SceneData(
        scene_dataset_config_file=cfg,
        scene=s + ".scene_instance.json",
        navmesh=os.path.join(base_path, n),
        output_dir=os.path.join(base_output_dir, "ReplicaCAD", s))
        for s, n in zip(scenes, navmeshes)]


def list_scenes_available(base_output_dir,
                          scenes_dataset_paths=SCENES_DATASET):
    """Gibson + habitat-test-scenes, like the reference's enabled set
    (ref paths.py:103-129)."""
    out = []
    for key in ("gibson", "habitat-test-scenes"):
        if os.path.isdir(scenes_dataset_paths[key]):
            out += list_scenes(
                base_output_dir=os.path.join(base_output_dir, key),
                base_path=scenes_dataset_paths[key])
    return out


def _write_depth(stem: str, depth: np.ndarray):
    """EXR via cv2 when supported, else float16 npy (this image's cv2 has
    no EXR codec).  Returns the filename written."""
    import cv2
    fname = stem + "_depth.exr"
    try:
        ok = cv2.imwrite(fname, depth.astype(np.float32),
                         [cv2.IMWRITE_EXR_TYPE, cv2.IMWRITE_EXR_TYPE_HALF])
    except cv2.error:
        ok = False
    if not ok:
        fname = stem + "_depth.npy"
        np.save(fname, depth.astype(np.float16))
    return fname


def _save_observation(output_dir, idx_label, oidx, observation,
                      generate_depth):
    """One view's files (ref generate_multiview_images.py:84-97;
    observation index starts at 1)."""
    stem = os.path.join(output_dir, f"{idx_label}_{oidx + 1}")
    PIL.Image.fromarray(observation["color"][:, :, :3]).save(stem + ".jpeg")
    if generate_depth:
        _write_depth(stem, observation["depth"])
        camera_params = {k: observation[k].tolist() for k in
                         ("camera_intrinsics", "R_cam2world", "t_cam2world")}
        with open(stem + "_camera_params.json", "w") as f:
            json.dump(camera_params, f)


def generate_multiview_images_for_scene(
        scene_dataset_config_file, scene, navmesh, output_dir, views_count,
        size, exist_ok=False, generate_depth=False, **kwargs):
    """Resumable tuple generation for one scene
    (ref generate_multiview_images.py:17-116): metadata.json accumulates
    poses/covisibilities and is the restart point."""
    if os.path.exists(output_dir) and not exist_ok:
        print(f"Scene {scene}: data already generated. Ignoring generation.")
        return
    try:
        print(f"Scene {scene}: {size} multiview acquisitions to generate...")
        os.makedirs(output_dir, exist_ok=exist_ok)
        metadata_filename = os.path.join(output_dir, "metadata.json")
        metadata_template = dict(
            scene_dataset_config_file=scene_dataset_config_file, scene=scene,
            navmesh=navmesh, views_count=views_count, size=size,
            generate_depth=generate_depth, **kwargs)
        # json roundtrip so tuples (e.g. resolution) compare equal against a
        # reloaded metadata file on resume (ref only ever passes lists)
        metadata_template = json.loads(json.dumps(metadata_template))
        metadata_template["multiviews"] = dict()

        if os.path.exists(metadata_filename):
            print("Loading already generated metadata file...")
            with open(metadata_filename) as f:
                metadata = json.load(f)
            for key in metadata_template:
                if key != "multiviews":
                    assert metadata_template[key] == metadata[key], \
                        f"existing file inconsistent on key {key}"
        else:
            metadata = metadata_template

        starting_id = len(metadata["multiviews"])
        print(f"Starting generation from index {starting_id}/{size}...")
        if starting_id >= size:
            print("Generation already done.")
            return

        generator = MultiviewSceneGenerator(
            scene_dataset_config_file=scene_dataset_config_file, scene=scene,
            navmesh=navmesh, views_count=views_count, size=size, **kwargs)

        for idx in range(starting_id, size):
            try:
                data = generator[idx]
            except RuntimeError as e:
                print(f"Sampling failed ({e}); stopping this scene here.")
                break
            idx_label = f"{idx:08}"
            for oidx, observation in enumerate(data["observations"]):
                _save_observation(output_dir, idx_label, oidx, observation,
                                  generate_depth)
            metadata["multiviews"][idx_label] = {
                "positions": data["positions"].tolist(),
                "orientations": data["orientations"].tolist(),
                "covisibility_ratios": data["covisibility_ratios"].tolist(),
                "valid_fractions": data["valid_fractions"].tolist(),
                "pairwise_visibility_ratios":
                    data["pairwise_visibility_ratios"].tolist()}
            if idx % 10 == 0:  # restartable temporary metadata
                with open(metadata_filename, "w") as f:
                    json.dump(metadata, f)
        with open(metadata_filename, "w") as f:
            json.dump(metadata, f)
        generator.close()
    except NoNavigableSpaceError:
        pass


def generate_multiview_images_from_metadata(
        metadata_filename, output_dir, overload_params=None,
        scene_datasets_paths=None, exist_ok=False):
    """Re-render a dataset from a packed metadata file, exactly reproducing
    the recorded poses (ref generate_from_metadata.py:17-77)."""
    overload_params = overload_params or {}
    if scene_datasets_paths is not None:
        scene_datasets_paths = dict(sorted(
            scene_datasets_paths.items(), key=lambda x: len(x[0]),
            reverse=True))
    with open(metadata_filename) as f:
        input_metadata = json.load(f)
    metadata = dict()
    for key, value in input_metadata.items():
        if key in ("scene_dataset_config_file", "scene", "navmesh") \
                and value != "" and scene_datasets_paths is not None:
            for label, path in scene_datasets_paths.items():
                if value.startswith(label):
                    value = os.path.normpath(os.path.join(
                        path, os.path.relpath(value, label)))
                    break
        metadata[key] = value
    for key, value in overload_params.items():
        metadata[key] = value

    generation_entries = {k: v for k, v in metadata.items()
                          if k not in ("multiviews", "output_dir",
                                       "generate_depth")}
    generate_depth = metadata["generate_depth"]
    os.makedirs(output_dir, exist_ok=exist_ok)
    generator = MultiviewSceneGenerator(**generation_entries)
    for idx_label, data in metadata["multiviews"].items():
        positions = data["positions"]
        orientations = data["orientations"]
        for oidx in range(len(positions)):
            observation = generator.render_viewpoint(
                np.asarray(positions[oidx]),
                quat.from_float_array(orientations[oidx]))
            _save_observation(output_dir, idx_label, oidx, observation,
                              generate_depth)
    with open(os.path.join(output_dir, "metadata.json"), "w") as f:
        json.dump(metadata, f)
    generator.close()


def commandlines_from_metadata_files(input_dir, output_dir, prefix=""):
    """Emit one regeneration commandline per packed metadata file found
    under input_dir, skipping scenes whose output metadata already exists
    (ref generate_from_metadata_files.py:12-28).  Returns the list so
    batch schedulers (or tests) can consume it without capturing stdout."""
    lines = []
    for metadata_filename in sorted(
            glob.iglob(f"{input_dir}/**/metadata.json", recursive=True)):
        out = os.path.join(output_dir, os.path.relpath(
            os.path.dirname(metadata_filename), input_dir))
        if os.path.exists(os.path.join(out, "metadata.json")):
            continue
        lines.append(
            f"{prefix}python -m spann3r_torch.habitat_gen.scripts "
            f"--from_metadata {metadata_filename} --output_dir {out}")
    return lines


def pack_metadata_files(input_dirname, output_dirname,
                        scenes_dataset_paths=SCENES_DATASET):
    """Strip deployment-specific path prefixes from metadata files so the
    dataset regenerates elsewhere (ref pack_metadata_files.py)."""
    input_files = glob.iglob(f"{input_dirname}/**/metadata.json",
                             recursive=True)
    images_count = collections.defaultdict(int)
    os.makedirs(output_dirname)
    sorted_paths = dict(sorted(scenes_dataset_paths.items(),
                               key=lambda x: len(x[1]), reverse=True))
    for input_filename in input_files:
        with open(input_filename) as f:
            original = json.load(f)
        if not original.get("multiviews"):
            print("No views in", input_filename)
            continue
        relpath = os.path.relpath(input_filename, input_dirname)
        metadata = dict()
        for key, value in original.items():
            if key in ("scene_dataset_config_file", "scene", "navmesh") \
                    and value != "":
                known = False
                for dataset, dataset_path in sorted_paths.items():
                    if value.startswith(dataset_path):
                        value = os.path.join(
                            dataset, os.path.relpath(value, dataset_path))
                        known = True
                        break
                if not known:
                    raise KeyError("Unknown path:" + value)
            metadata[key] = value
        scene_split = metadata["scene"].split("/")
        upper = ("/".join(scene_split[:2]) if scene_split[0] == "hm3d"
                 else scene_split[0])
        images_count[upper] += len(metadata["multiviews"])
        out = os.path.join(output_dirname, relpath)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump(metadata, f)
    print("Images count:")
    for upper, count in images_count.items():
        print(f"> {upper}: {count}")
    return dict(images_count)


def main():
    """CLI mirroring generate_multiview_images.py:119-177."""
    parser = argparse.ArgumentParser(
        description="Generate multiview crossview tuples "
                    "(--scene __boxroom__ for the synthetic renderer)")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--list_commands", action="store_true")
    parser.add_argument("--from_metadata", type=str, default="",
                        help="regenerate from one packed metadata.json "
                             "(ref generate_from_metadata.py)")
    parser.add_argument("--from_metadata_dir", type=str, default="",
                        help="print regeneration commandlines for every "
                             "metadata.json under this dir "
                             "(ref generate_from_metadata_files.py)")
    parser.add_argument("--prefix", type=str, default="",
                        help="commandline prefix for --from_metadata_dir")
    parser.add_argument("--scene", type=str, default="")
    parser.add_argument("--scene_dataset_config_file", type=str, default="")
    parser.add_argument("--navmesh", type=str, default="")
    parser.add_argument("--generate_depth", type=int, default=1)
    parser.add_argument("--exist_ok", type=int, default=0)
    parser.add_argument("--views_count", type=int, default=5)
    parser.add_argument("--size", type=int, default=200)
    parser.add_argument("--resolution", type=int, nargs=2,
                        default=[256, 256])
    parser.add_argument("--hfov", type=float, default=60)
    parser.add_argument("--minimum_covisibility", type=float, default=0.1)
    args = parser.parse_args()

    if args.from_metadata_dir:
        for line in commandlines_from_metadata_files(
                args.from_metadata_dir, args.output_dir, args.prefix):
            print(line)
        return
    if args.from_metadata:
        generate_multiview_images_from_metadata(
            args.from_metadata, args.output_dir,
            exist_ok=bool(args.exist_ok))
        return
    if args.list_commands:
        for sd in list_scenes_available(base_output_dir=args.output_dir):
            print(f"python -m spann3r_torch.habitat_gen.scripts "
                  f"--scene {sd.scene or '\"\"'} "
                  f"--scene_dataset_config_file "
                  f"{sd.scene_dataset_config_file or '\"\"'} "
                  f"--navmesh {sd.navmesh or '\"\"'} "
                  f"--output_dir {sd.output_dir} "
                  f"--generate_depth {args.generate_depth} "
                  f"--exist_ok {int(args.exist_ok)}")
        return
    if not args.scene:
        parser.error("missing --scene (or --list_commands)")
    generate_multiview_images_for_scene(
        scene=args.scene,
        scene_dataset_config_file=args.scene_dataset_config_file,
        navmesh=args.navmesh, output_dir=args.output_dir,
        views_count=args.views_count, size=args.size,
        exist_ok=bool(args.exist_ok),
        generate_depth=bool(args.generate_depth),
        resolution=tuple(args.resolution), hfov=args.hfov,
        minimum_covisibility=args.minimum_covisibility)


if __name__ == "__main__":
    main()
