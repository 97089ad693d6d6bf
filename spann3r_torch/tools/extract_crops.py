"""Extract cropped image pairs for CroCo pre-training.

Port of croco/datasets/crops/extract_crops_from_images.py:17-159: reads a
crop-list file (pair header lines "img1, img2, rotation" followed by
8-int crop-rectangle lines), shards outputs into a hex subdirectory tree
sized so each directory holds ~ideal_number_pairs_in_dir pairs, crops /
resizes (Lanczos when downscaling >4x else bicubic) / rotation-snaps the
second image, writes <path>_1.jpg/_2.jpg and a listing.txt manifest.
Pure-CPU data tooling — consumed later by the pairs dataset
(spann3r_tpu/datasets/pairs.py CROP_DATASETS entries).
"""
from __future__ import annotations

import argparse
import functools
import math
import os
from multiprocessing import Pool

import PIL.Image


def arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "Generate cropped image pairs from an image crop list")
    p.add_argument("--crops", type=str, required=True, help="crop file")
    p.add_argument("--root-dir", type=str, required=True)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--imsize", type=int, default=256)
    p.add_argument("--nthread", type=int, required=True)
    p.add_argument("--max-subdir-levels", type=int, default=5)
    p.add_argument("--ideal-number-pairs-in-dir", type=int, default=500)
    return p


def load_crop_file(path):
    """Parse the crop list (ref extract_crops_from_images.py:57-74):
    short lines open a new pair (img1, img2, rotation); 8-int lines append
    an (rect1, rect2) crop to the current pair."""
    pairs, num_crops = [], 0
    with open(path) as f:
        for line in f.read().splitlines():
            if line.startswith("#"):
                continue
            parts = line.split(", ")
            if len(parts) < 8:
                img1, img2, rotation = parts
                pairs.append((img1, img2, int(rotation), []))
            else:
                l1, r1, t1, b1, l2, r2, t2, b2 = map(int, parts)
                pairs[-1][-1].append(((l1, t1, r1, b1), (l2, t2, r2, b2)))
                num_crops += 1
    return pairs, num_crops


def prepare_jobs(pairs, num_levels, num_pairs_in_dir):
    """Assign each crop a hex path with num_levels components
    (ref extract_crops_from_images.py:77-97)."""
    powers = [num_pairs_in_dir ** level for level in reversed(range(num_levels))]

    def get_path(idx):
        idx_array, d = [], idx
        for level in range(num_levels - 1):
            idx_array.append(idx // powers[level])
            idx = idx % powers[level]
        idx_array.append(d)
        return "/".join(hex(x)[2:] for x in idx_array)

    jobs, idx = [], 0
    for img1, img2, rotation, crops in pairs:
        if -60 <= rotation <= 60:
            rotation = 0  # most likely not a true rotation
        paths = [get_path(idx + k) for k in range(len(crops))]
        idx += len(crops)
        jobs.append(((img1, img2), rotation, crops, paths))
    return jobs


def _load_image(path):
    try:
        return PIL.Image.open(path).convert("RGB")
    except Exception as e:  # skip unreadable images, keep the run going
        print("skipping", path, e)
        raise OSError()


def save_image_crops(args, data):
    """Crop, resize, rotation-snap and save one pair's crops
    (ref extract_crops_from_images.py:107-156)."""
    img_pair, rot, crops, paths = data
    try:
        img1, img2 = [_load_image(os.path.join(args.root_dir, p))
                      for p in img_pair]
    except OSError:
        return []

    tgt = (args.imsize, args.imsize)

    def prepare_crop(img, rect, rot=0):
        img = img.crop(rect)
        # Lanczos only when shrinking a lot; bicubic otherwise
        big = img.size[0] * img.size[1] > 4 * tgt[0] * tgt[1]
        img = img.resize(tgt, resample=PIL.Image.Resampling.LANCZOS if big
                         else PIL.Image.Resampling.BICUBIC)
        rot90 = (round(rot / 90) % 4) * 90
        transpose = {90: PIL.Image.Transpose.ROTATE_90,
                     180: PIL.Image.Transpose.ROTATE_180,
                     270: PIL.Image.Transpose.ROTATE_270}.get(rot90)
        return img.transpose(transpose) if transpose else img

    results = []
    for (rect1, rect2), path in zip(crops, paths):
        full1 = os.path.join(args.output_dir, path + "_1.jpg")
        full2 = os.path.join(args.output_dir, path + "_2.jpg")
        os.makedirs(os.path.dirname(full1), exist_ok=True)
        assert not os.path.isfile(full1), full1
        assert not os.path.isfile(full2), full2
        prepare_crop(img1, rect1).save(full1)
        prepare_crop(img2, rect2, rot).save(full2)
        results.append(path)
    return results


def main(args):
    listing_path = os.path.join(args.output_dir, "listing.txt")
    crops, num_crops = load_crop_file(args.crops)

    num_levels = min(
        math.ceil(math.log(max(num_crops, 2), args.ideal_number_pairs_in_dir)),
        args.max_subdir_levels)
    num_pairs_in_dir = math.ceil(num_crops ** (1 / max(num_levels, 1)))
    jobs = prepare_jobs(crops, num_levels, num_pairs_in_dir)
    del crops

    os.makedirs(args.output_dir, exist_ok=True)
    mmap = Pool(args.nthread).imap_unordered if args.nthread > 1 else map
    call = functools.partial(save_image_crops, args)
    with open(listing_path, "w") as listing:
        listing.write("# pair_path\n")
        for results in mmap(call, jobs):
            for path in results:
                listing.write(f"{path}\n")
    print("Finished writing listing to", listing_path)


if __name__ == "__main__":
    main(arg_parser().parse_args())
