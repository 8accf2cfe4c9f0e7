"""Pack each timestamp's camera PNGs into one HDF5 file.

The port's copy of heal_tpu/tools/img2hdf5.py: walking an OPV2V-layout
tree (scenario/cav/timestamp_cameraN.png), each timestamp's camera rig
is packed into ``{ts}_imgs.hdf5`` with datasets ``camera{i}`` (uint8
H x W x 3, gzip), the file ``OPV2VBackend._load_cameras`` reads before
the PNGs (data/opv2v.py). One process.

Usage:
    python -m heal_tpu_torch.tools.img2hdf5 --root dataset/OPV2V/train [--rm-png]
"""
from __future__ import annotations

import argparse
import os
import re
from collections import defaultdict

_CAM_RE = re.compile(r"^(?P<ts>\d+)_camera(?P<idx>\d+)\.png$")


def convert_cav_dir(cdir: str, rm_png: bool = False) -> int:
    """Convert one agent directory; returns #hdf5 files written."""
    import h5py

    from ..utils.camera import load_camera_images

    groups: dict[str, list[tuple[int, str]]] = defaultdict(list)
    for f in sorted(os.listdir(cdir)):
        m = _CAM_RE.match(f)
        if m:
            groups[m.group("ts")].append(
                (int(m.group("idx")), os.path.join(cdir, f))
            )
    written = 0
    for ts, cams in sorted(groups.items()):
        out = os.path.join(cdir, f"{ts}_imgs.hdf5")
        if os.path.exists(out):
            continue
        cams.sort()
        imgs = load_camera_images([p for _, p in cams])
        with h5py.File(out, "w") as h5:
            for (idx, _), img in zip(cams, imgs):
                h5.create_dataset(
                    f"camera{idx}", data=img, compression="gzip"
                )
        written += 1
        if rm_png:
            for _, p in cams:
                os.remove(p)
    return written


def convert_tree(root: str, rm_png: bool = False) -> int:
    """Convert every scenario/cav under an OPV2V split root."""
    total = 0
    for scenario in sorted(os.listdir(root)):
        sdir = os.path.join(root, scenario)
        if not os.path.isdir(sdir):
            continue
        for cav in sorted(os.listdir(sdir)):
            cdir = os.path.join(sdir, cav)
            if os.path.isdir(cdir) and not cav.startswith("."):
                n = convert_cav_dir(cdir, rm_png)
                total += n
                if n:
                    print(f"[img2hdf5] {scenario}/{cav}: {n} frames")
    return total


def main(argv=None):
    p = argparse.ArgumentParser("heal_tpu_torch img2hdf5")
    p.add_argument("--root", required=True, help="OPV2V split root dir")
    p.add_argument("--rm-png", action="store_true",
                   help="delete source PNGs after packing")
    args = p.parse_args(argv)
    total = convert_tree(args.root, args.rm_png)
    print(f"[img2hdf5] wrote {total} hdf5 files under {args.root}")


if __name__ == "__main__":
    main()
