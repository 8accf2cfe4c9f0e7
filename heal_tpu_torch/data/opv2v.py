"""OPV2V / OPV2V-H / V2XSet folder-layout backend (host side, numpy).

The port's copy of heal_tpu/data/opv2v.py: it scans
``root/scenario/cav_id/timestamp.{yaml,pcd}`` trees, parses each frame's
metadata (lidar pose, vehicle boxes, camera calibration) and applies the
heterogeneous ``Adaptor``: a fixed modality a (scenario, cav) from the
assignment JSON (the shipped ones under heal_tpu/configs/modality_assign,
read by path), else a random draw; the eval ``mapping_dict``; ego-first
order; the 16/32-line lidar file swap. Camera agents read their images
from disk (``{ts}_imgs.hdf5`` first, then ``{ts}_camera{i}.png``) with
their calibration (``utils/camera.get_ext_int``); ``label_type: camera``
reads each agent's ``{ts}_bev_visibility.png``.

Yields scenes in the assembler contract: agents [{pose, modality, points,
(cameras_raw, bev_visibility)}] and the world-frame objects. Point clouds
come from the native host loader (native/); ``_load_pcd_numpy`` is its
plain version. ``write_synthetic_opv2v_tree`` writes a small tree, the
same files as the JAX package's writer with the default arguments.
"""
from __future__ import annotations

import json
import os

import numpy as np
import yaml

from .. import native
from ..utils import camera as cam_utils
from ..utils import transform_np
from ..utils.common_np import limit_period

# heal_tpu's shipped configs: the modality-assignment JSONs live there
_CONFIGS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "heal_tpu", "configs")


def load_pcd(path: str) -> np.ndarray:
    """PCD file (ascii or binary, any float size, intensity optional) ->
    (N, 4) f32 [x y z intensity], by the native reader."""
    return native.read_pcd(path)


def _load_pcd_numpy(path: str) -> np.ndarray:
    """The plain numpy version of :func:`load_pcd` (float fields)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="ignore").strip()
            if line.startswith("#") or not line:
                continue
            key, _, value = line.partition(" ")
            header[key] = value
            if key == "DATA":
                break
        fields = header.get("FIELDS", "x y z intensity").split()
        sizes = [int(s) for s in header.get("SIZE", "4 4 4 4").split()]
        count = int(header.get("POINTS", 0))
        if header["DATA"] == "ascii":
            data = np.loadtxt(f, dtype=np.float32, max_rows=count)
            data = np.atleast_2d(data)
        else:
            dtype = np.dtype({"names": fields,
                              "formats": [f"<f{s}" for s in sizes]})
            raw = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
            data = np.stack(
                [raw[name].astype(np.float32) for name in fields], axis=1)
    cols = {name: i for i, name in enumerate(fields)}
    xyz = data[:, [cols["x"], cols["y"], cols["z"]]]
    inten = (data[:, cols["intensity"]][:, None] if "intensity" in cols
             else np.ones((len(data), 1), np.float32))
    return np.concatenate([xyz, inten], axis=1).astype(np.float32)


def _load_frame_yaml(path: str) -> dict:
    # yaml.safe_load, not the config loader: its float resolver reads
    # some scalars differently
    with open(path, "r") as f:
        return yaml.safe_load(f)


def objects_from_yaml(frame: dict) -> np.ndarray:
    """vehicles dict -> (K, 7) f64 world lwh boxes.

    OPV2V convention: box center = location + center offset, dims =
    2 * extent (half-extents x = l/2, y = w/2, z = h/2), yaw = angle[1]
    degrees.
    """
    vehicles = frame.get("vehicles", {}) or {}
    out = []
    for _vid, v in vehicles.items():
        loc = np.asarray(v["location"], dtype=np.float64)
        center = np.asarray(v.get("center", [0, 0, 0]), dtype=np.float64)
        ext = np.asarray(v["extent"], dtype=np.float64)
        yaw = np.radians(v["angle"][1])
        out.append([*(loc + center), 2 * ext[0], 2 * ext[1], 2 * ext[2],
                    limit_period(yaw)])
    return np.asarray(out, dtype=np.float64).reshape(-1, 7)


class Adaptor:
    """HEAL's heterogeneous agent types (heal_tpu/data/opv2v.py): a fixed
    modality a (scenario, cav) from the assignment JSON, the eval
    ``mapping_dict`` remap, ego-first order so that slot 0 holds an
    ego-capable modality."""

    def __init__(self, heter_cfg: dict | None, train: bool):
        self.enabled = heter_cfg is not None
        if not self.enabled:
            return
        self.ego_modality = heter_cfg.get("ego_modality", "m1")
        self.mapping = heter_cfg.get("mapping_dict", {})
        self.modalities = sorted(heter_cfg["modality_setting"].keys())
        self.train = train
        path = heter_cfg.get("assignment_path")
        self.assignment = {}
        if path and not os.path.exists(path):
            # the shipped maps: "modality_assign/x.json" against the
            # JAX package's configs dir
            shipped = os.path.join(_CONFIGS, path)
            if os.path.exists(shipped):
                path = shipped
        if path and os.path.exists(path):
            with open(path) as f:
                self.assignment = json.load(f)

    def modality_of(self, scenario: str, cav_id: str, rng) -> str:
        if not self.enabled:
            return "m1"
        m = self.assignment.get(scenario, {}).get(str(cav_id))
        if m is None:
            m = self.modalities[rng.integers(0, len(self.modalities))]
        return self.mapping.get(m, m)

    def reorder_ego_first(self, cav_ids: list, modalities: dict) -> list:
        """Put the ego-capable agents first, each group in its order."""
        if not self.enabled:
            return cav_ids
        ego_ok = [c for c in cav_ids if modalities[c] in self.ego_modality]
        rest = [c for c in cav_ids if modalities[c] not in self.ego_modality]
        return ego_ok + rest


def _cav_dirs(sdir: str) -> list:
    """A scenario's agent folders, sorted, ``_``-prefixed ones skipped."""
    return sorted(d for d in os.listdir(sdir)
                  if os.path.isdir(os.path.join(sdir, d))
                  and not d.startswith("_"))


def generate_modality_assignment(
    root: str,
    modalities=("m1", "m2", "m3", "m4"),
    seed: int = 303,
    in_order: bool = False,
    output_path: str | None = None,
) -> dict:
    """A fixed modality a (scenario, cav) of an OPV2V-layout tree, for
    reproducible heterogeneous evaluation: a draw per agent from
    ``default_rng(seed)``, or with ``in_order`` agent k gets
    ``modalities[k % len]`` (the agents-added-in-order protocol). Writes
    the JSON to ``output_path`` when given."""
    rng = np.random.default_rng(seed)
    assignment = {}
    for scen in sorted(os.listdir(root)):
        sdir = os.path.join(root, scen)
        if not os.path.isdir(sdir):
            continue
        assignment[scen] = {}
        for k, cav in enumerate(_cav_dirs(sdir)):
            if in_order:
                m = modalities[k % len(modalities)]
            else:
                m = modalities[rng.integers(0, len(modalities))]
            assignment[scen][str(cav)] = m
    if output_path:
        with open(output_path, "w") as f:
            json.dump(assignment, f, indent=1)
    return assignment


class OPV2VBackend:
    """Scenes of an OPV2V-layout split: ``root_dir`` in training,
    ``test_dir`` otherwise; V2XSet has the same layout."""

    def __init__(self, params: dict, train: bool = True):
        self.params = params
        self.train = train
        self.root = params["root_dir" if train else "test_dir"]
        self.heter = params.get("heter")
        self.adaptor = Adaptor(self.heter, train)
        self.lidar_channels = (self.heter or {}).get("lidar_channels_dict",
                                                     {})
        self.sensor_types = {
            m: s.get("sensor_type", "lidar")
            for m, s in (self.heter or {}).get("modality_setting",
                                               {}).items()}
        self.reinitialize()

    def reinitialize(self, seed: int = 0):
        """(Re)scan the scenario folders and draw the modalities the
        assignment leaves open: per scenario, then per cav, from one
        ``default_rng(seed)``."""
        rng = np.random.default_rng(seed)
        self.frames = []  # (scenario, [cav ids], {cav: modality}, ts)
        scenarios = sorted(d for d in os.listdir(self.root)
                           if os.path.isdir(os.path.join(self.root, d)))
        for scen in scenarios:
            sdir = os.path.join(self.root, scen)
            cavs = _cav_dirs(sdir)
            if not cavs:
                continue
            modalities = {c: self.adaptor.modality_of(scen, c, rng)
                          for c in cavs}
            cavs = self.adaptor.reorder_ego_first(cavs, modalities)
            # the ego's frame files, camera yamls skipped
            timestamps = sorted(
                f[:-5] for f in os.listdir(os.path.join(sdir, cavs[0]))
                if f.endswith(".yaml") and "camera" not in f)
            for ts in timestamps:
                self.frames.append((scen, cavs, modalities, ts))

    def __len__(self):
        return len(self.frames)

    def scene(self, idx: int) -> dict:
        scen, cavs, modalities, ts = self.frames[idx]
        agents = []
        objects_all = {}
        for cav in cavs:
            cdir = os.path.join(self.root, scen, cav)
            frame = _load_frame_yaml(os.path.join(cdir, f"{ts}.yaml"))
            modality = modalities[cav]
            # the 16/32-line lidar's own file, where there is one
            channels = self.lidar_channels.get(modality, 64)
            pcd_name = (f"{ts}.pcd" if channels >= 64
                        else f"{ts}_{channels}.pcd")
            pcd_path = os.path.join(cdir, pcd_name)
            if not os.path.exists(pcd_path):
                pcd_path = os.path.join(cdir, f"{ts}.pcd")
            agent = {"pose": list(frame["lidar_pose"]), "modality": modality,
                     "points": load_pcd(pcd_path)}
            # the camera-visible GT raster (label_type 'camera')
            vis_path = os.path.join(cdir, f"{ts}_bev_visibility.png")
            if (self.params.get("label_type") == "camera"
                    and os.path.exists(vis_path)):
                from PIL import Image

                agent["bev_visibility"] = np.asarray(
                    Image.open(vis_path).convert("L"))
            if "camera0" in frame:
                agent["camera_meta"] = {k: frame[k] for k in frame
                                        if k.startswith("camera")}
                agent["camera_dir"] = cdir
                agent["timestamp"] = ts
                # camera agents get their pixels and calibration from disk
                if self.sensor_types.get(modality) == "camera":
                    cams = self._load_cameras(cdir, ts, frame)
                    if cams is not None:
                        agent["cameras_raw"] = cams
            agents.append(agent)
            # the union of the agents' vehicle boxes (world frame)
            for vid, v in (frame.get("vehicles", {}) or {}).items():
                objects_all[vid] = v
        objects = objects_from_yaml({"vehicles": objects_all})
        return {"agents": agents, "objects": objects}

    def _load_cameras(self, cdir: str, ts: str, frame: dict):
        """One agent's camera rig: the images (the hdf5 file first, then
        the PNGs) and the optical-frame camera -> lidar calibration of the
        frame yaml. None when no image file exists."""
        cam_ids = sorted(int(k[len("camera"):]) for k in frame
                         if k.startswith("camera")
                         and k[len("camera"):].isdigit())
        imgs = None
        h5_path = os.path.join(cdir, f"{ts}_imgs.hdf5")
        if os.path.exists(h5_path):
            import h5py

            with h5py.File(h5_path, "r") as f:
                imgs = [np.asarray(f[f"camera{i}"]) for i in cam_ids]
        else:
            paths = [os.path.join(cdir, f"{ts}_camera{i}.png")
                     for i in cam_ids]
            if all(os.path.exists(p) for p in paths):
                imgs = cam_utils.load_camera_images(paths)
        if imgs is None:
            return None
        rots, trans, intrins = [], [], []
        for i in cam_ids:
            cam_to_lidar, K = cam_utils.get_ext_int(frame, i)
            rots.append(cam_to_lidar[:3, :3])
            trans.append(cam_to_lidar[:3, 3])
            intrins.append(K)
        return {
            "imgs": imgs,  # list of (H, W, 3) uint8, original size
            "rots": np.stack(rots).astype(np.float32),
            "trans": np.stack(trans).astype(np.float32),
            "intrins": np.stack(intrins).astype(np.float32),
        }


def _render_synthetic_camera(pts_agent, cam_to_lidar, intrinsic, ih, iw):
    """Splat agent-frame lidar points into a camera image (uint8 RGB):
    brightness falls with depth, green follows height, blue marks a hit,
    so that the pixels agree with the calibration."""
    rot = cam_to_lidar[:3, :3]
    trans = cam_to_lidar[:3, 3]
    cam_pts = (pts_agent[:, :3] - trans) @ rot  # agent -> optical frame
    z = cam_pts[:, 2]
    keep = z > 0.5
    cam_pts, z = cam_pts[keep], z[keep]
    uv = cam_pts @ intrinsic.T
    u = (uv[:, 0] / uv[:, 2]).astype(np.int64)
    v = (uv[:, 1] / uv[:, 2]).astype(np.int64)
    ok = (u >= 0) & (u < iw) & (v >= 0) & (v < ih)
    img = np.full((ih, iw, 3), 30, np.uint8)
    img[:, :, 2] += (np.linspace(0, 40, ih, dtype=np.uint8))[:, None]
    bright = np.clip(255.0 / np.maximum(z[ok], 1.0), 0, 255)
    height = np.clip((cam_pts[ok, 1] + 3.0) * 40, 0, 255)
    img[v[ok], u[ok], 0] = bright.astype(np.uint8)
    img[v[ok], u[ok], 1] = height.astype(np.uint8)
    img[v[ok], u[ok], 2] = 255
    return img


def write_synthetic_opv2v_tree(
    root: str,
    num_scenarios: int = 1,
    num_cavs: int = 2,
    num_timestamps: int = 2,
    num_vehicles: int = 5,
    seed: int = 0,
    cameras: bool = False,
    img_hw=(150, 200),
    num_cameras: int = 4,
    ground_points: int = 500,
    points_per_box: int = 400,
):
    """Write a small OPV2V-layout tree: a yaml and an ascii pcd a frame,
    with ``cameras`` also the calibration blocks and a PNG a camera.
    ``ground_points`` / ``points_per_box`` set the lidar's density
    (``synthetic.simulate_lidar``); with the defaults the files are the
    JAX package's writer's, byte for byte."""
    from PIL import Image

    from .synthetic import simulate_lidar

    rng = np.random.default_rng(seed)
    for s in range(num_scenarios):
        scen = os.path.join(root, f"2021_synth_{s:02d}")
        vehicles = {}
        for k in range(num_vehicles):
            vehicles[1000 + k] = {
                "location": [float(rng.uniform(-40, 40)),
                             float(rng.uniform(-20, 20)), 0.0],
                "center": [0.0, 0.0, 0.75],
                "extent": [2.2, 0.9, 0.75],
                "angle": [0.0, float(rng.uniform(-180, 180)), 0.0],
            }
        world_objs = objects_from_yaml({"vehicles": vehicles})
        for c in range(num_cavs):
            cav_dir = os.path.join(scen, str(200 + c))
            os.makedirs(cav_dir, exist_ok=True)
            pose = [float(rng.uniform(-15, 15)) if c else 0.0,
                    float(rng.uniform(-8, 8)) if c else 0.0,
                    1.9, 0.0,
                    float(rng.uniform(-90, 90)) if c else 0.0,
                    0.0]
            for t in range(num_timestamps):
                ts = f"{t:06d}"
                frame = {"lidar_pose": pose, "true_ego_pos": pose,
                         "vehicles": vehicles}
                pts = simulate_lidar(world_objs, pose, rng,
                                     points_per_box=points_per_box,
                                     ground_points=ground_points)
                if cameras:
                    ih, iw = img_hw
                    K = cam_utils.default_intrinsics(ih, iw)
                    for ci in range(num_cameras):
                        # the rig: at the agent pose, 0.5 m up, yawed
                        # 0/90/180/270 deg (world-frame cords as OPV2V's)
                        cam_cords = [pose[0], pose[1], pose[2] + 0.5, 0.0,
                                     pose[4] + 90.0 * ci, 0.0]
                        frame[f"camera{ci}"] = {
                            "cords": cam_cords,
                            "intrinsic": K.tolist(),
                            "extrinsic": np.linalg.inv(
                                transform_np.x1_to_x2(cam_cords, pose)
                            ).tolist(),
                        }
                        cam_to_lidar, _ = cam_utils.get_ext_int(frame, ci)
                        img = _render_synthetic_camera(pts, cam_to_lidar, K,
                                                       ih, iw)
                        Image.fromarray(img).save(
                            os.path.join(cav_dir, f"{ts}_camera{ci}.png"))
                with open(os.path.join(cav_dir, f"{ts}.yaml"), "w") as f:
                    yaml.safe_dump(frame, f)
                with open(os.path.join(cav_dir, f"{ts}.pcd"), "w") as f:
                    f.write(
                        "VERSION .7\nFIELDS x y z intensity\n"
                        "SIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n"
                        f"WIDTH {len(pts)}\nHEIGHT 1\n"
                        "VIEWPOINT 0 0 0 1 0 0 0\n"
                        f"POINTS {len(pts)}\nDATA ascii\n")
                    np.savetxt(f, pts, fmt="%.4f")
