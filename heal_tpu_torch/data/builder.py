"""Dataset builder: (fusion assembler) x (scene backend).

The port's copy of heal_tpu/data/builder.py with the synthetic backend
and the intermediate assemblers. A backend yields scenes (agents, poses,
sensors, world objects); the assembler turns them into fixed-shape
samples. The disk backends, late, early and two-stage fusion, and
CoAlign's stage-1 pre-calc raise NotImplementedError naming the ROADMAP item (queue 1) that
ports them.
"""
from __future__ import annotations

import numpy as np

from .scene import IntermediateAssembler, collate
from .synthetic import SyntheticDataset

# backend / fusion method -> the ROADMAP item (queue 1) that ports it
_NOT_PORTED = {
    "opv2v": "item 16 (disk dataset backends: data/opv2v.py)",
    "v2xset": "item 16 (disk dataset backends: data/opv2v.py)",
    "dairv2x": "item 16 (disk dataset backends: data/dairv2x.py)",
    "v2xsim": "item 16 (disk dataset backends: data/v2xsim.py)",
    "late": "item 9 (late fusion: data/late_early.py)",
    "lateheter": "item 9 (late fusion: data/late_early.py)",
    "early": "item 12 (early fusion: data/late_early.py)",
    "intermediate2stage": "item 9 (two-stage models)",
}


def _build_backend(params: dict, train: bool):
    name = params["fusion"].get("dataset", "synthetic")
    if name == "synthetic":
        args = params["fusion"].get("args") or {}
        args = args if isinstance(args, dict) else {}
        # eval_on_train: evaluate on the training scenes (the synthetic
        # test split uses disjoint seeds)
        as_train = train or args.get("eval_on_train", False)
        return SyntheticDataset(
            params,
            train=as_train,
            num_scenes=args.get(
                "num_scenes_train" if train else "num_scenes_test",
                32 if train else 8,
            ),
            num_agents=args.get("num_agents", 3),
            num_vehicles=args.get("num_vehicles", 10),
        )
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset backend {name!r} is not ported: ROADMAP queue 1, "
            f"{_NOT_PORTED[name]}"
        )
    raise KeyError(f"unknown dataset backend {name!r}")


class FusionDataset:
    """Iterable over assembled samples + batch iterator."""

    def __init__(self, params: dict, train: bool = True):
        self.params = params
        self.train = train
        self.backend = _build_backend(params, train)
        # a presorted=True encoder on unsorted points silently corrupts
        # its sorted scatter: refuse the mismatch
        margs = (params.get("model") or {}).get("args") or {}
        wants_sorted = margs.get("presorted", False) or any(
            isinstance(margs.get(m), dict)
            and margs[m].get("presorted", False)
            for m in ("m1", "m2", "m3", "m4")
        )
        if wants_sorted and not params["preprocess"]["args"].get(
            "presort", True
        ):
            raise ValueError(
                "model.args presorted=true requires "
                "preprocess.args.presort=true (host point ordering)"
            )
        method = params["fusion"]["core_method"]
        if method in (
            "intermediate",
            "intermediateheter",
            "intermediateheterinfer",
        ):
            self.assembler = IntermediateAssembler(params, train)
        elif method in _NOT_PORTED:
            raise NotImplementedError(
                f"fusion {method!r} is not ported: ROADMAP queue 1, "
                f"{_NOT_PORTED[method]}"
            )
        else:
            raise KeyError(f"unknown fusion core_method {method!r}")
        self.modalities = self.assembler.modalities
        ba = params.get("box_align")
        if ba and ba.get("precalc_path"):
            raise NotImplementedError(
                "box_align.precalc_path (CoAlign stage-1 detections) is not "
                "ported: ROADMAP queue 1, item 9 (pose_graph_pre_calc)"
            )

    def __len__(self):
        return len(self.backend)

    def __getitem__(self, idx: int) -> dict:
        return self.assembler.assemble(self.backend.scene(idx))

    @property
    def anchors(self):
        return self.assembler.anchors

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0):
        """Yield collated fixed-shape numpy batches (drops the remainder,
        so every batch has one shape)."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idxs = order[start : start + batch_size]
            yield collate([self[i] for i in idxs])


def build_dataset(params: dict, train: bool = True) -> FusionDataset:
    return FusionDataset(params, train=train)
