"""Dataset builder: (fusion assembler) x (scene backend).

The port's copy of heal_tpu/data/builder.py: the synthetic backend and
the disk backends (``fusion.dataset`` opv2v and v2xset: data/opv2v.py;
dairv2x; v2xsim), and the intermediate, late and early assemblers
(data/late_early.py). A backend yields scenes (agents, poses, sensors,
world objects); the assembler turns them into fixed-shape samples. A
disk backend reads the config's own directories (``root_dir`` for
training; ``test_dir``, or ``validate_dir`` for DAIR-V2X, whose
``data_dir`` is the dataset's root). With ``box_align.precalc_path`` (a
tools/pose_graph_pre_calc.py dump), each scene's agents carry their
stage-1 detections (``pred_centers``, ``pred_uncertainty``), which the
assembler's CoAlign branch refines the noisy poses with. Two-stage
fusion (``intermediate2stage``, FPV-RCNN) is the intermediate assembler
with ``model.args.supervise_single`` forced on: its first stage trains
on the per-agent labels. ``native_iou=False`` labels the anchors with
numpy's IoU instead of the native library's (postprocess/targets.py).
"""
from __future__ import annotations

import json
import os
import warnings

import numpy as np

from ..utils.box_align import uncertainty_to_weights
from .dairv2x import DAIRV2XBackend
from .late_early import EarlyAssembler, LateAssembler
from .opv2v import OPV2VBackend
from .scene import IntermediateAssembler, collate
from .synthetic import SyntheticDataset
from .v2xsim import V2XSimBackend

_ASSEMBLERS = {
    "intermediate": IntermediateAssembler,
    "intermediate2stage": IntermediateAssembler,
    "intermediateheter": IntermediateAssembler,
    "intermediateheterinfer": IntermediateAssembler,
    "late": LateAssembler,
    "lateheter": LateAssembler,
    "early": EarlyAssembler,
}


def assembler_class(params: dict) -> type:
    """The assembler class of ``params``' fusion method; its ``late`` and
    ``single_labels`` attributes tell serving and training how to use its
    samples."""
    method = params["fusion"]["core_method"]
    if method in _ASSEMBLERS:
        return _ASSEMBLERS[method]
    raise KeyError(f"unknown fusion core_method {method!r}")


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
    if name in ("opv2v", "v2xset"):
        return OPV2VBackend(params, train=train)
    if name == "dairv2x":
        return DAIRV2XBackend(params, train=train)
    if name == "v2xsim":
        return V2XSimBackend(params, train=train)
    raise KeyError(f"unknown dataset backend {name!r}")


class FusionDataset:
    """Iterable over assembled samples + batch iterator."""

    def __init__(self, params: dict, train: bool = True,
                 native_iou: bool = True):
        self.params = params
        self.train = train
        self.backend = _build_backend(params, train)
        # a presorted=True encoder on unsorted points silently corrupts
        # its sorted scatter: refuse the mismatch. The heter models read
        # the flag from model.args.mX.encoder_args (heter_pyramid.py)
        margs = (params.get("model") or {}).get("args") or {}
        branches = [margs[m] for m in ("m1", "m2", "m3", "m4")
                    if isinstance(margs.get(m), dict)]
        wants_sorted = margs.get("presorted", False) or any(
            b.get("presorted", False)
            or (b.get("encoder_args") or {}).get("presorted", False)
            for b in branches
        )
        if wants_sorted and not params["preprocess"]["args"].get(
            "presort", True
        ):
            raise ValueError(
                "model.args presorted=true requires "
                "preprocess.args.presort=true (host point ordering)"
            )
        assembler_params = params
        if params["fusion"]["core_method"] == "intermediate2stage":
            # two-stage models train their first stage on the per-agent
            # labels: part of the dataset's contract, not an option (ref
            # intermediate_2stage_fusion_dataset.py:33)
            model = dict(params.get("model", {}))
            model["args"] = dict(model.get("args", {}), supervise_single=True)
            assembler_params = dict(params, model=model)
        self.assembler = assembler_class(params)(assembler_params, train,
                                                 native_iou=native_iou)
        self.modalities = self.assembler.modalities
        # CoAlign: the stage-1 detections of tools/pose_graph_pre_calc.py
        self._precalc = None
        ba = params.get("box_align")
        if ba and ba.get("precalc_path"):
            if os.path.exists(ba["precalc_path"]):
                with open(ba["precalc_path"]) as f:
                    self._precalc = json.load(f)
            else:
                warnings.warn(
                    f"box_align.precalc_path {ba['precalc_path']!r} does "
                    "not exist: pose refinement is DISABLED for this run"
                )

    def __len__(self):
        return len(self.backend)

    def __getitem__(self, idx: int) -> dict:
        scene = self.backend.scene(idx)
        entry = self._precalc.get(str(idx)) if self._precalc else None
        if entry:
            # one entry per scene agent, in scene order and unfiltered
            # (the pose_graph_pre_calc contract): zipped by position
            for agent, e in zip(scene["agents"], entry):
                agent["pred_centers"] = np.asarray(e["centers"])
                if "uncertainty" in e:
                    agent["pred_uncertainty"] = uncertainty_to_weights(
                        e["uncertainty"])
        return self.assembler.assemble(scene)

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


def build_dataset(params: dict, train: bool = True,
                  native_iou: bool = True) -> FusionDataset:
    return FusionDataset(params, train=train, native_iou=native_iou)
