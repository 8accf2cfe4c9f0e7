"""The controls of ``correct``: the plain reference put in the program's
place, computed one precision below the configuration's (TF32 for f32
with TF32 off), and the cell's run must come out not correct.

    python -m benchmark.tests.controls --workload flagship.serve \\
        --seeds 11,12,13 --seconds 5

prints, for each seed, the numbers the sound program reads and those
the control reads, each beside its limit (a chip is needed: TF32 exists
only there). The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import harness, weights as wlib
from benchmark.reference import assemble, decode, labels


class ReferenceProgram:
    """The reference in the program's place, under TF32."""

    def __init__(self, hypes, ref_shapes, seed, device):
        self.hypes, self.device = hypes, torch.device(device)
        self.ref = harness.reference(self.config)
        self.model = self.ref.build(hypes).to(self.device).eval()
        self.model.load_state_dict(wlib.make(ref_shapes, seed, self.device))
        self.anchors = torch.from_numpy(labels.anchor_grid(hypes).astype(
            np.float32)).to(self.device)

    def assemble(self, scene):
        return assemble.collate([assemble.assemble(self.hypes, scene, False)])

    def serve(self, batch, spans=None):
        with tf32(), torch.no_grad():
            out = self.model(assemble.to_device(batch, self.device))
            dec = decode.decode_all(out["cls_preds"][0], out["reg_preds"][0],
                                    out["dir_preds"][0], self.anchors,
                                    self.hypes)
            kept = decode.nms(dec, self.hypes)
        heads = {k: out[k] for k in ("cls_preds", "reg_preds", "dir_preds")}
        return heads, {"corners": dec["corners"][kept].cpu().numpy(),
                       "scores": dec["scores"][kept].cpu().numpy()}


class ReferenceTrainer:
    """The reference's train step in the program's place, under TF32."""

    def __init__(self, hypes, ref_shapes, seed, device):
        from benchmark.reference import loss

        self.hypes, self.device, self.loss = hypes, torch.device(device), loss
        self.model = harness.reference(self.config).build(hypes).to(
            self.device)
        self.model.load_state_dict(wlib.make(ref_shapes, seed, self.device))
        self.opt = loss.adam(self.model, hypes)

    def assemble(self, scenes):
        return assemble.to_device(assemble.collate(
            [assemble.assemble(self.hypes, s, True) for s in scenes]),
            self.device)

    def step(self, batch):
        with tf32():
            return self.loss.step(self.model, self.opt, batch, self.hypes)

    def first_moment(self):
        return {n: self.opt.state[p]["exp_avg"].detach().clone()
                for n, p in self.model.named_parameters()}

    def beta1(self):
        return self.opt.param_groups[0]["betas"][0]


class tf32:
    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.old


CONTROLS = {"serve": ReferenceProgram, "train": ReferenceTrainer}


def half_batch():
    """A training fault planted in the program: each step on the first
    half of its batch, the mean taken over that half."""
    from heal_tpu_torch.parallel.trainer import Trainer

    real = Trainer.train_step

    def half(tree):
        if isinstance(tree, dict):
            return {k: half(v) for k, v in tree.items()}
        return tree[: max(1, tree.shape[0] // 2)]

    Trainer.train_step = lambda self, batch: real(self, half(batch))
    return lambda: setattr(Trainer, "train_step", real)


def frozen_state():
    """A training fault planted in the program: each step computes its
    gradients and leaves the parameters and the optimizer unchanged."""
    from heal_tpu_torch.parallel.trainer import Trainer

    real = Trainer.train_step

    def frozen(self, batch):
        aux = self.gradients(batch)
        self.step += 1
        return aux

    Trainer.train_step = frozen
    return lambda: setattr(Trainer, "train_step", real)


FAULTS = {"half_batch": half_batch, "frozen_state": frozen_state}


def readings(c: dict, seed: int, seconds: float, device, control: bool):
    """The numbers one run of cell ``c`` compares: of the program, or of
    the control in its place."""
    runner = harness.mode(c["traffic_file"]["mode"])
    ref = harness.reference(c["config"])
    args = argparse.Namespace(workload=c["name"], seed=seed,
                              seconds=seconds, trace=0)
    kw = {}
    if control:
        cls = type("Control", (CONTROLS[c["traffic_file"]["mode"]],),
                   {"config": c["config"]})
        kw["program_cls"] = cls
    res = runner.run(c, args, device, time.perf_counter(), ref, **kw)
    return harness.verdict(res["numbers"], harness.limits(c)) + (
        res["numbers"],)


def main(argv=None):
    p = argparse.ArgumentParser("controls")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--which", choices=("both", "program", "control",
                                       *FAULTS),
                   default="both",
                   help="program or control: its readings alone; a "
                        "fault's name: the program with it planted")
    a = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = harness.cell(a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        # the program (sound, or with a fault planted), the control, or both
        for control in {"both": (False, True), "control": (True,)}.get(
                a.which, (False,)):
            undo = FAULTS[a.which]() if a.which in FAULTS else None
            try:
                ok, _, numbers = readings(c, seed, a.seconds, "cuda", control)
            finally:
                if undo:
                    undo()
            print(json.dumps({"seed": seed, "control": control,
                              "fault": a.which if a.which in FAULTS else None,
                              "correct": ok, "numbers": numbers}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
