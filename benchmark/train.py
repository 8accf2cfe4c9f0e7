"""Train mode: the port's trainer (``tools/train.build_trainer``,
``Trainer.train_step``) at the configuration's batch size on the
traffic's distinct batches, assembled by the program's host side and
copied to the card in set-up, then cycled.

Set-up builds the one trainer, loads the seeded weights and runs its
first ``checked_steps`` steps through ``train_step`` on distinct
batches (they warm every shape up as well), recording each step's loss,
the head outputs of the first step's forward, the first gradient as Adam holds it after one step and the parameters
before the first step and after the last. The window then runs the
same trainer on, and every step is timed into the window, synchronised
at its end. After the window the reference runs the same first steps
from the same weights on batches it assembles itself, and ``check.py``
compares them.

numpy's global random state is seeded from ``--seed`` before the
program assembles the batches, and again before the reference does:
both draw the random subset of a sweep above ``max_points`` from it,
in the same order.
"""
from __future__ import annotations

import copy
import time

import numpy as np
import torch

from . import check, trace
from . import weights as wlib
from .traffic import scenes as gen


def numpy_seed(seed: int) -> int:
    return int(seed) % (1 << 32)


class Program:
    """The port's trainer for one configuration on one device."""

    def __init__(self, hypes: dict, ref_shapes: dict, seed: int, device):
        from heal_tpu_torch.config import reparse
        from heal_tpu_torch.data import assembler_class
        from heal_tpu_torch.tools.train import build_trainer

        self.hypes = reparse(copy.deepcopy(hypes))
        self.device = torch.device(device)
        # the labels by the program's numpy IoU: its native f32 IoU breaks
        # ties of the forced best anchor of a box otherwise (a few labels
        # a sample; ROADMAP §3, fault 4). Labels are set-up, not timed
        self.assembler = assembler_class(self.hypes)(self.hypes, train=True,
                                                     native_iou=False)
        # a long epoch: the learning rate stays at its first value
        self.trainer = build_trainer(self.hypes, self.device, 10 ** 6)
        self.trainer.model.load_state_dict(
            wlib.make(ref_shapes, seed, self.device), strict=True)
        self.model = self.trainer.model

    def assemble(self, scenes: list) -> dict:
        from heal_tpu_torch.data.scene import collate
        from heal_tpu_torch.parallel import to_device

        return to_device(collate([self.assembler.assemble(s)
                                  for s in scenes]), self.device)

    def step(self, batch: dict) -> torch.Tensor:
        with torch.profiler.record_function("train_step"):
            return self.trainer.train_step(batch)["total_loss"]

    def first_moment(self) -> dict:
        """Adam's first moment of each parameter, by name; zero where
        the optimizer holds none (it never took a step)."""
        opt = self.trainer.optimizer
        return {n: (opt.state[p]["exp_avg"].detach().clone()
                    if "exp_avg" in opt.state.get(p, {})
                    else torch.zeros_like(p))
                for n, p in self.model.named_parameters()}

    def beta1(self) -> float:
        return self.trainer.optimizer.param_groups[0]["betas"][0]


def params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(c: dict, args, device, t_start: float, ref,
        program_cls=Program) -> dict:
    """One run of the cell ``c`` on ``device``; ``program_cls`` stands in
    for the program in the tests' controls and faults."""
    hypes = c["config_file"]["hypes"]
    traffic = c["traffic_file"]
    bs = hypes["train_params"]["batch_size"]
    nb = traffic["batches"]
    program = program_cls(hypes, wlib.shapes_of(ref.build(hypes)),
                          args.seed, device)
    scenes = gen.scenes(hypes, traffic, args.seed, nb * bs)
    np.random.seed(numpy_seed(args.seed))
    batches = [program.assemble(scenes[i * bs:(i + 1) * bs])
               for i in range(nb)]
    first = params(program.model)
    losses, moment, heads = [], None, {}
    hook = check.keep_first_heads(program.model, heads)
    for k in range(traffic["checked_steps"]):
        losses.append(program.step(batches[k % nb]))
        if k == 0:
            moment = program.first_moment()
    hook.remove()
    changed = {n: p - first[n] for n, p in params(program.model).items()}
    record = {"losses": [float(x) for x in losses], "heads": heads,
              "grad": {n: m / (1 - program.beta1())
                       for n, m in moment.items()},
              "change": changed}
    del first
    sync(device)
    setup_s = time.perf_counter() - t_start

    steps = 0
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    while True:
        program.step(batches[(traffic["checked_steps"] + steps) % nb])
        steps += 1
        if time.perf_counter() >= deadline:
            break
    sync(device)
    window_s = time.perf_counter() - t0

    ctx = {"frames": steps, "window_s": window_s}
    if args.trace:
        ctx.update(traced(program, batches, traffic))
    peak = (int(torch.cuda.max_memory_allocated(device))
            if torch.device(device).type == "cuda" else 0)
    ctx["memory_peak_bytes"] = peak
    del program, batches
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.train(ref, hypes, scenes, record, traffic, args.seed,
                          device)
    if args.trace:
        ctx["flops_per_item"] = check.train_flops(ref, hypes, scenes[:bs],
                                                  args.seed, device)
    return {"end_to_end": {"setup_s": setup_s,
                           "train_samples_per_s": steps * bs / window_s},
            "ctx": ctx, "numbers": numbers, "attempted": steps,
            "memory_peak_bytes": peak}


def traced(program, batches, traffic) -> dict:
    """A profiled stretch of ``traced_steps`` steps after the window,
    with kernel 2's calls recorded (``trace.stretch``)."""
    import heal_tpu_torch.ops.shift_rows as sr

    calls = {"rows": trace.Calls(sr, "shift_rows"),
             "cols": trace.Calls(sr, "shift_cols")}
    count = traffic["traced_steps"]
    red = trace.stretch(lambda i: program.step(batches[i % len(batches)]),
                        count, min(count, 2), calls.values())
    return {"trace": red,
            "shift_calls": {k: v.calls for k, v in calls.items()}}
